"""The 2-D column pass in place over axis 0 against transpose, rows,
transpose back, on the card.

Counterpart of ``scripts/ablate_fft2_axis0.py``.  Two forms of the column
pass of an (H, W) image:

  (T) transpose, the batched row transform (``kernels/large.py:
      transform_any`` at n = H over W rows), transpose back;
  (A) ``kernels/fused_torch.py:transform_axis0``: the four-step's
      contractions with W a free trailing axis, the same tables, no
      transposes.

Two tables, as the JAX script has them: the isolated column leg, (T)
against (A) on real and complex input, H in {256, 1,024, 4,096, 16,384},
W in {128, 512, 2,048, 4,096}, H W <= 2^24; and ``fft2_device`` composed,
the axis-0 gate closed and opened (``plan.AXIS0_H_MIN`` patched to 2) at the nine JAX
cells.  Steps map (H, W) to (H, W) (``utils/profiling.chained_step_stats``);
``parity`` is max|A - T| / max|T|.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_fft2_axis0 [--quick]
Writes ``chiprun_out/ablate_fft2_axis0_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from unittest import mock

import numpy as np
import torch

LEG_H = (256, 1024, 4096, 16384)
LEG_W = (128, 512, 2048, 4096)
COMPOSED = ((2048, 512), (2048, 1024), (2048, 2048), (4096, 512), (4096, 1024), (4096, 2048), (4096, 4096),
            (8192, 512), (8192, 2048))
QUICK_LEG = ((4096, 512),)
QUICK_COMPOSED = ((4096, 4096),)


def parity_failures(results: dict) -> dict:
    """Rows whose parity is above 5 * log2(H * W) * eps (or not a number)."""
    eps = float(np.finfo(np.float32).eps)
    rows = results["isolated_leg"] + results["composed_fft2"]
    return {f"{r['h']}x{r['w']}{'c' if r.get('complex') else ''}": r.get("parity") for r in rows
            if not r.get("parity", float("nan")) <= 5 * np.log2(r["h"] * r["w"]) * eps}


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from .. import plan
    from ..config import apply_precision
    from ..kernels.fused_torch import transform_axis0
    from ..kernels.large import transform_any
    from ..ops.fft2d import fft2_device
    from ..utils import profiling

    apply_precision()
    dev = torch.device(device)
    timing = dict(k1=5, k2=55, reps=2, min_span_s=0.005) if quick else dict(k1=30, k2=530, reps=3)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick, "isolated_leg": [],
                     "composed_fft2": []}
    out = Path(out_dir) / "ablate_fft2_axis0_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)

    def t(step, x0):
        return profiling.chained_step_stats(step, x0, **timing).median_s * 1e6

    def pair(step_t, step_a, x0):
        """(T us, A us, parity): each timed twice in turns, the minimum kept."""
        a, b = step_t(x0), step_a(x0)
        par = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-9)
        t1, a1 = t(step_t, x0), t(step_a, x0)
        a2, t2 = t(step_a, x0), t(step_t, x0)
        return min(t1, t2), min(a1, a2), par

    rng = np.random.default_rng(0)
    legs = QUICK_LEG if quick else [(h, w) for h in LEG_H for w in LEG_W if h * w <= 1 << 24]
    for h, w in legs:
        for cx in (False, True):
            xr = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(dev)
            xi = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(dev) if cx else None
            xit = None if xi is None else xi.t().contiguous()

            def step_t(v, h=h, xit=xit):
                sr, si = transform_any(v.t().contiguous(), xit, h, -1)
                return sr.t() + si.t()

            def step_a(v, h=h, xi=xi):
                sr, si = transform_axis0(v, xi, h, -1)
                return sr + si

            tt, ta, par = pair(step_t, step_a, xr)
            r = {"h": h, "w": w, "complex": cx, "transpose_us": tt, "axis0_us": ta, "speedup": tt / ta,
                 "parity": par}
            results["isolated_leg"].append(r)
            out.write_text(json.dumps(results, indent=1))
            print(f"leg h={h:6d} w={w:5d} complex={int(cx)}  T {tt:9.2f}  A {ta:9.2f} us  x{tt / ta:.2f} "
                  f"par={par:.1e}", flush=True)
            del xr, xi, xit

    for h, w in QUICK_COMPOSED if quick else COMPOSED:
        img = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(dev)

        def closed(v):
            return fft2_device(v)[0]

        def opened(v):
            with mock.patch.object(plan, "AXIS0_H_MIN", 2):  # every composed cell has H > W/2
                return fft2_device(v)[0]

        t_off, t_on, par = pair(closed, opened, img)
        r = {"h": h, "w": w, "fft2_transpose_us": t_off, "fft2_axis0_us": t_on, "speedup": t_off / t_on,
             "parity": par}
        results["composed_fft2"].append(r)
        out.write_text(json.dumps(results, indent=1))
        print(f"composed {h}x{w}: T {t_off:9.1f}  A {t_on:9.1f} us  x{t_off / t_on:.2f} par={par:.1e}", flush=True)
        del img

    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="one cell each, fewer repetitions")
    main(quick=ap.parse_args().quick)
