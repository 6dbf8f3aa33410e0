"""The packed real forwards against the shipped routes, on the card.

Counterpart of ``scripts/ablate_rfft_packed.py``, whose two sections it
keeps, and a third for the packed real forward's gate:

1. ``fwd``: the one-product direct rfft (``fused_torch.rfft_direct_packed``
   on ``plan.get_rfft_direct_packed_plan``) against ``rfft_device`` with
   its bins packed the same way, [Re X | Im X[1..h-1)], at the estimator
   shapes (253, 256), (511, 256), (64, 512);
2. ``psd``: ``fused_torch.rfft_packed_psd`` against ``rfft_device`` and
   re^2 + im^2, both padded back to (B, n);
3. ``gate``: ``fft_device`` with ``plan.RFFT_PACK_MIN`` patched to 8 (open:
   the real forward as ONE n/2-point complex transform,
   ``kernels/large.py:_real_packed_fft``) against the closed row, at
   B = 1 and 3, n = 4,096 … 2^22 (quick: B = 1 at 32,768 and 2^21).

Each step maps (B, n) to (B, n) (``utils/profiling.chained_step_stats``:
CUDA graphs, two lengths differenced); each pair is timed twice in turns
and the minimum kept.  ``parity`` is max|packed - shipped| / max|shipped|.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_rfft_packed [--quick]
Writes ``chiprun_out/ablate_rfft_packed_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from unittest import mock

import numpy as np
import torch

DIRECT_SHAPES = ((253, 256), (511, 256), (64, 512))
GATE_SHAPES = tuple((b, n) for b in (1, 3) for n in (4096, 16384, 32768, 65536, 1 << 17, 1 << 21, 1 << 22))
QUICK_GATE_SHAPES = ((1, 32768), (1, 1 << 21))


def parity_failures(results: dict) -> dict:
    """Rows whose parity is above 5 * log2(n) * eps (or not a number)."""
    eps = float(np.finfo(np.float32).eps)
    return {f"{r['what']}_b{r['b']}_n{r['n']}": r.get("parity") for r in results["rows"]
            if not r.get("parity", float("nan")) <= 5 * np.log2(r["n"]) * eps}


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from .. import plan
    from ..config import apply_precision
    from ..kernels.fused_torch import rfft_direct_packed, rfft_packed_psd
    from ..ops.transform import fft_device, rfft_device
    from ..plan import get_rfft_direct_packed_plan, on_device
    from ..utils import profiling

    apply_precision()
    dev = torch.device(device)
    rng = np.random.default_rng(7)
    timing = dict(k1=5, k2=55, reps=2, min_span_s=0.005) if quick else dict(k1=30, k2=530, reps=3)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick, "rows": []}
    out = Path(out_dir) / "ablate_rfft_packed_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)

    def t(step, x0):
        return profiling.chained_step_stats(step, x0, **timing).median_s

    def row(what, b, n, shipped, packed, x0, labels=("shipped", "packed")):
        a, p = shipped(x0), packed(x0)
        par = float((a - p).abs().max()) / max(float(a.abs().max()), 1e-9)
        first = (t(shipped, x0), t(packed, x0))
        second = (t(packed, x0), t(shipped, x0))[::-1]
        ts, tp = min(first[0], second[0]), min(first[1], second[1])
        r = {"what": what, "b": b, "n": n, f"{labels[0]}_us": ts * 1e6, f"{labels[1]}_us": tp * 1e6,
             "speedup": ts / tp, "parity": par}
        results["rows"].append(r)
        out.write_text(json.dumps(results, indent=1))
        print(f"{what} b={b} n={n}: {labels[0]} {ts * 1e6:8.2f} {labels[1]} {tp * 1e6:8.2f} us -> "
              f"{ts / tp:.2f}x par={par:.1e}", flush=True)

    for b, n in DIRECT_SHAPES[:1] if quick else DIRECT_SHAPES:
        p = on_device(get_rfft_direct_packed_plan, n, None, device=dev)
        x0 = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
        sc = float(np.float32(1.0 / n))

        def fwd_shipped(f):
            fr, fi = rfft_device(f)
            return torch.cat([fr, fi[:, 1:-1]], dim=1) * sc

        def fwd_packed(f, p=p):
            return rfft_direct_packed(f, p)[0] * sc

        def psd_shipped(f, n=n):
            fr, fi = rfft_device(f)
            ps = fr * fr + fi * fi
            return torch.nn.functional.pad(ps, (0, n - ps.shape[1])) * sc

        def psd_packed(f, p=p, n=n):
            ps = rfft_packed_psd(f, p)
            return torch.nn.functional.pad(ps, (0, n - ps.shape[1])) * sc

        row("fwd", b, n, fwd_shipped, fwd_packed, x0)
        row("psd", b, n, psd_shipped, psd_packed, x0)

    for b, n in QUICK_GATE_SHAPES if quick else GATE_SHAPES:
        x0 = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
        sc = float(np.float32(1.0 / np.sqrt(n)))

        def closed(f):
            return fft_device(f)[0] * sc

        def opened(f):
            with mock.patch.object(plan, "RFFT_PACK_MIN", 8):
                return fft_device(f)[0] * sc

        row("gate", b, n, closed, opened, x0, labels=("closed", "packed"))

    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer shapes and repetitions")
    main(quick=ap.parse_args().quick)
