"""The packed single-table whole kernel against the split-table form, and the
cost of a kernel's operands.

Counterpart of ``scripts/ablate_whole_packed.py``.  Two measurements:

1. the operand probe: S4 (``kernels/probes.operand_probe``), a kernel that
   adds the first rows of k (128, 128) table operands to an (8, 128) tile,
   for k in {0, 1, 2, 4, 8}: what each pointer operand adds to a launch;
2. W1 (K1, ``whole_transform``, eight operands), W2 (K2,
   ``whole_transform_packed``, one packed table) and the folded four-step
   (``fused_fft_folded`` on ``get_fused_plan(n, -1, wide=False)``, torch
   contractions), interleaved (W1 W2 folded, twice), B = 1, n = 1,024 ...
   16,384, real and complex input.  ``parity`` is max|W2 - W1| / max|W1|.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_whole_packed [--quick]
Writes ``chiprun_out/ablate_whole_packed_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..kernels.probes import PROBE_KS

SIZES = (1024, 2048, 4096, 8192, 16384)


def parity_failures(results: dict) -> dict:
    """Rows whose parity is above 5 * log2(n) * eps (or not a number)."""
    eps = float(np.finfo(np.float32).eps)
    return {
        f"{r['kind']}_n{r['n']}": r.get("parity")
        for r in results["rows"]
        if not r.get("parity", float("nan")) <= 5 * np.log2(r["n"]) * eps
    }


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from ..config import apply_precision
    from ..kernels.fused import whole_transform, whole_transform_packed
    from ..kernels.fused_torch import fused_fft_folded
    from ..kernels.probes import operand_probe
    from ..plan import get_fused_plan, get_whole_packed_plan, get_whole_plan, on_device
    from ..utils import profiling

    apply_precision()
    dev = torch.device(device)
    rng = np.random.default_rng(7)
    timing = dict(k1=5, k2=55, reps=2, min_span_s=0.005) if quick else dict(k1=30, k2=530, reps=4)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick,
                     "operand_probe": {}, "rows": []}
    out = Path(out_dir) / "ablate_whole_packed_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)

    def t(step, x0):
        return profiling.chained_step_stats(step, x0, **timing).median_s

    # ── 1. Per-operand cost ──────────────────────────────────────────────
    tables = [torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(dev)
              for _ in range(max(PROBE_KS))]
    x0 = torch.ones((8, 128), dtype=torch.float32, device=dev)
    for k in PROBE_KS:
        us = t(lambda x, k=k: operand_probe(x, tables[:k]), x0) * 1e6
        results["operand_probe"][str(k)] = us
        print(f"operand probe k={k}: {us:.3f} us/call", flush=True)

    # ── 2. W1 vs W2 vs the folded four-step, B = 1 over the band ─────────
    for complex_in in (False, True):
        tag = "complex" if complex_in else "real"
        for n in SIZES:
            s = float(np.float32(1.0 / np.sqrt(n)))
            p1 = on_device(get_whole_plan, n, -1, None, device=dev)
            p2 = on_device(get_whole_packed_plan, n, -1, None, device=dev)
            fp = on_device(get_fused_plan, n, -1, False, None, device=dev)

            def w1(x, p1=p1, s=s, c=complex_in):
                return whole_transform(x, x if c else None, p1)[0] * s

            def w2(x, p2=p2, s=s, c=complex_in):
                return whole_transform_packed(x, x if c else None, p2)[0] * s

            def folded(x, fp=fp, s=s, c=complex_in):
                return fused_fft_folded(x, x if c else None, fp)[0] * s

            x = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev)
            a, b = w1(x).cpu().numpy(), w2(x).cpu().numpy()
            par = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))
            first = (t(w1, x), t(w2, x), t(folded, x))
            second = (t(w1, x), t(w2, x), t(folded, x))
            t1, t2, tf = (min(p, q) for p, q in zip(first, second))
            row = {"kind": tag, "n": n, "w1_us": t1 * 1e6, "w2_us": t2 * 1e6, "folded_us": tf * 1e6,
                   "w2_vs_w1": t1 / t2, "w2_vs_folded": tf / t2, "parity": par}
            results["rows"].append(row)
            out.write_text(json.dumps(results, indent=1))
            print(f"{tag} n={n:6d}: W1 {row['w1_us']:6.2f}  W2 {row['w2_us']:6.2f}  "
                  f"folded {row['folded_us']:6.2f} us -> W2/W1 {row['w2_vs_w1']:.2f}x "
                  f"W2/folded {row['w2_vs_folded']:.2f}x  par={par:.1e}", flush=True)

    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    main(quick=ap.parse_args().quick)
