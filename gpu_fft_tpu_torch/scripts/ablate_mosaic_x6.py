"""The stage-A dot in three precisions: f32 on the CUDA cores against the
bf16 tensor-core ladders.

Counterpart of ``scripts/ablate_mosaic_x6.py``.  Per variant, the stage-A
shaped product (two logical dots of a constant (n1, n1) LHS against
x (1, n1, n2)) through the S3 kernels (``kernels/ablation.py``,
``csrc/stage_a_dot.cu``):

  f32_highest   fp32 FMA on the CUDA cores
  bf16_x6       the 6-term bf16 ladder (LHS split on the host, x split in
                the kernel) on the tensor cores, fp32 accumulation
  bf16_x1       one bf16 product (a sixth of x6's tensor-core work)

and prints the time per call, per logical dot, and the max error of Yr
relative to a float64 reference.  ``ct`` is the TPU kernel's column block;
the CUDA kernels tile by themselves, so here it only sets the count of
logical dots per call (2 * n2 / ct) that the per-dot time divides by.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_mosaic_x6 [--quick]
Writes ``chiprun_out/ablate_mosaic_x6_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import apply_precision
from ..kernels.ablation import VARIANTS, dot_tables, stage_a_dot
from ..utils.profiling import chained_step_stats


def build(variant: str, n1: int, n2: int, ct: int, fr_np, fi_np, device="cuda"):
    """``run(x) -> (Yr, Yi)`` for x (1, n1, n2) on ``device`` in ``variant``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if n2 % ct:
        raise ValueError(f"ct={ct} must divide n2={n2}")
    fr = torch.as_tensor(np.asarray(fr_np, np.float32), device=device)
    fi = torch.as_tensor(np.asarray(fi_np, np.float32), device=device)
    if fr.shape != (n1, n1) or fi.shape != (n1, n1):
        raise ValueError(f"LHS must be ({n1}, {n1}), got {tuple(fr.shape)} and {tuple(fi.shape)}")
    tables = dot_tables(fr, fi)

    def run(x):
        return stage_a_dot(x, tables, variant)

    return run


def main(quick: bool = False, out_dir: str = "chiprun_out") -> dict:
    apply_precision()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    n1, n2 = 128, 8192
    timing = dict(k1=5, k2=55, reps=2, min_span_s=0.01) if quick else dict(k1=5, k2=105, reps=5)
    results = {"device": torch.cuda.get_device_name(dev), "quick": quick, "n1": n1, "n2": n2,
               "rows": []}
    for ct in (512, 1024):
        fr_np = rng.standard_normal((n1, n1)).astype(np.float32) * (1.0 / n1)
        fi_np = rng.standard_normal((n1, n1)).astype(np.float32) * (1.0 / n1)
        x_np = rng.standard_normal((1, n1, n2)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        ref_r = np.asarray(fr_np, np.float64) @ np.asarray(x_np[0], np.float64)
        nrm = np.abs(ref_r).max()
        n_dots = 2 * (n2 // ct)  # logical dots per call
        for variant in VARIANTS:
            run = build(variant, n1, n2, ct, fr_np, fi_np, device=dev)
            yr = run(x)[0][0].cpu().numpy().astype(np.float64)
            err = float(np.abs(yr - ref_r).max() / nrm)

            def step(z, run=run):
                yr, yi = run(z)
                # Keep both outputs live and renormalize so the chain is stable.
                return yr * 0.9 + yi * 1e-3 + z * 0.1

            s = chained_step_stats(step, x, **timing)
            results["rows"].append(
                {"ct": ct, "variant": variant, "us_per_call": s.median_s * 1e6,
                 "us_per_dot": s.median_s * 1e6 / n_dots, "iqr_us": s.iqr_s * 1e6,
                 "suspect": s.suspect, "rel_err": err}
            )
            print(
                f"ct={ct:5d} {variant:12s}: {s.median_s * 1e6:7.2f} us/call "
                f"({s.median_s * 1e6 / n_dots:6.3f} us/logical-dot)  "
                f"iqr={s.iqr_s * 1e6:5.2f}  rel_err={err:.2e}",
                flush=True,
            )
    out = Path(out_dir) / "ablate_mosaic_x6_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    main(quick=ap.parse_args().quick)
