"""Device time of the stage-A kernel (K3) at the main path's shapes, for
comparing two checkouts of the port on one card.

    python gpu_fft_tpu_torch/scripts/time_stage_a.py --tree DIR --label NAME

imports ``gpu_fft_tpu_torch`` from the checkout at DIR (built there on first
use), times K3 on the factored plan that ``transform_any`` uses at 2^20 and
2^22 (real input, the real path's rows; complex input, all rows) and appends
one JSON line to ``chiprun_out/time_stage_a.jsonl``.  The time is the
profiler's device time of the stage-A kernel, median of 5 profiles of 50
calls each.  Run it once per checkout, in turns (A B B A), in one session on
the card: times from two sessions do not compare.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def kernel_ms(fn, calls: int = 50, profiles: int = 5) -> float:
    """Median over ``profiles`` of the per-call device time (ms) of the CUDA
    kernels whose name holds ``stage_a``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages() if "stage_a" in e.key)
        if us <= 0:
            raise RuntimeError("the profiler recorded no stage_a kernel")
        samples.append(us / calls / 1000.0)
    return statistics.median(samples)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to import the port from")
    ap.add_argument("--label", required=True, help="name of the checkout in the output")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import fused as K

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    apply_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    rec = {"label": args.label, "tree": args.tree, "card": card,
           "module": K.__file__, "ms": {}}
    for n in (1 << 20, 1 << 22):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        xr = torch.randn(1, n1, n2, generator=gen, device=dev)
        xi = torch.randn(1, n1, n2, generator=gen, device=dev)
        rec["ms"][f"n={n} real rows={rows}"] = kernel_ms(
            lambda: K.stage_a(xr, None, n1, n2, plan, ct, rows=rows))
        rec["ms"][f"n={n} complex"] = kernel_ms(lambda: K.stage_a(xr, xi, n1, n2, plan, ct))
    out = Path("chiprun_out") / "time_stage_a.jsonl"
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
