"""Device time of the stage-A kernel (K3) at the main path's shapes, for
comparing two checkouts of the port on one card.

    python gpu_fft_tpu_torch/scripts/time_stage_a.py --tree DIR --label NAME [--sweep]

imports ``gpu_fft_tpu_torch`` from the checkout at DIR (built there on first
use), times K3 on the factored plan that ``transform_any`` uses at 2^20 and
2^22 (real input, the real path's rows; complex input, all rows) and appends
one JSON line to ``chiprun_out/time_stage_a.jsonl``.  The time is the
profiler's device time of the stage-A kernel, median of 5 profiles of 50
calls each.  Run it once per checkout, in turns (A B B A), in one session on
the card: times from two sessions do not compare.

``--sweep`` (a checkout whose K3 is the radix kernel, with the geometry
arguments) also times it at every column-tile width W in {16, 32, 64, 128}
that fits 1,024 threads (n1 W / 8), each launch checked against the plain
version (max|d| <= 1e-5 max|plain|), beside the width ``stage_a_geometry``
picks; the rows go into the same JSON line under ``sweep``.

``time_dot.py`` beside it times S3 with the same helpers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def kernel_ms(fn, match: str = "", calls: int = 50, profiles: int = 5) -> float:
    """Median over ``profiles`` of the per-call device time (ms) of the CUDA
    kernels whose name holds ``match`` (every kernel for "")."""
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
        us = sum(e.self_device_time_total for e in prof.key_averages() if match in e.key)
        if us <= 0:
            raise RuntimeError(f"the profiler recorded no kernel matching {match!r}")
        samples.append(us / calls / 1000.0)
    return statistics.median(samples)


def open_tree(root: str) -> None:
    """Import ``gpu_fft_tpu_torch`` from the checkout at ``root`` from now on."""
    sys.path.insert(0, str(Path(root).resolve()))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def append_record(name: str, rec: dict) -> None:
    """Append ``rec`` as one JSON line to ``chiprun_out/<name>``."""
    out = Path("chiprun_out") / name
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(rec) + "\n")


def sweep_widths(lib, K, plan, xr, xi, rows: int) -> list[dict]:
    """K3 at every width W that fits, launched through the C entry point."""
    import torch

    n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
    names = ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i")
    want = K.stage_a_plain(xr, xi, n1, n2, plan, ct, rows=rows)
    scale = max(float(w.abs().max()) for w in want)
    yr, yi = torch.empty_like(want[0]), torch.empty_like(want[1])
    stream = torch.cuda.current_stream().cuda_stream
    shipped = K.stage_a_geometry(1, n1, n2, n2)[0]
    out = []
    for width in (16, 32, 64, 128):
        threads = n1 * width // 8
        if threads > 1024:
            continue

        def launch(width=width, threads=threads):
            err = lib.gft_stage_a(xr.data_ptr(), None if xi is None else xi.data_ptr(),
                                  *(plan[k].data_ptr() for k in names), yr.data_ptr(), yi.data_ptr(),
                                  1, n1, n2, ct, rows, n2, width, threads, 8 * (n1 * width + n1), stream)
            if err:
                raise RuntimeError(lib.gft_error_string(err).decode())

        launch()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip((yr, yi), want))
        row = {"n": n1 * n2, "kind": "real" if xi is None else "complex", "rows": rows, "width": width,
               "threads": threads, "shipped": width == shipped, "max_abs_err": err,
               "ok": err <= 1e-5 * scale, "ms": kernel_ms(launch, "stage_a")}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to import the port from")
    ap.add_argument("--label", required=True, help="name of the checkout in the output")
    ap.add_argument("--sweep", action="store_true", help="also time every column-tile width")
    args = ap.parse_args()
    open_tree(args.tree)
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import _build
    from gpu_fft_tpu_torch.kernels import fused as K

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    apply_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {"label": args.label, "tree": args.tree, "card": card_line(),
           "module": K.__file__, "ms": {}, "sweep": []}
    for n in (1 << 20, 1 << 22):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        xr = torch.randn(1, n1, n2, generator=gen, device=dev)
        xi = torch.randn(1, n1, n2, generator=gen, device=dev)
        rec["ms"][f"n={n} real rows={rows}"] = kernel_ms(
            lambda: K.stage_a(xr, None, n1, n2, plan, ct, rows=rows), "stage_a")
        rec["ms"][f"n={n} complex"] = kernel_ms(lambda: K.stage_a(xr, xi, n1, n2, plan, ct), "stage_a")
        for xi_, r in ((None, rows), (xi, n1)) if args.sweep else ():
            rec["sweep"] += sweep_widths(_build.library(), K, plan, xr, xi_, r)
    append_record("time_stage_a.jsonl", rec)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
