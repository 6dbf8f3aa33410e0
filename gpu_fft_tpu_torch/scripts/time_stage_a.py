"""Device time of the stage-A kernels at their harness and main-path shapes,
for comparing two checkouts of the port on one card.

    python gpu_fft_tpu_torch/scripts/time_stage_a.py --tree DIR --label NAME [--legacy] [--sweep]

imports ``gpu_fft_tpu_torch`` from the checkout at DIR (built there on first
use), times K3 on the factored plan that ``transform_any`` uses at 2^20,
2^22 and 2^24 (n1 = 256) (real input, the real path's rows; complex input,
all rows), on the irfft fold's column tiles at 2^20 and 2^22 (complex
input, sign +1, the first ceil((n2/2 + 1) / ct)) and at B = 512 x 2^17 (the
2-D panel's rows, real and complex), each back to back and with L2 flushed
before every call (the key's suffix ``L2 flushed``), and appends one JSON
line to ``chiprun_out/time_stage_a.jsonl``.  The time is the
profiler's device time of the stage-A kernel, median of 5 profiles of 50
calls each (a profile that records no kernel is taken again and counted
under ``empty_profiles``); before it, one launch is checked against the
plain version (max|d| <= 1e-5 max|plain|, the error under
``max_abs_err``).  Run it once per checkout, in turns (A B B A), on one
card in one run: times from two runs do not compare.

It times the kernels of the process's precision mode, and the JSON line
names it (``mode``): under ``GPU_FFT_TPU_PRECISION=fast`` ``stage_a`` runs
K3F (K3LF on a legacy plan) and ``stage_a_manual`` S2F, each checked
against its bf16 plain version within :data:`FAST_TOL`; ``--sweep`` times
the fp32 kernels' launch shapes in either mode.

``--legacy`` also times the kernels of stage A on a materialized twiddle,
on the ``ablate_large`` plans: K3-legacy (``stage_a`` on such a plan) at
2^20 on real input with all rows and with the real path's 72, at 2^22 with
72, and at 2^20 on complex input with all rows, each also with L2 flushed
before every call; S2 (``stage_a_manual``) at 2^20 with n1 = 128 and
n1 = 256.  It runs on a checkout from before S2's stacked table too
(``s2_setup``).

``--sweep`` (a checkout whose K3 is the radix kernel, with the geometry
arguments) also times it at every column-tile width W in {16, 32, 64, 128}
that fits 1,024 threads (n1 W / 8), each launch checked against the plain
version, beside the width ``stage_a_geometry`` picks; under "fast" (a
checkout with ``stage_a_bf16_launch_shapes``) K3F at every launch shape of
its rule at 2^20, 2^22 and 2^24, the rule's pick marked; with ``--legacy``
(a checkout with ``manual_launch_shapes``) also S2 at every column tile
``manual_geometry`` considers, the shipped one marked (not under "fast",
where the plain version it is held to takes bf16 operands).  The rows go into
the same JSON line under ``sweep``.

To A/B two versions of a kernel, unpack the parent commit with ``git
archive`` into a directory that ``.gitignore`` lists and run this script
from the working tree on each checkout in turns (A B B A) in one call, e.g.
``GPU_FFT_TPU_PRECISION=fast`` for K3F / K3LF (``--legacy``) and S2F.

``time_dot.py`` beside it times S3 with the same helpers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


#: A "fast" kernel against its plain version, relative to max|plain|: both
#: round the same operands to bf16 and sum in fp32 in other orders.
FAST_TOL = 1e-3

#: The (B, n) of the factored-plan rows: the staged sizes (2^24 is n1 = 256)
#: and the 2-D panel's rows.
MAIN_CASES = ((1, 1 << 20), (1, 1 << 22), (1, 1 << 24), (512, 1 << 17))

#: Profiles that recorded no matching kernel since the script started.  The
#: profiler on an H100 now and then records no kernel at all, several times
#: in a row; such a profile is taken again and counted here, and
#: :func:`append_record` writes the count into each JSON line.
EMPTY_PROFILES = 0


def kernel_ms(fn, match: str = "", calls: int = 50, profiles: int = 5) -> float:
    """Median over ``profiles`` profiles of the per-call device time (ms) of
    the CUDA kernels whose name holds ``match`` (every kernel for "").  A
    profile with no such kernel is taken again and counted in
    ``EMPTY_PROFILES``; more empty profiles than ``profiles`` in one call
    raise."""
    global EMPTY_PROFILES
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples, empty = [], 0
    while len(samples) < profiles:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages() if match in e.key)
        if us > 0:
            samples.append(us / calls / 1000.0)
            continue
        empty += 1
        EMPTY_PROFILES += 1
        if empty > profiles:
            raise RuntimeError(f"the profiler recorded no kernel matching {match!r} in {empty} profiles")
    return statistics.median(samples)


def l2_flush(dev, mib: int = 256):
    """A call that reads ``mib`` MiB on ``dev``, so that a kernel launched
    after it finds none of its inputs in L2 (50 MB on an H100).  Its own
    kernel's name holds no kernel name of the port's."""
    import torch

    buf = torch.ones(mib << 18, device=dev)
    return lambda: buf.sum()


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
        f.write(json.dumps({**rec, "empty_profiles": EMPTY_PROFILES}) + "\n")


def fast_mode() -> bool:
    """Whether the imported port runs its "fast" kernels now."""
    from gpu_fft_tpu_torch import config

    return getattr(config, "PRECISION", "full") == "fast"


def checked_ms(fn, plain, match: str = "") -> tuple[float, float]:
    """(device ms of ``fn`` as :func:`kernel_ms` gives it, max|fn() - plain()|);
    raises if one launch is off its plain version by more than 1e-5
    max|plain| (:data:`FAST_TOL` under "fast")."""
    import torch

    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    tol = FAST_TOL if fast_mode() else 1e-5
    if not err <= tol * scale:
        raise RuntimeError(f"kernel off its plain version: max|d| {err:.3e} > {tol} x {scale:.3e}")
    return kernel_ms(fn, match), err


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


def sweep_bf16(K, plan, xr, xi, rows: int) -> list[dict]:
    """K3F at every launch shape of its rule (``stage_a_bf16_launch_shapes``),
    each launch checked against the plain version."""
    n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
    (img,) = K.bf16_images(plan)
    tables = [img, *(plan[k] for k in ("two_r", "two_i", "twi_r", "twi_i"))]
    shapes = K.stage_a_bf16_launch_shapes(1, n1, n2, rows, n2, xi is not None, K.sm_count(xr.device))
    want = lambda: K.stage_a_bf16_plain(xr, xi, n1, n2, plan, ct, rows=rows)  # noqa: E731
    out = []
    for geometry in shapes:
        ms, err = checked_ms(lambda g=geometry: K.stage_a_bf16_launch(xr, xi, tables, n1, n2, ct, rows, n2, g),
                             want, "stage_a")
        row = {"kernel": "stage_a_bf16", "n": n1 * n2, "kind": "real" if xi is None else "complex", "rows": rows,
               "geometry": geometry, "shipped": geometry == shapes[0], "max_abs_err": err, "ms": ms}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def time_row(rec: dict, key: str, fn, plain, flush) -> None:
    """``fn`` into ``rec`` under ``key``, back to back and, under ``key + " L2
    flushed"``, with ``flush`` before every call."""
    def cold():
        flush()
        return fn()

    for k, f in ((key, fn), (f"{key} L2 flushed", cold)):
        rec["ms"][k], rec["max_abs_err"][k] = checked_ms(f, plain, "stage_a")
        print(k, rec["ms"][k], flush=True)


def s2_setup(A, plan: dict, n1: int) -> tuple[dict, list]:
    """S2's plan and column tiles on the checkout ``A`` comes from.  One from
    before S2's stacked table has neither ``manual_tables`` (its S2 takes
    the legacy plan as it is) nor ``manual_launch_shapes``: no tiles."""
    if not hasattr(A, "manual_tables"):
        return plan, []
    return A.manual_tables(plan), A.manual_launch_shapes(n1, plan["n2"])


def time_legacy(rec: dict, sweep: bool, dev, gen) -> None:
    """K3-legacy and S2 on the ``ablate_large`` plans into ``rec`` (and S2
    at every column tile into ``rec["sweep"]`` with ``sweep``).  K3-legacy
    is timed twice: back to back, where at 2^20 its inputs (21-25 MB) stay
    in L2 between calls, and with L2 flushed before each call (the key's
    suffix ``L2 flushed``), which is what its share of the HBM bound reads.
    Under "fast" the same rows time K3LF and S2F against their bf16 plain
    versions."""
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import ablation as A
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.scripts.ablate_large import make_plan

    fast = fast_mode()
    stage_a_plain = K.stage_a_bf16_plain if fast else K.stage_a_plain
    manual_plain = A.stage_a_manual_bf16_plain if fast else A.stage_a_manual_plain

    flush = l2_flush(dev)
    for n, rows, complex_ in ((1 << 20, None, False), (1 << 20, 72, False), (1 << 22, 72, False),
                              (1 << 20, None, True)):
        plan = P.on_device(make_plan, n, 128, -1, device=dev)
        n2 = plan["n2"]
        ct = P.stage_a_col_tile(128, n2)
        xr = torch.randn(1, 128, n2, generator=gen, device=dev)
        xi = torch.randn(1, 128, n2, generator=gen, device=dev) if complex_ else None
        key = f"legacy n={n} {'complex' if complex_ else 'real'} rows={rows or 'all'}"

        def run():
            return K.stage_a(xr, xi, 128, n2, plan, ct, rows=rows)

        def run_cold():
            flush()
            return run()

        for k, fn in ((key, run), (f"{key} L2 flushed", run_cold)):
            rec["ms"][k], rec["max_abs_err"][k] = checked_ms(
                fn, lambda: stage_a_plain(xr, xi, 128, n2, plan, ct, rows=rows), "stage_a")
            print(k, rec["ms"][k], flush=True)
        del xr, xi
    for n1 in (128, 256):
        plan, tiles = s2_setup(A, P.on_device(make_plan, 1 << 20, n1, -1, device=dev), n1)
        x = torch.randn(n1, plan["n2"], generator=gen, device=dev)
        key = f"manual n={1 << 20} n1={n1}"
        rec["ms"][key], rec["max_abs_err"][key] = checked_ms(
            lambda: A.stage_a_manual(x, plan), lambda: manual_plain(x, plan))
        print(key, rec["ms"][key], flush=True)
        want = A.stage_a_manual_plain(x, plan)
        for i, bn in enumerate(tiles if sweep and not fast else ()):  # S2's tiles; S2F has none
            ms, err = checked_ms(lambda bn=bn: A.manual_launch(x, plan, bn), lambda: want)
            row = {"kernel": "stage_a_manual", "n": 1 << 20, "n1": n1, "bn": bn,
                   "shipped": i == 0, "max_abs_err": err, "ms": ms}
            print(json.dumps(row), flush=True)
            rec["sweep"].append(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to import the port from")
    ap.add_argument("--label", required=True, help="name of the checkout in the output")
    ap.add_argument("--legacy", action="store_true", help="also time K3-legacy and S2")
    ap.add_argument("--sweep", action="store_true", help="also time every launch shape that fits")
    args = ap.parse_args()
    open_tree(args.tree)
    import torch

    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import _build
    from gpu_fft_tpu_torch.kernels import fused as K

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    apply_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {"label": args.label, "tree": args.tree, "card": card_line(), "module": K.__file__,
           "mode": getattr(config, "PRECISION", "full"), "ms": {}, "max_abs_err": {}, "sweep": []}
    stage_a_plain = K.stage_a_bf16_plain if fast_mode() else K.stage_a_plain
    flush = l2_flush(dev)
    sweep_fast = args.sweep and fast_mode() and hasattr(K, "stage_a_bf16_launch_shapes")
    for b, n in MAIN_CASES:
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        xr = torch.randn(b, n1, n2, generator=gen, device=dev)
        xi = torch.randn(b, n1, n2, generator=gen, device=dev)
        at = f"n={n}" if b == 1 else f"B={b} n={n}"
        cases = [(f"{at} real rows={rows}", plan, None, None, rows), (f"{at} complex", plan, xi, None, None)]
        if b == 1 and n < 1 << 24:
            fold = P.on_device(P.get_stage_a_plan, n, 1, None, device=dev)
            tiles = -(-(n2 // 2 + 1) // fold["ct"])
            cases.append((f"{at} irfft col_tiles={tiles}/{n2 // fold['ct']} ct={fold['ct']}", fold, xi, tiles, None))
        for key, p, xi_, tiles, r in cases:
            time_row(rec, key, lambda p=p, xi_=xi_, tiles=tiles, r=r: K.stage_a(xr, xi_, n1, n2, p, p["ct"], tiles, r),
                     lambda p=p, xi_=xi_, tiles=tiles, r=r: stage_a_plain(xr, xi_, n1, n2, p, p["ct"], tiles, r),
                     flush)
        if b == 1:
            for xi_, r in ((None, rows), (xi, n1)) if args.sweep and not fast_mode() and n < 1 << 24 else ():
                rec["sweep"] += sweep_widths(_build.library(), K, plan, xr, xi_, r)
            for xi_, r in ((None, rows), (xi, n1)) if sweep_fast else ():
                rec["sweep"] += sweep_bf16(K, plan, xr, xi_, r)
        del xr, xi
    if args.legacy:
        time_legacy(rec, args.sweep, dev, gen)
    append_record("time_stage_a.jsonl", rec)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
