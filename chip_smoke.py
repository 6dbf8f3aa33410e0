#!/usr/bin/env python3
"""Drive the PyTorch port (gpu_fft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build: a CUDA card, TF32 off, the kernels built from
   ``gpu_fft_tpu_torch/csrc`` with nvcc (build seconds printed);
2. every kernel against its plain torch version on the card, at the shapes
   its path gives it (gate: max|kernel - plain| <= 1e-5 max|plain|, and
   bit-equal for S4 and S5, whose steps are rounded one at a time): K1, K2
   and K3 of the transform path (K3 also at each ct that the levers
   harness sets at 2^18, and on the staged real-output inverse's complex
   input, sign +1, on the first ceil((n2/2 + 1) / ct) column tiles, at
   2^18 … 2^24 for ct = 512, 1,024, 2,048); K3-legacy, S2 and S3 of the stage-A
   ablation harnesses, with S3's error against float64 (gate for f32 and
   bf16_x6: 5*log2(n1)*eps; bf16_x1 printed);
3. the main path through the public API on ``device="cuda"``: the sine ->
   fft -> psd -> dominant frequency -> ifft demo, fft/ifft from n = 1024 to
   2^22, fft_batch and ifft_batch, each checked against numpy in float64 with
   the 5*log2(N)*eps gate and against torch.fft; the launch counts show each
   kernel ran.  Then this slice's path, real input and output, with the
   counts set to 0 before it: rfft against numpy's, irfft_device and irfft
   against numpy's irfft (float64) and torch.fft.irfft from n = 256 to 2^24,
   irfft_device at (16, 65,536) and (64, 4,096); its counts show K2, K1 and
   K3 ran where the dispatch sends them;
4. warm median times with CUDA events (back-to-back calls, host included)
   and device times from torch.profiler (the kernels alone): each kernel
   against its plain version, its bound on the card and, where one exists,
   the one PyTorch call that computes the same function (K1 and K2 on real
   forward and on complex inverse input, beside torch.fft.fft and
   torch.fft.ifft; K3 at 2^20 and 2^22 on real input with the real path's
   rows and on complex input with the inverse plan, the ifft path, and on
   the irfft path's column tiles; S3 f32 beside torch.matmul on the
   stacked LHS, S3 bf16_x1 beside torch.mm of the bf16 operands into fp32,
   or the refusal's text where torch has no out_dtype); each main-path call
   against torch.fft, and irfft_device beside ifft_device and
   torch.fft.irfft;
5. the second path: the three stage-A ablation harnesses
   (``python -m gpu_fft_tpu_torch.scripts.<name>``) in their quick setting;
   the launch counts show K3-legacy, S2 and S3 ran, no row holds an error,
   and every timed levers row (the L4 irfft rows too) agrees with its
   reference row within 5*log2(2^22)*eps;
6. the third path, calibration: ``calibrate_latency``, ``calibrate_matmul``,
   ``ablate_whole_packed``, ``ablate_engines`` and ``calibrate_chip`` in
   their quick setting; the launch counts show S1, S4 and S5 (and K1, K2,
   K3) ran, every timed row is a positive number (the irfft fold gate's
   too), the only rows without a time are the retired ones and the
   unported overlap-add block, and every parity row is within
   5*log2(n)*eps.

Phase 2 also holds S1 (the left-matmul four-step), S4 (the operand probe)
and S5 (the launch-floor copy) against their plain versions, S1 also
against float64 (5*log2(n)*eps); phase 4 times them.  Bounds use the
card's published peaks, ``gpu_fft_tpu_torch.utils.roofline.CHIPS["h100"]``.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # kernel vs plain, relative to max|plain|: both fp32, TF32 would be ~50x over
EPS32 = 1.1920929e-07
MAIN_PATH_KERNELS = ("whole_transform", "whole_transform_packed", "stage_a")
CALIBRATION_KERNELS = ("fused_fft_lm", "operand_probe", "copy_min")
# The transform-path kernels the calibration scripts also drive.
CALIBRATION_PATH_KERNELS = (*CALIBRATION_KERNELS, *MAIN_PATH_KERNELS)
LM_CASES = ((1, 4096), (1, 16384), (1, 65536), (16, 4096), (16, 65536), (64, 4096), (1, 32768))
# The real-output path: B = 1 sizes, batches, the staged sizes where K3 runs
# on half the column tiles, and the shapes timed in phase 4.
IRFFT_SIZES = (256, 1024, 4096, 16384, 65536, 1 << 17, 1 << 20, 1 << 22, 1 << 24)
IRFFT_BATCHES = ((16, 65536), (64, 4096))
IRFFT_STAGED = (1 << 18, 1 << 20, 1 << 22, 1 << 24)
IRFFT_TIMED = ((1, 32768), (1, 65536), (1, 1 << 20), (1, 1 << 22), (16, 65536))


T0 = time.perf_counter()


def stamp(what: str) -> None:
    """Seconds since the start, on stderr: where the run's time goes."""
    print(f"chip_smoke: {what} at {time.perf_counter() - T0:.1f} s", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gate(n: int) -> float:
    return 5.0 * (n.bit_length() - 1) * EPS32


@functools.lru_cache(maxsize=1)
def h100():
    """The card's published peaks (``roofline.CHIPS["h100"]``: fp32 outside
    the tensor cores, dense bf16, HBM)."""
    from gpu_fft_tpu_torch.utils.roofline import CHIPS

    return CHIPS["h100"]


def bound(flop: float, peak: str, nbytes: float):
    """(ms, wall): the least time for ``flop`` operations at the ``peak``
    ("fp32" or "bf16") rate and ``nbytes`` moved at the HBM rate, and which
    of the two is larger."""
    spec = h100()
    rate = {"fp32": spec.vpu_tflops, "bf16": spec.bf16_tflops}[peak] * 1e12
    t_ops, t_bytes = flop / rate * 1e3, nbytes / (spec.hbm_gbps * 1e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def whole_bound(n: int, complex_: bool):
    """K1/K2, B = 1 (the same for both table layouts): a radix-2 FFT's
    5 n log2 n FLOP and the twiddle's 6 per complex value; x (both parts for
    complex input), TW, the n1- and 128-point root rows and the scale read
    once, the complex output written once."""
    n1 = n // 128
    flop = 5 * n * (n.bit_length() - 1) + 6 * n
    return bound(flop, "fp32", 4 * ((2 if complex_ else 1) * n + 2 * n + 2 * (n1 + 128) + 1 + 2 * n))


def stage_a_bound(n1: int, n2: int, rows: int, complex_: bool, ct: int, ncols: int | None = None):
    """K3, B = 1, on the first ``ncols`` (default n2) columns: a radix-2
    FFT's 5 n1 log2 n1 FLOP per column and 6 per stored output for the
    factored twiddle (rebuilt, 6 more); those columns of x (both parts for
    complex input), the n1-point root row, the twiddle's rows (two
    (rows, ncols/ct), twi (rows, ct)) read once, the output written once."""
    ncols = n2 if ncols is None else ncols
    flop = 5 * n1 * (n1.bit_length() - 1) * ncols + 12 * rows * ncols
    nbytes = 4 * ((2 if complex_ else 1) * n1 * ncols + 2 * n1 + 2 * rows * (ncols // ct + ct)
                  + 2 * rows * ncols)
    return bound(flop, "fp32", nbytes)


def dense_stage_a_bound(n1: int, n2: int, rows: int, twiddle_floats: int):
    """K3-legacy / S2 (real input), B = 1: rows x n1 x n2 real products,
    6 FLOP per output for the twiddle; x, F1's rows and the twiddle read
    once, the output written once."""
    flop = 4 * rows * n1 * n2 + 6 * rows * n2
    return bound(flop, "fp32", 4 * (n1 * n2 + 2 * rows * n1 + twiddle_floats + 2 * rows * n2))


def dot_bound(n1: int, n2: int, variant: str):
    """S3: two (n1, n1) x (n1, n2) products (six bf16 passes each for
    bf16_x6); x and the LHS read once, Yr and Yi written once."""
    if variant == "f32_highest":
        return bound(4 * n1 * n1 * n2, "fp32", 4 * (3 * n1 * n2 + 2 * n1 * n1))
    passes, parts = (6, 3) if variant == "bf16_x6" else (1, 1)
    return bound(passes * 4 * n1 * n1 * n2, "bf16", 4 * 3 * n1 * n2 + 2 * 2 * parts * n1 * n1)


def lm_bound(b: int, n: int, n1: int, n2: int):
    """S1, real forward: per row a radix-2 FFT's 5 n log2 n FLOP and 6 per
    twiddle; x, TW, the n1- and n2-point root rows and F2[0, 0] read once,
    the complex output written once."""
    flop = b * (5 * n * (n.bit_length() - 1) + 6 * n)
    return bound(flop, "fp32", 4 * (b * n + 2 * n + 2 * n1 + n2 + 1 + 2 * b * n))


def probe_bound(k: int):
    """S4 with k tables (S5 at k = 0): one multiply per element of the
    (8, 128) tile and a multiply and an add per table element it reads; x,
    the eight rows read of each table, the output."""
    return bound(1024 * (1 + 2 * k), "fp32", 4 * 1024 * (2 + k))


def cuda_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Warm median over ``repeats`` of the mean time of ``iters`` calls (ms)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, iters: int = 20, attempts: int = 3, top: int = 4):
    """Device time per call (ms) summed over the CUDA kernels torch.profiler
    records for ``iters`` warm calls, and the ``top`` kernels by time.  A profile
    that comes back with no device event is taken again, up to ``attempts``
    times; None where none of them records device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / iters / 1000.0
        if by_name:
            break
    if not by_name:
        return None, []
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [(k[:60], v) for k, v in ranked]


def main() -> None:
    if not (ROOT / "gpu_fft_tpu_torch" / "__init__.py").is_file():
        fail(f"gpu_fft_tpu_torch not found beside {Path(__file__).name}; run from the repo root")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import _build
    from gpu_fft_tpu_torch.kernels import ablation as A
    from gpu_fft_tpu_torch.kernels import engines as E
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import probes as Pr
    from gpu_fft_tpu_torch.scripts import (
        ablate_2e20_levers,
        ablate_engines,
        ablate_large,
        ablate_mosaic_x6,
        ablate_whole_packed,
        calibrate_chip,
        calibrate_latency,
        calibrate_matmul,
    )

    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"kernel_checks": [], "main_path": [], "times": []}

    # ── Phase 1: device and build ───────────────────────────────────────────
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("phase 1: device")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    apply_precision()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    print("tf32: matmul off, cudnn off")
    info = _build.build()
    _build.library()
    print(f"build: {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  ptxas:", line.strip())
    report.update(card=smi, build_seconds=info.seconds, build_log=info.log)

    # ── Phase 2: each kernel against its plain version on the card ──────────
    stamp("phase 2")
    print("phase 2: kernels vs plain torch (gate max|d| <= 1e-5 max|plain|)")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {name: 0.0 for name in (*K.COUNTS, *A.COUNTS, *E.COUNTS, *Pr.COUNTS)}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def compare(name, case, got, want, exact=False):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        ok = all(torch.equal(g, w) for g, w in zip(got, want)) if exact else err <= TOL * scale
        max_err[name] = max(max_err[name], err)
        report["kernel_checks"].append(dict(kernel=name, case=case, max_abs_err=err, max_abs=scale,
                                            exact=exact, ok=ok))
        print(f"  {name:24s} {case:40s} max|d| {err:.3e} max|plain| {scale:.3e}"
              f"{' (bit-equal gate)' if exact else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")

    whole_cases = [("whole_transform_packed", 1024, 1)] + [
        ("whole_transform", n, b) for n in (2048, 4096, 16384) for b in (1, 3)
    ] + [("whole_transform", n, 1) for n in (32768, 65536)]  # beyond the gate: no n1 limit
    for name, n, b in whole_cases:
        kern = getattr(K, name)
        plain = getattr(K, name + "_plain")
        make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
        fwd = P.on_device(make_plan, n, -1, None, device=dev)
        inv = P.on_device(make_plan, n, 1, 1.0 / n, device=dev)
        xr, xi = randn(b, n), randn(b, n)
        compare(name, f"B={b} n={n} real fwd", kern(xr, None, fwd), plain(xr, None, fwd))
        compare(name, f"B={b} n={n} complex inv 1/n", kern(xr, xi, inv), plain(xr, xi, inv))
        torch.cuda.synchronize()

    # The shipped ct at 2^17, 2^20 and 2^24; at 2^18 (n2 = 2,048) every ct
    # that the L4 lever of ablate_2e20_levers sets.
    k3_cases = [(1 << 17, None), *(((1 << 18), ct) for ct in (512, 1024, 2048)),
                (1 << 20, None), (1 << 24, None)]
    for n, ct in k3_cases:
        ct = P.stage_a_ct_full_range(n) if ct is None else ct
        plan = P.on_device(P.get_stage_a_plan, n, -1, ct, device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        xr, xi = randn(1, n1, n2), randn(1, n1, n2)
        cases = [(f"n={n} real rows={rows}", xr, None, None, rows), (f"n={n} complex", xr, xi, None, None)]
        if n == 1 << 17:
            cases.append((f"n={n} complex col_tiles=1", xr, xi, 1, None))
        for case, a, b_, tiles, r in cases:
            got = K.stage_a(a, b_, n1, n2, plan, ct, col_tiles=tiles, rows=r)
            want = K.stage_a_plain(a, b_, n1, n2, plan, ct, col_tiles=tiles, rows=r)
            compare("stage_a", f"{case} ct={ct}", got, want)
        del xr, xi
        torch.cuda.synchronize()

    # K3 as the staged real-output inverse runs it: complex input, sign +1,
    # all rows, the first ceil((n2/2 + 1) / ct) column tiles; ct = 512 is the
    # path's (the plan's default tile), 1,024 and 2,048 the L4 lever's.
    for n in IRFFT_STAGED:
        for ct in (512, 1024, 2048):
            plan = P.on_device(P.get_stage_a_plan, n, 1, ct, device=dev)
            n1, n2 = plan["n1"], plan["n2"]
            tiles = -(-(n2 // 2 + 1) // ct)
            xr, xi = randn(1, n1, n2), randn(1, n1, n2)
            got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles)
            want = K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles)
            compare("stage_a", f"n={n} inv col_tiles={tiles}/{n2 // ct} ct={ct}", got, want)
            del xr, xi, got, want
        torch.cuda.synchronize()

    # K3-legacy: every (n, n1) of the ablate_large sweep (materialized
    # twiddle, real input as staged_fft gives it), and the complex, rows and
    # col_tiles forms of the wrapper.
    legacy_cases = [(n, n1, False, None, None) for n, n1s in ablate_large.SWEEPS.items() for n1 in n1s]
    legacy_cases += [(1 << 17, 16, True, None, None), (1 << 17, 128, False, None, 72),
                     (1 << 17, 128, True, 1, None), (1 << 20, 128, True, None, None)]
    for n, n1, complex_, tiles, r in legacy_cases:
        plan = P.on_device(ablate_large.make_plan, n, n1, -1, device=dev)
        n2 = plan["n2"]
        ct = P.stage_a_col_tile(n1, n2)
        xr = randn(1, n1, n2)
        xi = randn(1, n1, n2) if complex_ else None
        got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=r)
        want = K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=r)
        case = f"n={n} n1={n1} {'complex' if complex_ else 'real'} rows={r} col_tiles={tiles} ct={ct}"
        compare("stage_a_legacy", case, got, want)
        del xr, xi, got, want
        torch.cuda.synchronize()

    # S2 at 2^20 on the legacy plan of the shipped digit (n1 = 128).
    s2_plan = P.on_device(ablate_large.make_plan, 1 << 20, 128, -1, device=dev)
    x = randn(128, s2_plan["n2"])
    compare("stage_a_manual", "n=2^20 n1=128 real", A.stage_a_manual(x, s2_plan),
            A.stage_a_manual_plain(x, s2_plan))
    torch.cuda.synchronize()

    # S3 at (128, 8192), the ablate_mosaic_x6 shape; also against float64.
    s3_rng = np.random.default_rng(7)
    n1_s3, n2_s3 = 128, 8192
    fr_np = s3_rng.standard_normal((n1_s3, n1_s3)).astype(np.float32) / n1_s3
    fi_np = s3_rng.standard_normal((n1_s3, n1_s3)).astype(np.float32) / n1_s3
    x_np = s3_rng.standard_normal((1, n1_s3, n2_s3)).astype(np.float32)
    s3_tables = A.dot_tables(torch.from_numpy(fr_np).to(dev), torch.from_numpy(fi_np).to(dev))
    s3_x = torch.from_numpy(x_np).to(dev)
    ref_r = fr_np.astype(np.float64) @ x_np[0].astype(np.float64)
    ref_i = fi_np.astype(np.float64) @ x_np[0].astype(np.float64)
    peak = max(np.abs(ref_r).max(), np.abs(ref_i).max())
    s3_gate = 5 * np.log2(n1_s3) * EPS32
    report["s3_rel_err"] = {}
    for v in A.VARIANTS:
        got = A.stage_a_dot(s3_x, s3_tables, v)
        compare(f"stage_a_dot_{v}", f"(1, {n1_s3}, {n2_s3})", got, A.stage_a_dot_plain(s3_x, s3_tables, v))
        rel = max(float(np.abs(got[0][0].cpu().numpy() - ref_r).max()),
                  float(np.abs(got[1][0].cpu().numpy() - ref_i).max())) / peak
        report["s3_rel_err"][v] = rel
        gated = v != "bf16_x1"
        print(f"  stage_a_dot_{v:12s} vs float64: rel err {rel:.3e}"
              + (f" gate {s3_gate:.3e} {'ok' if rel <= s3_gate else 'FAIL'}" if gated else " (not gated)"))
        if gated and not rel <= s3_gate:
            fail(f"stage_a_dot {v}: error {rel:.3e} against float64 over {s3_gate:.3e}")
    torch.cuda.synchronize()

    # S1 at every ablate_engines shape and at the uneven split (1, 32,768);
    # also against float64.
    report["s1_rel_err"] = {}
    for b, n in LM_CASES:
        t = P.on_device(E.lm_tables, n, -1, device=dev)
        x = randn(b, n)
        got = E.fused_fft_lm(x, t)
        compare("fused_fft_lm", f"B={b} n={n} ({t['n1']} x {t['n2']}) real fwd", got,
                E.fused_fft_lm_plain(x, t))
        ref = np.fft.fft(x.cpu().double().numpy(), axis=-1)
        rel = max(float(np.abs(got[0].cpu().numpy() - ref.real).max()),
                  float(np.abs(got[1].cpu().numpy() - ref.imag).max())) / float(np.abs(ref).max())
        report["s1_rel_err"][f"B={b} n={n}"] = rel
        print(f"  fused_fft_lm             B={b} n={n} vs float64: rel err {rel:.3e} gate {gate(n):.3e} "
              f"{'ok' if rel <= gate(n) else 'FAIL'}")
        if not rel <= gate(n):
            fail(f"fused_fft_lm B={b} n={n}: error {rel:.3e} against float64 over {gate(n):.3e}")
        del x, got
        torch.cuda.synchronize()

    # S4 at each k and S5, at the scripts' (8, 128) tile, bit for bit: a
    # table left out (t * 2^-24) or the scale left out (x * 2^-20) is well
    # under 1e-5 of max|plain|.
    probe_x = randn(8, 128)
    probe_tables = [randn(128, 128) for _ in range(max(Pr.PROBE_KS))]
    for k in Pr.PROBE_KS:
        compare("operand_probe", f"k={k} (8, 128)", (Pr.operand_probe(probe_x, probe_tables[:k]),),
                (Pr.operand_probe_plain(probe_x, probe_tables[:k]),), exact=True)
    compare("copy_min", "(8, 128)", (Pr.copy_min(probe_x),), (Pr.copy_min_plain(probe_x),), exact=True)
    torch.cuda.synchronize()

    # ── Phase 3: the main path through the public API ───────────────────────
    stamp("phase 3")
    print("phase 3: main path on device='cuda' (gate 5*log2(N)*eps)")
    K.reset_counts()
    rng = np.random.default_rng(0)

    def check(label, n, err, limit):
        report["main_path"].append(dict(case=label, n=n, err=err, limit=limit, ok=err <= limit))
        print(f"  {label:44s} err {err:.3e} limit {limit:.3e} {'ok' if err <= limit else 'FAIL'}")
        if not err <= limit:
            fail(f"{label}: error {err:.3e} over {limit:.3e}")

    def launches():
        return {k: c.launches for k, c in K.COUNTS.items()}

    # The reference demo: 15 Hz sine at 200 Hz for 5 s, padded 1000 -> 1024.
    wave = gt.generate_sine_wave(15.0, 200.0, 5.0)
    re, im = gt.fft(wave, device="cuda")
    n = len(re)
    p = gt.psd(re, im)
    freqs = gt.calculate_one_sided_frequencies(n, 200.0)
    dominant = gt.find_dominant_frequencies(p[: n // 2 + 1], freqs, threshold=100.0)
    print(f"  demo: {len(wave)} samples -> {n} bins; dominant {[(round(f, 2), round(w, 2)) for f, w in dominant]}")
    if len(dominant) != 1 or f"{dominant[0][0]:.2f}" != "15.04":
        fail(f"demo: dominant frequencies {dominant}, expected one at 15.04 Hz")
    back = gt.ifft(re, im, device="cuda")
    check("demo roundtrip n=1024", n, float(np.abs(back[: len(wave)] - wave).max()), gate(n))
    report["demo_dominant_hz"] = dominant[0][0]

    per_size = {}
    for n in (1024, 4096, 16384, 65536, 1 << 20, 1 << 22):
        before = launches()
        x = rng.standard_normal(n).astype(np.float32)
        re, im = gt.fft(x, device="cuda")
        ref = np.fft.fft(x.astype(np.float64))
        peak = float(np.abs(ref).max())
        check(f"fft n={n} vs numpy f64 (rel)", n,
              max(float(np.abs(re - ref.real).max()), float(np.abs(im - ref.imag).max())) / peak, gate(n))
        vr, vi = gt.fft(x, backend=gt.Backend.TORCH_FFT, device="cuda")
        check(f"fft n={n} vs torch.fft (rel)", n,
              max(float(np.abs(re - vr).max()), float(np.abs(im - vi).max())) / peak, gate(n))
        out = gt.ifft(re, im, device="cuda")
        check(f"ifft(fft) n={n} roundtrip", n, float(np.abs(out[:n] - x).max()), gate(n))
        vout = gt.ifft(re, im, backend=gt.Backend.TORCH_FFT, device="cuda")
        check(f"ifft n={n} vs torch.fft", n, float(np.abs(out - vout).max()), gate(n))
        after = launches()
        per_size[n] = {k: after[k] - before[k] for k in after}

    for b, n, inverse in ((16, 65536, False), (64, 4096, True)):
        xs = rng.standard_normal((b, n)).astype(np.float32)
        specs = gt.fft_batch(list(xs), device="cuda")
        ref = np.fft.fft(xs.astype(np.float64), axis=-1)
        peak = float(np.abs(ref).max())
        err = max(max(float(np.abs(r - ref[i].real).max()), float(np.abs(s - ref[i].imag).max()))
                  for i, (r, s) in enumerate(specs)) / peak
        check(f"fft_batch B={b} n={n} vs numpy f64 (rel)", n, err, gate(n))
        vs = gt.fft_batch(list(xs), backend=gt.Backend.TORCH_FFT, device="cuda")
        err = max(max(float(np.abs(r - vr).max()), float(np.abs(s - vi).max()))
                  for (r, s), (vr, vi) in zip(specs, vs)) / peak
        check(f"fft_batch B={b} n={n} vs torch.fft (rel)", n, err, gate(n))
        if inverse:
            outs = gt.ifft_batch(specs, device="cuda")
            check(f"ifft_batch B={b} n={n} roundtrip", n,
                  max(float(np.abs(o[:n] - x).max()) for o, x in zip(outs, xs)), gate(n))
            vouts = gt.ifft_batch(specs, backend=gt.Backend.TORCH_FFT, device="cuda")
            check(f"ifft_batch B={b} n={n} vs torch.fft", n,
                  max(float(np.abs(o - v).max()) for o, v in zip(outs, vouts)), gate(n))

    main_launches = {k: v for k, v in launches().items() if k in MAIN_PATH_KERNELS}
    print(f"  launches in phase 3: {main_launches}")
    print(f"  launches per size: {per_size}")
    report["launches"] = main_launches
    report["launches_per_size"] = {str(k): v for k, v in per_size.items()}
    need = [("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384),
            ("stage_a", 1 << 20), ("stage_a", 1 << 22)]
    for name, n in need:
        if per_size[n][name] < 1:
            fail(f"{name} was not launched by the main path at n={n}")
    for name, count in main_launches.items():
        if count < 1:
            fail(f"{name} was launched no time on the main path")

    # Real input: rfft against numpy's (the forward path above).
    for n in IRFFT_SIZES:
        x = rng.standard_normal(n).astype(np.float32)
        re, im = gt.rfft(x, device="cuda")
        ref = np.fft.rfft(x.astype(np.float64))
        check(f"rfft n={n} vs numpy f64 (rel)", n,
              max(float(np.abs(re - ref.real).max()), float(np.abs(im - ref.imag).max()))
              / float(np.abs(ref).max()), gate(n))

    # This slice's path, real output, counted on its own.  The input is an
    # rfft spectrum rounded to fp32; the references take that same input.
    K.reset_counts()
    irfft_per_size = {}

    def one_sided(b, n):
        x = rng.standard_normal((b, n))
        sp = np.fft.rfft(x, axis=-1)
        sr, si = sp.real.astype(np.float32), sp.imag.astype(np.float32)
        ref = np.fft.irfft(sr.astype(np.float64) + 1j * si.astype(np.float64), n=n, axis=-1)
        sr_t, si_t = torch.from_numpy(sr).to(dev), torch.from_numpy(si).to(dev)
        vref = torch.fft.irfft(torch.complex(sr_t, si_t), n=n, dim=-1).cpu().numpy()
        return sr, si, sr_t, si_t, ref, vref

    for n in IRFFT_SIZES:
        sr, si, sr_t, si_t, ref, vref = one_sided(1, n)
        peak = float(np.abs(ref).max())
        before = launches()
        y = gt.irfft_device(sr_t[0], si_t[0]).cpu().numpy()
        yh = gt.irfft(sr[0], si[0], device="cuda")
        after = launches()
        irfft_per_size[n] = {k: after[k] - before[k] for k in MAIN_PATH_KERNELS}
        check(f"irfft_device n={n} vs numpy f64 (rel)", n, float(np.abs(y - ref[0]).max()) / peak, gate(n))
        check(f"irfft_device n={n} vs torch.fft.irfft (rel)", n, float(np.abs(y - vref[0]).max()) / peak, gate(n))
        check(f"irfft n={n} vs numpy f64 (rel)", n, float(np.abs(yh - ref[0]).max()) / peak, gate(n))
        check(f"irfft n={n} vs torch.fft.irfft (rel)", n, float(np.abs(yh - vref[0]).max()) / peak, gate(n))
        del sr_t, si_t
    for b, n in IRFFT_BATCHES:
        sr, si, sr_t, si_t, ref, vref = one_sided(b, n)
        peak = float(np.abs(ref).max())
        y = gt.irfft_device(sr_t, si_t).cpu().numpy()
        check(f"irfft_device B={b} n={n} vs numpy f64 (rel)", n, float(np.abs(y - ref).max()) / peak, gate(n))
        check(f"irfft_device B={b} n={n} vs torch.fft.irfft (rel)", n,
              float(np.abs(y - vref).max()) / peak, gate(n))
    irfft_launches = {k: v for k, v in launches().items() if k in MAIN_PATH_KERNELS}
    print(f"  launches on the irfft path: {irfft_launches}")
    print(f"  irfft launches per size (irfft_device + irfft): {irfft_per_size}")
    report["irfft_launches"] = irfft_launches
    report["irfft_launches_per_size"] = {str(k): v for k, v in irfft_per_size.items()}
    need = [("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384),
            *(("stage_a", n) for n in (1 << 17, 1 << 20, 1 << 22, 1 << 24))]
    for name, n in need:
        if irfft_per_size[n][name] < 1:
            fail(f"{name} was not launched by the irfft path at n={n}")

    # ── Phase 4: warm median times (CUDA events) ────────────────────────────
    stamp("phase 4")
    print(f"phase 4: warm medians, CUDA events ({smi})")
    kernel_ms = {}

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def time_pair(label, name, kern_fn, plain_fn, bnd, lib_fn=None):
        """Kernel, plain version and (where one exists) the library call:
        event and profiler times, and the kernel's share of its bound."""
        k_ms, p_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        (k_dev, _), (p_dev, _) = device_ms(kern_fn), device_ms(plain_fn)
        lib_ms, lib_dev = (cuda_ms(lib_fn), device_ms(lib_fn)[0]) if lib_fn else (None, None)
        share = None if k_dev is None else bnd[0] / k_dev
        rec = dict(what=label, kernel=name, ms=k_ms, plain_ms=p_ms, device_ms=k_dev,
                   plain_device_ms=p_dev, bound_ms=bnd[0], bound_by=bnd[1], share_of_bound=share,
                   library_ms=lib_ms, library_device_ms=lib_dev)
        report["times"].append(rec)
        print(f"  {label:44s} events: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms"
              + (f" library {lib_ms:.4f} ms" if lib_fn else "")
              + f" | device: kernel {fmt(k_dev)} plain {fmt(p_dev)}"
              + (f" library {fmt(lib_dev)}" if lib_fn else "")
              + f" | bound {bnd[0] * 1e3:.2f} us ({bnd[1]})"
              + ("" if share is None else f", {share * 100:.1f}% of bound"))
        kernel_ms.setdefault(name, rec)
        return rec

    for name, n in (("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384)):
        make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
        fwd = P.on_device(make_plan, n, -1, None, device=dev)
        inv = P.on_device(make_plan, n, 1, 1.0 / n, device=dev)
        x, xi = randn(1, n), randn(1, n)
        z = torch.complex(x, xi)
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        time_pair(f"{name} B=1 n={n} real fwd", name,
                  lambda: kern(x, None, fwd), lambda: plain(x, None, fwd),
                  whole_bound(n, False), lambda: torch.fft.fft(x))
        time_pair(f"{name} B=1 n={n} complex inv 1/n", name,
                  lambda: kern(x, xi, inv), lambda: plain(x, xi, inv),
                  whole_bound(n, True), lambda: torch.fft.ifft(z))
    for n in (1 << 20, 1 << 22):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        x = randn(1, n1, n2)
        time_pair(f"stage_a n={n} real rows={rows}", "stage_a",
                  lambda: K.stage_a(x, None, n1, n2, plan, ct, rows=rows),
                  lambda: K.stage_a_plain(x, None, n1, n2, plan, ct, rows=rows),
                  stage_a_bound(n1, n2, rows, False, ct))
        # Complex input, all rows, the inverse plan: the ifft path.
        inv = P.on_device(P.get_stage_a_plan, n, 1, ct, device=dev)
        xi = randn(1, n1, n2)
        time_pair(f"stage_a n={n} complex inv", "stage_a",
                  lambda: K.stage_a(x, xi, n1, n2, inv, ct),
                  lambda: K.stage_a_plain(x, xi, n1, n2, inv, ct),
                  stage_a_bound(n1, n2, n1, True, ct))
        del xi
        # K3-legacy at the same shape and rows: the materialized twiddle's
        # extra read against the factored one.
        legacy = P.on_device(ablate_large.make_plan, n, n1, -1, device=dev)
        lct = P.stage_a_col_tile(n1, n2)
        if n == 1 << 20:  # all rows: the shape S2 computes
            time_pair(f"stage_a_legacy n={n} real all rows", "stage_a_legacy",
                      lambda: K.stage_a(x, None, n1, n2, legacy, lct),
                      lambda: K.stage_a_plain(x, None, n1, n2, legacy, lct),
                      dense_stage_a_bound(n1, n2, n1, 2 * n1 * n2))
            x2 = x[0]
            time_pair(f"stage_a_manual n={n} real", "stage_a_manual",
                      lambda: A.stage_a_manual(x2, legacy), lambda: A.stage_a_manual_plain(x2, legacy),
                      dense_stage_a_bound(n1, n2, n1, 2 * n1 * n2))
        time_pair(f"stage_a_legacy n={n} real rows={rows}", "stage_a_legacy",
                  lambda: K.stage_a(x, None, n1, n2, legacy, lct, rows=rows),
                  lambda: K.stage_a_plain(x, None, n1, n2, legacy, lct, rows=rows),
                  dense_stage_a_bound(n1, n2, rows, 2 * rows * n2))
        del x
    # K3 on the irfft path's column tiles (complex, sign +1, ct = 512), and
    # at ct = 2,048 beside it (3 of 4 and 9 of 16 tiles at 2^20 and 2^22).
    for n, ct in (*((n, 512) for n in IRFFT_STAGED), (1 << 20, 2048), (1 << 22, 2048)):
        plan = P.on_device(P.get_stage_a_plan, n, 1, ct, device=dev)
        n1, n2 = plan["n1"], plan["n2"]
        tiles = -(-(n2 // 2 + 1) // ct)
        xr, xi = randn(1, n1, n2), randn(1, n1, n2)
        time_pair(f"stage_a n={n} inv col_tiles={tiles}/{n2 // ct} ct={ct}", "stage_a",
                  lambda: K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles),
                  lambda: K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles),
                  stage_a_bound(n1, n2, n1, True, ct, ncols=tiles * ct))
        del xr, xi
    # S3's one-call yardsticks: f32, torch.matmul on the stacked LHS; x1,
    # torch.mm of the bf16 operands into fp32 (x rounded outside the timed
    # region); x6 has none.
    s3_cat = torch.cat([s3_tables["fr"], s3_tables["fi"]])
    s3_cat_bf, s3_x_bf = s3_cat.to(torch.bfloat16), s3_x[0].to(torch.bfloat16)
    s3_library = {"f32_highest": lambda: torch.matmul(s3_cat, s3_x[0]),
                  "bf16_x1": lambda: torch.mm(s3_cat_bf, s3_x_bf, out_dtype=torch.float32)}
    report["s3_library_refused"] = {}
    try:
        s3_library["bf16_x1"]()
    except (TypeError, RuntimeError) as e:  # a torch without mm's out_dtype
        report["s3_library_refused"]["bf16_x1"] = f"none: {type(e).__name__}: {e}"
        del s3_library["bf16_x1"]
    for v in A.VARIANTS:
        time_pair(f"stage_a_dot_{v} (1, {n1_s3}, {n2_s3})", f"stage_a_dot_{v}",
                  lambda v=v: A.stage_a_dot(s3_x, s3_tables, v),
                  lambda v=v: A.stage_a_dot_plain(s3_x, s3_tables, v),
                  dot_bound(n1_s3, n2_s3, v), s3_library.get(v))

    for b, n in ((1, 65536), (16, 65536)):
        t = P.on_device(E.lm_tables, n, -1, device=dev)
        x = randn(b, n)
        time_pair(f"fused_fft_lm B={b} n={n} real fwd", "fused_fft_lm",
                  lambda: E.fused_fft_lm(x, t), lambda: E.fused_fft_lm_plain(x, t),
                  lm_bound(b, n, t["n1"], t["n2"]), lambda: torch.fft.fft(x))
        del x
    time_pair("operand_probe k=8 (8, 128)", "operand_probe",
              lambda: Pr.operand_probe(probe_x, probe_tables), lambda: Pr.operand_probe_plain(probe_x, probe_tables),
              probe_bound(8))
    time_pair("copy_min (8, 128)", "copy_min", lambda: Pr.copy_min(probe_x), lambda: Pr.copy_min_plain(probe_x),
              probe_bound(0), lambda: probe_x * Pr.SCALE)

    for b, n in ((1, 1024), (1, 4096), (1, 16384), (1, 32768), (1, 65536), (1, 1 << 20), (1, 1 << 22),
                 (16, 65536), (64, 4096)):
        x = randn(b, n)
        yr, yi = gt.fft_device(x)
        fwd = cuda_ms(lambda: gt.fft_device(x))
        vfwd = cuda_ms(lambda: gt.fft_device(x, backend=gt.Backend.TORCH_FFT))
        inv = cuda_ms(lambda: gt.ifft_device(yr, yi))
        vinv = cuda_ms(lambda: gt.ifft_device(yr, yi, backend=gt.Backend.TORCH_FFT))
        fdev, ftop = device_ms(lambda: gt.fft_device(x))
        idev, itop = device_ms(lambda: gt.ifft_device(yr, yi))
        vfdev, _ = device_ms(lambda: gt.fft_device(x, backend=gt.Backend.TORCH_FFT))
        report["times"].append(dict(what=f"fft_device B={b} n={n}", ms=fwd, torch_fft_ms=vfwd,
                                    device_ms=fdev, torch_fft_device_ms=vfdev, top_kernels=ftop))
        report["times"].append(dict(what=f"ifft_device B={b} n={n}", ms=inv, torch_fft_ms=vinv,
                                    device_ms=idev, top_kernels=itop))
        print(f"  fft_device  B={b:<3d} n={n:<8d} events: port {fwd:.4f} ms torch.fft {vfwd:.4f} ms | "
              f"device: port {fmt(fdev)} torch.fft {fmt(vfdev)}")
        print(f"  ifft_device B={b:<3d} n={n:<8d} events: port {inv:.4f} ms torch.fft {vinv:.4f} ms | "
              f"device: port {fmt(idev)}")
        print(f"    fft top kernels: {[(k, round(v, 4)) for k, v in ftop]}")
        if (b, n) in IRFFT_TIMED:
            hr, hi = (t.contiguous() for t in gt.rfft_device(x))
            zh = torch.complex(hr, hi)
            irf = cuda_ms(lambda: gt.irfft_device(hr, hi))
            virf = cuda_ms(lambda: torch.fft.irfft(zh, n=n))
            irdev, irtop = device_ms(lambda: gt.irfft_device(hr, hi), top=8)
            virdev, _ = device_ms(lambda: torch.fft.irfft(zh, n=n))
            report["times"].append(dict(what=f"irfft_device B={b} n={n}", ms=irf, torch_fft_irfft_ms=virf,
                                        device_ms=irdev, torch_fft_irfft_device_ms=virdev,
                                        ifft_device_ms=inv, ifft_device_device_ms=idev, top_kernels=irtop))
            print(f"  irfft_device B={b:<3d} n={n:<8d} events: port {irf:.4f} ms torch.fft.irfft {virf:.4f} ms"
                  f" (ifft_device {inv:.4f}) | device: port {fmt(irdev)} torch.fft.irfft {fmt(virdev)}"
                  f" (ifft_device {fmt(idev)})")
            print(f"    irfft top kernels: {[(k, round(v, 4)) for k, v in irtop]}")

    # ── Phase 5: the second path, the stage-A ablation harnesses ────────────
    stamp("phase 5")
    print("phase 5: stage-A ablation harnesses, quick setting (device times from CUDA graphs)")
    K.reset_counts()
    A.reset_counts()
    large_res = ablate_large.main(quick=True, out_dir=str(out_dir))
    levers_res = ablate_2e20_levers.main(quick=True, out_dir=str(out_dir))
    x6_res = ablate_mosaic_x6.main(quick=True, out_dir=str(out_dir))
    second_launches = {k: c.launches for k, c in {**K.COUNTS, **A.COUNTS}.items()
                       if k not in MAIN_PATH_KERNELS}
    print(f"  launches in phase 5: {second_launches}")
    report.update(launches_phase5=second_launches, ablate_large=large_res,
                  ablate_2e20_levers=levers_res, ablate_mosaic_x6=x6_res)
    for name, count in second_launches.items():
        if count < 1:
            fail(f"{name} was launched no time by the stage-A harnesses")
    bad = ablate_2e20_levers.unexpected_errors(levers_res)
    if bad:
        fail(f"ablate_2e20_levers rows failed: {bad}")
    off = ablate_2e20_levers.parity_failures(levers_res)
    if off:
        fail(f"ablate_2e20_levers rows over parity {ablate_2e20_levers.PARITY_LIMIT:.3e}: {off}")
    times = [e["us"] for e in large_res["entries"]]
    times += [r["us"] for r in levers_res["rows"].values() if "us" in r]
    times += [r["us_per_call"] for r in x6_res["rows"]]
    if not all(np.isfinite(t) and t > 0 for t in times):
        fail(f"a harness time is not a positive number: {times}")
    for r in x6_res["rows"]:
        if r["variant"] != "bf16_x1" and not r["rel_err"] <= s3_gate:
            fail(f"ablate_mosaic_x6 ct={r['ct']} {r['variant']}: rel_err {r['rel_err']:.3e} over {s3_gate:.3e}")
    print("  harnesses: every row measured and within parity; no error rows")

    # ── Phase 6: the third path, the calibration scripts ────────────────────
    stamp("phase 6")
    print("phase 6: calibration scripts, quick setting (device times from CUDA graphs)")
    for mod in (K, A, E, Pr):
        mod.reset_counts()
    lat_res = calibrate_latency.main(quick=True, out_dir=str(out_dir))
    mm_res = calibrate_matmul.main(quick=True, out_dir=str(out_dir))
    wp_res = ablate_whole_packed.main(quick=True, out_dir=str(out_dir))
    eng_res = ablate_engines.main(quick=True, out_dir=str(out_dir))
    chip_res = calibrate_chip.main(quick=True, out_dir=str(out_dir))
    third_launches = {k: c.launches for k, c in {**K.COUNTS, **E.COUNTS, **Pr.COUNTS}.items()
                      if k in CALIBRATION_PATH_KERNELS}
    print(f"  launches in phase 6: {third_launches}")
    report.update(launches_phase6=third_launches, calibrate_latency=lat_res, calibrate_matmul=mm_res,
                  ablate_whole_packed=wp_res, ablate_engines=eng_res, calibrate_chip=chip_res)
    for name, count in third_launches.items():
        if count < 1:
            fail(f"{name} was launched no time by the calibration scripts")
    bad = ablate_engines.unexpected_errors(eng_res)
    if bad:
        fail(f"ablate_engines rows failed: {bad}")
    off = {"ablate_engines": ablate_engines.accuracy_failures(eng_res),
           "ablate_whole_packed": ablate_whole_packed.parity_failures(wp_res)}
    if any(off.values()):
        fail(f"calibration rows over 5*log2(n)*eps: {off}")
    if chip_res["oa_block"] != {"error": calibrate_chip.NOT_PORTED}:
        fail("calibrate_chip: the unported oa_block section holds something else than 'not ported'")
    if not chip_res["irfft_fold"]:
        fail("calibrate_chip: the irfft fold gate measured nothing")
    times = [r["per_call_us"] for r in lat_res["rows"].values()]
    times += [r["unchained_us"][q] for r in lat_res["rows"].values() for q in ("median", "min")]
    times += [r["per_step_us"] for r in lat_res["launch_chain"].values()]
    times += [c[k] for c in mm_res["classes"].values() for k in ("us_d1", "us_d2", "marginal_us", "tflops")]
    times += [p["us"] for p in mm_res["patterns"].values()]
    times += list(wp_res["operand_probe"].values())
    times += [r[k] for r in wp_res["rows"] for k in ("w1_us", "w2_us", "folded_us")]
    times += [e["best_us"] for e in eng_res["entries"] if e["group"] == "engine" and "error" not in e]
    times += [r[k] for r in chip_res["wide_split"] for k in ("balanced_us", "wide_us")]
    times += [r["us"] for r in chip_res["stage_a_digit"]]
    times += [r[k] for r in chip_res["half_spectrum"] for k in ("full_us", "half_us")]
    times += [r[k] for r in chip_res["irfft_fold"] for k in ("full_us", "fold_us")]
    if not all(np.isfinite(t) and t > 0 for t in times):
        fail(f"a calibration time is not a positive number: {times}")
    for name, row in lat_res["roofline"].items():
        if row["n_kernels"] < 1 or not row["sol_us"] > 0:
            fail(f"calibrate_latency roofline row {name} is empty: {row}")
    print(f"  calibration: {len(times)} timed values, all positive; parity within 5*log2(n)*eps; "
          f"no error rows but the retired ones and the unported overlap-add block")

    sources = {
        "whole_transform_packed": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:383"),
        "whole_transform": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:424"),
        "stage_a": ("gpu_fft_tpu_torch/csrc/stage_a.cu", "gpu_fft_tpu/kernels/fused.py:188"),
        "stage_a_legacy": ("gpu_fft_tpu_torch/csrc/stage_a.cu", "gpu_fft_tpu/kernels/fused.py:153"),
        "stage_a_manual": ("gpu_fft_tpu_torch/csrc/stage_a_manual.cu", "scripts/ablate_2e20_levers.py:188"),
        **{f"stage_a_dot_{v}": ("gpu_fft_tpu_torch/csrc/stage_a_dot.cu", "scripts/ablate_mosaic_x6.py:105")
           for v in A.VARIANTS},
        "fused_fft_lm": ("gpu_fft_tpu_torch/csrc/fused_lm.cu", "scripts/ablate_engines.py:111"),
        "operand_probe": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/ablate_whole_packed.py:66"),
        "copy_min": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/calibrate_latency.py:79"),
    }
    # The main path's launches: fft/ifft and the real-output path together.
    all_launches = {**{k: main_launches[k] + irfft_launches[k] for k in MAIN_PATH_KERNELS},
                    **second_launches, **{k: third_launches[k] for k in CALIBRATION_KERNELS}}
    kernels = []
    for name, (src, rep) in sources.items():
        t = kernel_ms[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=all_launches[name],
            irfft_path_launches=irfft_launches.get(name, 0),
            max_abs_err=max_err[name], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"], device_ms=t["device_ms"],
            plain_device_ms=t["plain_device_ms"], library_device_ms=t["library_device_ms"],
            timed=t["what"],
        ))
        refused = report["s3_library_refused"].get(name.removeprefix("stage_a_dot_"))
        if refused:
            kernels[-1]["library_refused"] = refused
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    stamp("end")
