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
   2^18 … 2^24 for ct = 512, 1,024, 2,048); K3-legacy (K3's radix kernel
   reading a materialized twiddle) at every ablate_large shape and in its
   complex, rows and col_tiles forms, S2 at n1 = 32, 128 and 256, and S3 of
   the stage-A ablation harnesses, with S3's error against float64 (gate
   for f32 and bf16_x6: 5*log2(n1)*eps; bf16_x1 printed);
3. the main path through the public API on ``device="cuda"``: the sine ->
   fft -> psd -> dominant frequency -> ifft demo, fft/ifft from n = 1024 to
   2^22, fft_batch and ifft_batch, each checked against numpy in float64 with
   the 5*log2(N)*eps gate and against torch.fft; the launch counts show each
   kernel ran.  Then this slice's path, real input and output, with the
   counts set to 0 before it: rfft against numpy's, irfft_device and irfft
   against numpy's irfft (float64) and torch.fft.irfft from n = 256 to 2^24,
   irfft_device at (16, 65,536) and (64, 4,096); its counts show K2, K1 and
   K3 ran where the dispatch sends them;
3b. gradients through the autograd seams, counted from 0: the Parseval
   gradient of fft_device at (1, n), n = 1,024 … 2^22 (gate 2*5*log2(n)*eps,
   exactly two launches of the band's kernel a grad, no plain call), dot
   tests of transform_any, inverse_real and irfft_device (1e-4, inner
   products in float64), torch.func.jvp (1e-4) and Welch's gradient at 2^20
   against a central difference (5e-3);
3c. the spectral path at full size, counted from 0, against scipy.signal
   and numpy in float64 with the JAX package's tests' gates: welch (mean
   and median), csd, coherence, spectrogram_scipy, stft_scipy /
   istft_scipy, the STFT roundtrip, ShortTimeFFT, periodogram (2^22 on K3,
   48,000 mixed, 1,000,003 Bluestein with two K3 launches) and
   fft_exact / ifft_exact; the engine each estimator's transform took;
3d. the filtering path at full size, counted from 0, against scipy.signal
   / scipy.fft in float64 with the JAX package's tests' gates:
   oaconvolve_device, fftfilt_device (8, 2^20) * 1,025 taps, filtfilt_fir,
   fft_convolve_device at m = 2^21 (three K3 launches), FIRStream (256
   chunks of 4,096, 257 taps, K1 twice a step), lfilter_device and
   sosfiltfilt (8, 2^20), resample_poly_device 3/2, decimate (iir, fir),
   hilbert_device 2^20 (two K3), resample_device, dct/idct at (1, 2^20)
   (one K3 each) and (64, 4,096), types 1/3/4 and DSTs at 48,000, czt at
   2^16 (two K3) and 1,000 (two K1), zoom_fft, fht / ifht at 2^20 and
   10,000; each row's launches, no plain call;
4. warm median times with CUDA events (back-to-back calls, host included)
   and device times from torch.profiler (the kernels alone): each kernel
   against its plain version, its bound on the card and, where one exists,
   the one PyTorch call that computes the same function (K1 and K2 on real
   forward and on complex inverse input, beside torch.fft.fft and
   torch.fft.ifft; K3 at 2^20 and 2^22 on real input with the real path's
   rows and on complex input with the inverse plan, the ifft path, and on
   the irfft path's column tiles; K3-legacy at 2^20 on real and complex
   input, all rows, and at the real path's rows, against the radix bound
   and, beside it, the JAX bodies' dense (Karatsuba) count, its device
   time also with L2 flushed before each call (the time its shares of
   those bounds read: at 2^20 its inputs fit in L2); S2 at 2^20;
   S3 f32 beside torch.matmul on the
   stacked LHS, S3 bf16_x1 beside torch.mm of the bf16 operands into fp32,
   or the refusal's text where torch has no out_dtype); each main-path call
   against torch.fft, irfft_device beside ifft_device and
   torch.fft.irfft, and this slice's calls (a Parseval grad step, welch,
   the STFT roundtrip, periodogram, fft_exact) beside their torch
   counterparts, and the filtering rows (oaconvolve, fftfilt, FIRStream.step,
   lfilter, resample_poly, hilbert, the DCT-II/III roundtrip) beside theirs
   on torch.fft where torch has one;
5. the second path: the three stage-A ablation harnesses
   (``python -m gpu_fft_tpu_torch.scripts.<name>``) in their quick setting;
   the launch counts show K3-legacy, S2 and S3 ran, no row holds an error,
   and every timed levers row (the L4 irfft rows too) agrees with its
   reference row within 5*log2(2^22)*eps;
6. the third path, calibration: ``calibrate_latency``, ``calibrate_matmul``,
   ``ablate_whole_packed``, ``ablate_engines`` and ``calibrate_chip`` in
   their quick setting; the launch counts show S1, S4 and S5 (and K1, K2,
   K3) ran, every timed row is a positive number (the irfft fold gate's
   too, and the overlap-add block section's), the only rows without a
   time are the retired ones, and every parity row is within
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
# Phase 3b: the Parseval gradient at (1, n) and the kernel whose band n is
# (None: the torch engines, the control); dot tests; forward mode.
GRAD_SIZES = ((1024, "whole_transform_packed"), (4096, "whole_transform"), (16384, "whole_transform"),
              (65536, None), (1 << 20, "stage_a"), (1 << 22, "stage_a"))
DOT_TRANSFORM = ((1, 4096), (2, 1 << 20))
DOT_INVERSE_REAL = (1, 1 << 20)
DOT_IRFFT = (4, 1 << 22)
JVP_SIZES = (4096, 1 << 20)
WELCH_GRAD = (1 << 20, 4096)
# Phase 3c: the spectral path at full size.
WELCH_SHAPE = (8, 1 << 20, 4096, 2048)  # channels, samples, nperseg, noverlap
PAIR_SHAPE = (1 << 20, 4096)  # csd / coherence: samples, nperseg
SPEC_SHAPE = (1 << 20, 1024, 768)  # spectrogram / stft_scipy: samples, nperseg, noverlap
STFT_SHAPES = ((1 << 20, 1024, 256), (16384, 256, 64))  # samples, frame, hop
PERIODOGRAM_SIZES = (1 << 22, 48000, 1000003)
EXACT_SIZES = (48000, 1000003)
# Phase 3d: the filtering path at full size.
FILTER_ROWS = (8, 1 << 20)  # oaconvolve / fftfilt / lfilter / sosfiltfilt / resample_poly
FIR_TAPS = 1025
STREAM = (256, 4096, 257)  # chunks, chunk, taps


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


def stage_a_bound(n1: int, n2: int, rows: int, complex_: bool, ct: int | None, ncols: int | None = None):
    """K3 and K3-legacy (the same radix kernel), B = 1, on the first
    ``ncols`` (default n2) columns: a radix-2 FFT's 5 n1 log2 n1 FLOP per
    column and 6 per stored output for the twiddle (K3's factored one is
    rebuilt: 6 more); those columns of x (both parts for complex input), the
    n1-point root row and the twiddle's rows read once (K3: two (rows,
    ncols/ct) and twi (rows, ct); K3-legacy, ``ct`` None: the materialized
    (rows, ncols)), the output written once."""
    ncols = n2 if ncols is None else ncols
    flop = 5 * n1 * (n1.bit_length() - 1) * ncols + (6 if ct is None else 12) * rows * ncols
    twiddle = rows * ncols if ct is None else rows * (ncols // ct + ct)
    nbytes = 4 * ((2 if complex_ else 1) * n1 * ncols + 2 * n1 + 2 * twiddle + 2 * rows * ncols)
    return bound(flop, "fp32", nbytes)


def dense_stage_a_bound(n1: int, n2: int, rows: int, complex_: bool = False):
    """K3-legacy and S2 as the JAX bodies compute them (``fused.py:153``,
    ``:162``), B = 1, all columns: real input rows x n1 x n2 products by Fr
    and by Fi; complex input the Karatsuba three (Fr (xr + xi), Fd xr,
    Fs xi) with their adds; 6 FLOP per output for the twiddle.  x, F1's rows
    (two tables, three for Karatsuba) and the materialized twiddle read
    once, the output written once."""
    products = 3 if complex_ else 2
    flop = 2 * products * rows * n1 * n2 + 6 * rows * n2
    if complex_:
        flop += n1 * n2 + 2 * rows * n2
    nbytes = 4 * ((2 if complex_ else 1) * n1 * n2 + products * rows * n1 + 4 * rows * n2)
    return bound(flop, "fp32", nbytes)


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


def device_ms(fn, iters: int = 20, attempts: int = 3, top: int = 4, match: str = ""):
    """Device time per call (ms) summed over the CUDA kernels torch.profiler
    records for ``iters`` warm calls whose name holds ``match``, and the
    ``top`` kernels by time.  A profile that comes back with no such kernel
    is taken again, up to ``attempts`` times; None where none of them
    records one."""
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
            if us > 0 and match in e.key:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / iters / 1000.0
        if by_name:
            break
    if not by_name:
        return None, []
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [(k[:60], v) for k, v in ranked]


def capture_launches(large) -> tuple[dict, object]:
    """Wraps the dispatch's kernel entries (``large.stage_a``,
    ``large.whole_transform``, ``large.whole_transform_packed``) so that the
    first input of every distinct launch geometry is kept, cloned: (kernel,
    input shape, real or complex, plan, tile arguments) -> (xr, xi, args,
    kwargs).  The counts are the wrapped kernels' own.  Returns the dict and
    a function that puts the entries back."""
    seen = {}
    originals = {name: getattr(large, name) for name in MAIN_PATH_KERNELS}

    def wrap(name, fn):
        def call(xr, xi, *args, **kw):
            key = (name, tuple(xr.shape), xi is None,
                   *(id(a) if isinstance(a, dict) else a for a in args), *sorted(kw.items()))
            if key not in seen:
                seen[key] = (xr.clone(), None if xi is None else xi.clone(), args, kw)
            return fn(xr, xi, *args, **kw)

        return call

    for name, fn in originals.items():
        setattr(large, name, wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(large, name, fn)

    return seen, restore


def record(report: dict, key: str, label: str, n: int, err: float, limit: float) -> None:
    """Print one gated error, keep it under ``report[key]`` and fail past
    its limit."""
    report.setdefault(key, []).append(dict(case=label, n=n, err=err, limit=limit, ok=err <= limit))
    print(f"  {label:52s} err {err:.3e} limit {limit:.3e} {'ok' if err <= limit else 'FAIL'}")
    if not err <= limit:
        fail(f"{label}: error {err:.3e} over {limit:.3e}")


def counts() -> dict:
    """(launches, plain_calls) of each transform-path kernel."""
    from gpu_fft_tpu_torch.kernels import fused as K

    return {k: (c.launches, c.plain_calls) for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}


def count_delta(before: dict) -> tuple[dict, int]:
    """Launches per kernel since ``before``, and plain calls in all."""
    after = counts()
    return ({k: after[k][0] - before[k][0] for k in after},
            sum(after[k][1] - before[k][1] for k in after))


def band_kernel(b: int, n: int):
    """The kernel ``kernels/large.py:transform_any`` launches for a (b, n)
    transform (K1, K2 or K3), or None where the torch engines run it."""
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import FUSED_MAX
    from gpu_fft_tpu_torch.tuning import get_tuning

    if n > FUSED_MAX:
        return "stage_a"
    if P.whole_kernel_applies(b, n):
        return "whole_transform_packed" if n <= get_tuning().whole_packed_n_max else "whole_transform"
    return None


def engine(b: int, n: int, real_input: bool) -> str:
    """The engine ``kernels/large.py:transform_any`` takes for a (b, n)
    transform: the band's kernel, a torch engine, or the staged path."""
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import DIRECT_MAX

    kernel = band_kernel(b, n)
    if kernel == "stage_a":
        return "staged: K3 + torch stage B"
    if kernel:
        return {"whole_transform_packed": "K2", "whole_transform": "K1"}[kernel]
    if n <= DIRECT_MAX:
        return "torch direct DFT"
    if real_input and P.half_spectrum_applies(n):
        return "torch four-step, half spectrum"
    folded = P.use_folded_layout(b, n)
    return (f"torch four-step, {'wide' if P.wide_split_applies(b, n) else 'balanced'} split, "
            f"{'folded' if folded else 'transposes'}")


def grad_phase(report: dict, dev, rng, grad_sizes=GRAD_SIZES, dot_transform=DOT_TRANSFORM,
               dot_inverse_real=DOT_INVERSE_REAL, dot_irfft=DOT_IRFFT, jvp_sizes=JVP_SIZES,
               welch_grad=WELCH_GRAD) -> dict:
    """Phase 3b: gradients through the autograd seams on the card.  Returns
    the launches of the phase (counted from 0) and per Parseval size."""
    import numpy as np
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels.large import inverse_real, transform_any

    def tensor(*shape, grad=False):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).requires_grad_(grad)

    def host(t):
        return t.detach().cpu().double().numpy()

    def power(yr, yi):
        return (yr * yr + yi * yi).sum()

    K.reset_counts()
    per_size = {}
    for n, kernel in grad_sizes:
        x = tensor(1, n, grad=True)
        before = counts()
        (g,) = torch.autograd.grad(power(*gt.fft_device(x)), x)
        torch.cuda.synchronize()
        launched, plain = count_delta(before)
        xs = host(x)
        record(report, "grad_path", f"grad Parseval n={n} ({engine(1, n, True)})", n,
               float(np.abs(host(g) - 2 * n * xs).max() / (2 * n * np.abs(xs).max())), 2 * gate(n))
        want = {k: 2 if k == kernel else 0 for k in launched}
        if launched != want or plain:
            fail(f"grad n={n}: launches {launched} and {plain} plain calls, expected {want} and none")
        per_size[n] = launched

    def dot_test(label, n, fn, ins, outs):
        v = [tensor(*s, grad=True) for s in ins]
        w = [tensor(*s) for s in outs]
        out = fn(*v)
        out = out if isinstance(out, tuple) else (out,)
        lhs = sum(float(np.vdot(host(o), host(ww))) for o, ww in zip(out, w))
        back = torch.autograd.grad(out, v, grad_outputs=w)
        rhs = sum(float(np.vdot(host(b), host(vv))) for b, vv in zip(back, v))
        record(report, "grad_path", f"dot test {label}", n, abs(lhs - rhs) / max(1.0, abs(lhs)), 1e-4)

    for b, n in dot_transform:
        for sign in (-1, 1):
            dot_test(f"transform_any ({b}, {n}) sign {sign:+d}", n,
                     lambda p, q, n=n, sign=sign: transform_any(p, q, n, sign), [(b, n)] * 2, [(b, n)] * 2)
    b, n = dot_inverse_real
    dot_test(f"inverse_real ({b}, {n})", n, lambda p, q: inverse_real(p, q, n), [(b, n)] * 2, [(b, n)])
    b, n = dot_irfft
    h = n // 2 + 1
    dot_test(f"irfft_device ({b}, {n})", n, gt.irfft_device, [(b, h)] * 2, [(b, n)])

    for n in jvp_sizes:
        x = tensor(1, n)
        out, tan = torch.func.jvp(lambda v: power(*gt.fft_device(v)), (x,), (x,))
        record(report, "grad_path", f"jvp Parseval n={n}: |tangent/out - 2|", n,
               abs(float(tan) / float(out) - 2.0), 1e-4)

    # Welch's gradient against a central difference.  The loss is a
    # quadratic form, so the difference is exact but for rounding: the
    # per-bin estimates are summed in float64.
    n, nperseg = welch_grad
    x, d = tensor(n, grad=True), tensor(n)
    (g,) = torch.autograd.grad(gt.welch_device(x, nperseg=nperseg)[1].sum(), x)
    eps = 1e-2
    with torch.no_grad():
        lp, lm = (float(gt.welch_device(x + s * eps * d, nperseg=nperseg)[1].double().sum()) for s in (1, -1))
    an = float(np.vdot(host(g), host(d)))
    record(report, "grad_path", f"grad welch n={n} nperseg={nperseg} vs central difference", n,
           abs((lp - lm) / (2 * eps) - an) / max(1.0, abs(an)), 5e-3)
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    plain = sum(c.plain_calls for c in K.COUNTS.values())
    print(f"  launches in phase 3b: {launched}; plain calls {plain}")
    print(f"  Parseval grad launches per size (forward + backward): {per_size}")
    if plain:
        fail(f"phase 3b ran {plain} plain kernel versions on the card")
    for name, count in launched.items():
        if count < 1:
            fail(f"{name} was launched no time on the gradient path")
    report["grad_launches"] = launched
    report["grad_launches_per_size"] = {str(k): v for k, v in per_size.items()}
    return launched


def analysis_phase(report: dict, dev, rng, welch_shape=WELCH_SHAPE, pair_shape=PAIR_SHAPE,
                   spec_shape=SPEC_SHAPE, stft_shapes=STFT_SHAPES,
                   periodogram_sizes=PERIODOGRAM_SIZES, exact_sizes=EXACT_SIZES) -> dict:
    """Phase 3c: the spectral path on the card against scipy.signal and
    numpy in float64, with the JAX package's tests' gates.  Returns the
    launches of the phase (counted from 0)."""
    import numpy as np
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.ops.exact import mixed_split

    def rel(got, ref):
        return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())

    def signal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    K.reset_counts()
    engines = {}
    c, n, nperseg, noverlap = welch_shape
    x = signal(c, n)
    xt = torch.from_numpy(x).to(dev)
    segs = c * ((n - nperseg) // (nperseg - noverlap) + 1)
    engines["welch"] = f"({segs}, {nperseg}): {engine(segs, nperseg, True)}"
    for average in ("mean", "median"):
        _, p = gt.welch_device(xt, nperseg=nperseg, noverlap=noverlap, window="hann", average=average)
        _, ref = ss.welch(x.astype(np.float64), nperseg=nperseg, noverlap=noverlap, window="hann",
                          average=average, axis=-1)
        record(report, "analysis_path", f"welch_device ({c}, {n}) nperseg={nperseg} {average} (rel)", n,
               rel(p.cpu().numpy(), ref), 1e-4)
    del xt

    n, nperseg = pair_shape
    x = signal(n)
    y = (0.5 * x + signal(n)).astype(np.float32)
    segs = (n - nperseg) // (nperseg // 2) + 1
    engines["csd, coherence"] = f"({segs}, {nperseg}) per signal: {engine(segs, nperseg, True)}"
    _, (pr, pi) = gt.csd_device(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), nperseg=nperseg)
    _, ref = ss.csd(x.astype(np.float64), y.astype(np.float64), nperseg=nperseg)
    record(report, "analysis_path", f"csd_device n={n} nperseg={nperseg} (rel)", n,
           float(np.abs(pr.cpu().numpy() + 1j * pi.cpu().numpy() - ref).max() / np.abs(ref).max()), 1e-4)
    _, coh = gt.coherence_device(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), nperseg=nperseg)
    _, ref = ss.coherence(x.astype(np.float64), y.astype(np.float64), nperseg=nperseg)
    record(report, "analysis_path", f"coherence_device n={n} nperseg={nperseg} (abs)", n,
           float(np.abs(coh.cpu().numpy() - ref).max()), 1e-3)

    n, nperseg, noverlap = spec_shape
    x = signal(n)
    segs = (n - nperseg) // (nperseg - noverlap) + 1
    engines["spectrogram_scipy"] = f"({segs}, {nperseg}): {engine(segs, nperseg, True)}"
    _, _, sxx = gt.spectrogram_scipy(x, nperseg=nperseg, noverlap=noverlap, device=dev)
    _, _, ref = ss.spectrogram(x.astype(np.float64), nperseg=nperseg, noverlap=noverlap)
    record(report, "analysis_path", f"spectrogram_scipy n={n} nperseg={nperseg} (rel)", n, rel(sxx, ref), 2e-3)
    _, _, (zr, zi) = gt.stft_scipy(x, nperseg=nperseg, noverlap=noverlap, device=dev)
    _, _, ref = ss.stft(x.astype(np.float64), nperseg=nperseg, noverlap=noverlap)
    record(report, "analysis_path", f"stft_scipy n={n} nperseg={nperseg} (rel)", n,
           float(np.abs(zr + 1j * zi - ref).max() / np.abs(ref).max()), 2e-3)
    _, back = gt.istft_scipy(zr, zi, nperseg=nperseg, noverlap=noverlap, device=dev)
    _, ref = ss.istft(ref, nperseg=nperseg, noverlap=noverlap)
    record(report, "analysis_path", f"istft_scipy n={n} nperseg={nperseg} vs scipy (abs)", n,
           float(np.abs(back[:n] - ref[:n]).max()), 1e-4)

    for n, frame, hop in stft_shapes:
        x = signal(n)
        num = (n - frame) // hop + 1
        engines[f"stft L={n} frame={frame}"] = f"({num}, {frame}): {engine(num, frame, True)}"
        sr, si = gt.stft_device(torch.from_numpy(x).to(dev), frame, hop)
        y = gt.istft_device(sr, si, hop, length=n).cpu().numpy()
        cov = slice(frame, (num - 1) * hop)  # every sample under a full window stack
        record(report, "analysis_path", f"istft_device(stft_device) L={n} frame={frame} hop={hop}", n,
               float(np.abs(y[cov] - x[cov]).max() / np.abs(x).max()), gate(frame))

    # ShortTimeFFT at the first STFT shape, against scipy's where this
    # scipy has the class, else numpy float64 frames of the same geometry.
    n, frame, hop = stft_shapes[0]
    x = signal(n)
    sft = gt.ShortTimeFFT.from_window("hann", 1.0, frame, frame - hop, device=dev)
    z = sft.stft(x)
    if hasattr(ss, "ShortTimeFFT"):
        oracle = "scipy.signal.ShortTimeFFT"
        ref = ss.ShortTimeFFT.from_window("hann", 1.0, frame, frame - hop).stft(x.astype(np.float64))
    else:
        oracle = "numpy float64 frames"
        w = gt.window_table("hann", frame).astype(np.float64)
        xp = np.pad(x.astype(np.float64), (frame, frame))
        starts = [(p * hop - frame // 2) + frame for p in range(sft.p_min, sft.p_max(n))]
        ref = np.fft.rfft(np.stack([xp[s:s + frame] * w for s in starts]), axis=-1).T
    record(report, "analysis_path", f"ShortTimeFFT.stft L={n} frame={frame} hop={hop} vs {oracle} (rel)",
           n, float(np.abs(z - ref).max() / np.abs(ref).max()), 2e-4)
    back = sft.istft(z, k1=n)
    record(report, "analysis_path", f"ShortTimeFFT.istft L={n} frame={frame} hop={hop} vs signal", n,
           float(np.abs(back - x).max() / np.abs(x).max()), 2e-4)
    report["short_time_fft_oracle"] = oracle

    per_size = {}
    for n in periodogram_sizes:
        x = signal(n)
        before = counts()
        _, p = gt.periodogram_device(torch.from_numpy(x).to(dev))
        p = p.cpu().numpy()
        per_size[f"periodogram {n}"] = count_delta(before)[0]
        _, ref = ss.periodogram(x.astype(np.float64))
        m = mixed_split(n)
        engines[f"periodogram {n}"] = (engine(1, n, True) if n & (n - 1) == 0 else
                                       f"mixed {m[0]} x {m[1]}: torch" if m else
                                       f"Bluestein m={1 << (2 * n - 2).bit_length()}: "
                                       f"{engine(1, 1 << (2 * n - 2).bit_length(), False)}, twice")
        record(report, "analysis_path", f"periodogram_device n={n} (rel)", n, rel(p, ref), 2e-4)
    for n in exact_sizes:
        x = signal(n)
        m = 1 << (2 * n - 2).bit_length() if mixed_split(n) is None else n
        before = counts()
        yr, yi = gt.fft_exact_device(torch.from_numpy(x).to(dev))
        ref = np.fft.fft(x.astype(np.float64))
        record(report, "analysis_path", f"fft_exact_device n={n} vs numpy f64 (rel)", n,
               float(max(np.abs(yr.cpu().numpy() - ref.real).max(), np.abs(yi.cpu().numpy() - ref.imag).max())
                     / np.abs(ref).max()), gate(m))
        br, bi = gt.ifft_exact_device(yr, yi)
        back = br.cpu().numpy().astype(np.float64) + 1j * bi.cpu().numpy()
        ref = np.fft.ifft(yr.cpu().double().numpy() + 1j * yi.cpu().double().numpy())
        record(report, "analysis_path", f"ifft_exact_device n={n} vs numpy f64 (rel)", n,
               float(np.abs(back - ref).max() / np.abs(ref).max()), gate(m))
        per_size[f"fft_exact + ifft_exact {n}"] = count_delta(before)[0]

    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    plain = sum(c.plain_calls for c in K.COUNTS.values())
    print(f"  engines: {engines}")
    print(f"  launches in phase 3c: {launched}; plain calls {plain}; by call: {per_size}")
    if plain:
        fail(f"phase 3c ran {plain} plain kernel versions on the card")
    if launched["stage_a"] < 1:
        fail("stage_a was launched no time on the analysis path")
    for n in periodogram_sizes:  # Bluestein: one launch for each of its two m-point transforms
        kernel = band_kernel(1, 1 << (2 * n - 2).bit_length())
        got = per_size[f"periodogram {n}"]
        if n & (n - 1) and mixed_split(n) is None and got != {k: 2 if k == kernel else 0 for k in got}:
            fail(f"periodogram n={n}: launches {got}, expected two of {kernel}")
    report.update(analysis_launches=launched, analysis_launches_per_call=per_size, analysis_engines=engines)
    return launched


def analysis_times(report: dict, dev) -> None:
    """Phase 4's rows for this slice's path: each call beside its torch
    counterpart, CUDA events and profiler device time."""
    import numpy as np
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.ops.spectral import _scale_mult_on
    from gpu_fft_tpu_torch.ops.stft import window_on

    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, grad=False):
        return torch.randn(*shape, generator=gen, device=dev).requires_grad_(grad)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def row(label, port_fn, torch_fn, torch_name):
        ms, tms = cuda_ms(port_fn, iters=10, repeats=3), cuda_ms(torch_fn, iters=10, repeats=3)
        (dev_ms, top), (tdev_ms, _) = device_ms(port_fn, iters=10, top=6), device_ms(torch_fn, iters=10)
        report["times"].append(dict(what=label, ms=ms, torch_ms=tms, torch_call=torch_name, device_ms=dev_ms,
                                    torch_device_ms=tdev_ms, top_kernels=top))
        print(f"  {label:44s} events: port {ms:.4f} ms {torch_name} {tms:.4f} ms | "
              f"device: port {fmt(dev_ms)} {torch_name} {fmt(tdev_ms)}")
        print(f"    top kernels: {[(k, round(v, 4)) for k, v in top]}")

    for n in (4096, 1 << 20):
        x = randn(1, n, grad=True)
        row(f"grad step (Parseval) B=1 n={n}",
            lambda x=x: torch.autograd.grad(sum((y * y).sum() for y in gt.fft_device(x)), x),
            lambda x=x: torch.autograd.grad(torch.fft.fft(x).abs().square().sum(), x),
            "torch.fft.fft + autograd")
    c, n, nperseg, noverlap = WELCH_SHAPE
    x = randn(c, n)
    w = window_on("hann", nperseg, dev)
    mult = _scale_mult_on("hann", nperseg, 1.0, "density", None, dev)

    def torch_welch():
        segs = x.unfold(-1, nperseg, nperseg - noverlap)
        segs = (segs - segs.mean(-1, keepdim=True)) * w
        return torch.fft.rfft(segs).abs().square().mean(-2) * mult

    row(f"welch_device ({c}, {n}) nperseg={nperseg}",
        lambda: gt.welch_device(x, nperseg=nperseg, noverlap=noverlap), torch_welch,
        "unfold+torch.fft.rfft+mean")
    del x
    for n, frame, hop in STFT_SHAPES:
        x = randn(n)
        wt = torch.hann_window(frame, periodic=True, device=dev)
        row(f"stft roundtrip L={n} frame={frame} hop={hop}",
            lambda x=x, frame=frame, hop=hop: gt.istft_device(*gt.stft_device(x, frame, hop), hop, length=n),
            lambda x=x, frame=frame, hop=hop, wt=wt: torch.istft(
                torch.stft(x, frame, hop, window=wt, return_complex=True), frame, hop, window=wt, length=n),
            "torch.stft+torch.istft")
    for n in (1 << 22, 1000003):
        x = randn(n)
        mult = _scale_mult_on(None, n, 1.0, "density", None, dev)
        row(f"periodogram_device n={n}", lambda x=x: gt.periodogram_device(x),
            lambda x=x, mult=mult: torch.fft.rfft(x - x.mean()).abs().square() * mult,
            "torch.fft.rfft")
    x = randn(48000)
    row("fft_exact_device n=48000", lambda: gt.fft_exact_device(x), lambda: torch.fft.fft(x), "torch.fft.fft")


def filter_phase(report: dict, dev, rng, rows=FILTER_ROWS, fir_taps=FIR_TAPS, stream=STREAM) -> dict:
    """Phase 3d: the filtering path on the card against scipy.signal /
    scipy.fft / numpy in float64, with the JAX package's tests' gates.
    Each row records its error, its gate and the K1/K2/K3 launches of its
    call; no plain version may run.  Returns the launches of the phase
    (counted from 0)."""
    import numpy as np
    import scipy.fft as sf
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import large as L

    per_call = {}

    def rel(got, ref, floor=0.0):
        got = np.asarray(got)
        return float(np.abs(got - ref).max() / max(floor, float(np.abs(ref).max())))

    def run(label, fn):
        """``fn()`` with the launches it made recorded under ``label``."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        per_call[label], plain = count_delta(before)
        if plain:
            fail(f"{label}: {plain} plain kernel versions ran on the card")
        return out

    def row(label, n, err, limit):
        record(report, "filter_path", f"{label} (launches {per_call.get(label.split(' vs ')[0], {})})", n, err,
               limit)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    K.reset_counts()
    geometries, restore = capture_launches(L)
    b, n = rows
    x = rng.standard_normal((b, n)).astype(np.float32)
    x64 = x.astype(np.float64)
    h = gt.firwin(fir_taps, 0.2)
    xt, ht = tensor(x), tensor(h)
    h32 = h.astype(np.float32).astype(np.float64)

    lbl = f"oaconvolve_device ({b}, {n}) * {fir_taps} block 16384"
    y = run(lbl, lambda: gt.oaconvolve_device(xt, ht, block=16384)).cpu().numpy()
    ref = ss.oaconvolve(x64, h32[None], axes=-1)
    row(f"{lbl} vs scipy.signal.oaconvolve (rel)", n, rel(y, ref), 2e-3)
    lbl = f"fftfilt_device ({b}, {n}) * {fir_taps}"
    y = run(lbl, lambda: gt.fftfilt_device(xt, ht)).cpu().numpy()
    ref = ss.lfilter(h32, [1.0], x64, axis=-1)
    row(f"{lbl} vs scipy.signal.lfilter (rel)", n, rel(y, ref), 2e-3)
    lbl = f"filtfilt_fir {n} * {fir_taps}"
    y = run(lbl, lambda: gt.filtfilt_fir(x[0], h, device=dev))
    ref = ss.filtfilt(h32, [1.0], x64[0])
    row(f"{lbl} vs scipy.signal.filtfilt (rel)", n, rel(y, ref), 2e-3)

    m = 1 << 21
    lbl = f"fft_convolve_device (1, {n}) * 4097 (m = 2^21)"
    bb = rng.standard_normal(4097).astype(np.float32)
    y = run(lbl, lambda: gt.fft_convolve_device(xt[:1], tensor(bb[None]))).cpu().numpy()
    ref = ss.fftconvolve(x64[:1], bb.astype(np.float64)[None], axes=-1)  # the f64 linear convolution
    row(f"{lbl} vs f64 convolution (rel)", m, rel(y, ref), 2 * gate(m))

    chunks, chunk, taps = stream
    hs = gt.firwin(taps, 0.3).astype(np.float32)
    sig = rng.standard_normal(chunks * chunk).astype(np.float32)
    fir = gt.FIRStream(hs, chunk=chunk, device=dev)
    state, outs = fir.init(), []
    sig_t = tensor(sig)
    steps = []
    for i in range(chunks):
        before = counts()
        state, yc = fir.step(state, sig_t[i * chunk:(i + 1) * chunk])
        steps.append(count_delta(before))
        outs.append(yc)
    torch.cuda.synchronize()
    lbl = f"FIRStream.step x {chunks} chunk={chunk} taps={taps}"
    per_call[lbl] = {k: sum(d[k] for d, _ in steps) for k in steps[0][0]}
    if any(p for _, p in steps) or any(d != {**{k: 0 for k in d}, "whole_transform": 2} for d, _ in steps):
        fail(f"FIRStream.step launches {steps[:2]}..., expected K1 twice a step and no plain call")
    y = torch.cat(outs).cpu().numpy()
    ref = ss.lfilter(hs.astype(np.float64), [1.0], sig.astype(np.float64))
    row(f"{lbl} vs scipy.signal.lfilter (rel)", chunks * chunk, rel(y, ref), 2e-3)

    bw, aw = ss.butter(4, 0.2)
    lbl = f"lfilter_device butter(4) ({b}, {n})"
    y = run(lbl, lambda: gt.lfilter_device(bw, aw, xt)).cpu().numpy()
    ref = ss.lfilter(bw, aw, x64, axis=-1)
    row(f"{lbl} vs scipy.signal.lfilter (rel)", n, rel(y, ref, 1.0), 2e-4)
    sos = ss.butter(8, 0.2, output="sos")
    lbl = f"sosfiltfilt butter(8) ({b}, {n})"
    y = run(lbl, lambda: gt.sosfiltfilt(sos, x64, device=dev))
    ref = ss.sosfiltfilt(sos, x64, axis=-1)
    row(f"{lbl} vs scipy.signal.sosfiltfilt (rel)", n, rel(y, ref, 1.0), 5e-4)

    lbl = f"resample_poly_device 3/2 ({b}, {n})"
    y = run(lbl, lambda: gt.resample_poly_device(xt, 3, 2)).cpu().numpy()
    ref = ss.resample_poly(x64, 3, 2, axis=-1)
    row(f"{lbl} vs scipy.signal.resample_poly (rel)", n, rel(y, ref), 2e-3)
    for ftype in ("iir", "fir"):
        lbl = f"decimate q=4 {ftype} {n}"
        y = run(lbl, lambda: gt.decimate(x[0], 4, ftype=ftype, device=dev))
        ref = ss.decimate(x64[0], 4, ftype=ftype)
        row(f"{lbl} vs scipy.signal.decimate (rel)", n, rel(y, ref), 2e-3)

    lbl = f"hilbert_device {n}"
    ar, ai = run(lbl, lambda: gt.hilbert_device(xt[0]))
    ref = ss.hilbert(x64[0])
    row(f"{lbl} vs scipy.signal.hilbert (rel)", n,
        rel(ar.cpu().numpy().astype(np.float64) + 1j * ai.cpu().numpy(), ref), 2 * gate(n))
    for n_in, num in ((n, n // 2), (44100, 48000)):
        lbl = f"resample_device {n_in} -> {num}"
        y = run(lbl, lambda n_in=n_in, num=num: gt.resample_device(xt[0, :n_in], num)).cpu().numpy()
        ref = ss.resample(x64[0, :n_in], num)
        row(f"{lbl} vs scipy.signal.resample (rel)", n_in, rel(y, ref), 2 * gate(max(n_in, num)))

    for shape in ((1, n), (64, 4096)):
        xs = x.reshape(-1)[: shape[0] * shape[1]].reshape(shape)
        lbl = f"dct_device type 2 ortho {shape}"
        y = run(lbl, lambda xs=xs: gt.dct_device(tensor(xs), 2, "ortho")).cpu().numpy()
        ref = sf.dct(xs.astype(np.float64), type=2, norm="ortho")
        row(f"{lbl} vs scipy.fft.dct (rel)", shape[1], rel(y, ref, 1.0), 5e-5)
        lbl = f"idct_device type 2 ortho {shape}"
        back = run(lbl, lambda y=y: gt.idct_device(tensor(y), 2, "ortho")).cpu().numpy()
        ref = sf.idct(y.astype(np.float64), type=2, norm="ortho")
        row(f"{lbl} vs scipy.fft.idct (rel)", shape[1], rel(back, ref, 1.0), 5e-5)
    x48 = x64[0, :48000]
    for fn, rfn, t in (("dct", sf.dct, 1), ("dct", sf.dct, 3), ("dct", sf.dct, 4), ("dst", sf.dst, 2),
                       ("dst", sf.dst, 1), ("dst", sf.dst, 4)):
        lbl = f"{fn}_device type {t} 48000"
        y = run(lbl, lambda fn=fn, t=t: getattr(gt, f"{fn}_device")(tensor(x48), t)).cpu().numpy()
        ref = rfn(x48.astype(np.float32).astype(np.float64), type=t)
        row(f"{lbl} vs scipy.fft.{fn} (rel)", 48000, rel(y, ref, 1.0), 5e-5)

    nc = 1 << 16
    lbl = f"czt_device n = m = {nc}"
    cr, ci = run(lbl, lambda: gt.czt_device(xt[0, :nc]))
    ref = ss.czt(x64[0, :nc])
    row(f"{lbl} vs scipy.signal.czt (rel)", nc, rel(cr.cpu().numpy().astype(np.float64) + 1j * ci.cpu().numpy(), ref),
        2e-4)
    lbl = "czt_device n = m = 1000"
    cr, ci = run(lbl, lambda: gt.czt_device(xt[0, :1000]))
    ref = ss.czt(x64[0, :1000])
    row(f"{lbl} vs scipy.signal.czt (rel)", 1000, rel(cr.cpu().numpy().astype(np.float64) + 1j * ci.cpu().numpy(), ref),
        2e-4)
    lbl = "zoom_fft_device n = m = 1000 band [0.1, 0.3]"
    cr, ci = run(lbl, lambda: gt.zoom_fft_device(xt[0, :1000], [0.1, 0.3], m=1000))
    ref = ss.zoom_fft(x64[0, :1000], [0.1, 0.3], m=1000)
    row(f"{lbl} vs scipy.signal.zoom_fft (rel)", 1000,
        rel(cr.cpu().numpy().astype(np.float64) + 1j * ci.cpu().numpy(), ref), 2e-4)

    for nf in (n, 10000):
        dln, mu = 12.8 / nf, 0.5
        r = np.exp((np.arange(nf) - (nf - 1) / 2) * dln)
        a = (r**1.5 * np.exp(-r * r / 2)).astype(np.float32)
        off = gt.fhtoffset(dln, mu)
        lbl = f"fht_device {nf}"
        got = run(lbl, lambda a=a, dln=dln, off=off: gt.fht_device(tensor(a), dln, mu, offset=off)).cpu().numpy()
        ref = sf.fht(a.astype(np.float64), dln, mu, offset=off)
        row(f"{lbl} vs scipy.fft.fht (rel)", nf, rel(got, ref, 1.0), 3e-5)
        lbl = f"ifht_device {nf}"
        back = run(lbl, lambda got=got, dln=dln, off=off: gt.ifht_device(tensor(got), dln, mu, offset=off)).cpu().numpy()
        ref = sf.ifht(got.astype(np.float64), dln, mu, offset=off)
        row(f"{lbl} vs scipy.fft.ifht (rel)", nf, rel(back, ref, 1.0), 3e-5)

    restore()
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    plain = sum(c.plain_calls for c in K.COUNTS.values())
    print(f"  launches in phase 3d: {launched}; plain calls {plain}")
    for label, got in per_call.items():
        print(f"    {label}: {got}")
    if plain:
        fail(f"phase 3d ran {plain} plain kernel versions on the card")
    for kernel in ("stage_a", "whole_transform"):
        if launched[kernel] < 1:
            fail(f"{kernel} was launched no time on the filtering path")
    expect = {f"fft_convolve_device (1, {n}) * 4097 (m = 2^21)": {"stage_a": 3},
              f"hilbert_device {n}": {"stage_a": 2},
              f"dct_device type 2 ortho {(1, n)}": {"stage_a": 1},
              f"idct_device type 2 ortho {(1, n)}": {"stage_a": 1},
              f"czt_device n = m = {nc}": {"stage_a": 2},
              "czt_device n = m = 1000": {"whole_transform": 2}}
    for label, want in expect.items():
        got = {k: v for k, v in per_call[label].items() if v}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
    report.update(filter_launches=launched, filter_launches_per_call=per_call)

    # Every kernel geometry the phase launched, held against its plain version
    # on the input the path gave it (after the counts are read: these
    # launches are not the path's).
    print(f"  {len(geometries)} kernel geometries launched in phase 3d, each vs its plain version "
          f"(gate max|d| <= {TOL} max|plain|):")
    for (name, shape, real, *rest), (gx, gy, args, kw) in geometries.items():
        got = getattr(K, name)(gx, gy, *args, **kw)
        want = getattr(K, name + "_plain")(gx, gy, *args, **kw)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        ok = err <= TOL * scale
        case = (f"phase 3d {shape} {'real' if real else 'complex'} "
                f"{[a for a in args if not isinstance(a, dict)]} {kw or ''}")
        report["kernel_checks"].append(dict(kernel=name, case=case, max_abs_err=err, max_abs=scale,
                                            exact=False, ok=ok))
        print(f"    {name:24s} {case:56s} max|d| {err:.3e} max|plain| {scale:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")
    del geometries
    torch.cuda.synchronize()
    return launched


def filter_times(report: dict, dev) -> None:
    """Phase 4's rows for the filtering path: each call beside its torch
    counterpart where torch has one, CUDA events and profiler device
    time."""
    import numpy as np
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt

    gen = torch.Generator(device=dev).manual_seed(10)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def row(label, port_fn, torch_fn=None, torch_name=None, iters=10):
        ms = cuda_ms(port_fn, iters=iters, repeats=3)
        dev_ms, top = device_ms(port_fn, iters=iters, top=6)
        tms = tdev_ms = None
        if torch_fn is not None:
            tms, (tdev_ms, _) = cuda_ms(torch_fn, iters=iters, repeats=3), device_ms(torch_fn, iters=iters)
        report["times"].append(dict(what=label, ms=ms, torch_ms=tms, torch_call=torch_name, device_ms=dev_ms,
                                    torch_device_ms=tdev_ms, top_kernels=top))
        other = f" {torch_name} {tms:.4f} ms" if tms is not None else " (no torch counterpart)"
        print(f"  {label:44s} events: port {ms:.4f} ms{other} | device: port {fmt(dev_ms)}"
              + (f" {torch_name} {fmt(tdev_ms)}" if torch_fn is not None else ""))
        print(f"    top kernels: {[(k, round(v, 4)) for k, v in top]}")

    b, n = FILTER_ROWS
    x = torch.randn(b, n, generator=gen, device=dev)
    h = gt.firwin(FIR_TAPS, 0.2).astype(np.float32)
    ht = torch.from_numpy(h).to(dev)
    m = 1 << 21
    hspec = torch.fft.rfft(ht, n=m)
    row(f"oaconvolve_device ({b}, {n}) * {FIR_TAPS}", lambda: gt.oaconvolve_device(x, ht),
        lambda: torch.fft.irfft(torch.fft.rfft(x, n=m) * hspec, n=m)[:, : n + FIR_TAPS - 1],
        "torch.fft.rfft/irfft m=2^21", iters=5)
    row(f"fftfilt_device ({b}, {n}) * {FIR_TAPS}", lambda: gt.fftfilt_device(x, ht),
        lambda: torch.fft.irfft(torch.fft.rfft(x, n=m) * hspec, n=m)[:, :n],
        "torch.fft.rfft/irfft m=2^21", iters=5)
    chunks, chunk, taps = STREAM
    fir = gt.FIRStream(gt.firwin(taps, 0.3).astype(np.float32), chunk=chunk, device=dev)
    st0, xc = fir.init(), torch.randn(1, chunk, generator=gen, device=dev)
    mm = 1 << (chunk + taps - 2).bit_length()
    hs = torch.fft.rfft(torch.from_numpy(gt.firwin(taps, 0.3).astype(np.float32)).to(dev), n=mm)

    def torch_stream():
        full = torch.fft.irfft(torch.fft.rfft(xc, n=mm) * hs, n=mm)
        t = taps - 1
        return full[:, chunk:chunk + t], torch.cat([full[:, :t] + st0, full[:, t:chunk]], 1)

    row(f"FIRStream.step chunk={chunk} taps={taps}", lambda: fir.step(st0, xc), torch_stream,
        f"torch.fft.rfft/irfft m={mm}")
    bw, aw = ss.butter(4, 0.2)
    row(f"lfilter_device butter(4) ({b}, {n})", lambda: gt.lfilter_device(bw, aw, x), iters=3)
    row(f"resample_poly_device 3/2 ({b}, {n})", lambda: gt.resample_poly_device(x, 3, 2), iters=5)
    x1 = x[0].contiguous()
    mask = torch.zeros(n, device=dev)
    mask[0] = mask[n // 2] = 1.0
    mask[1: n // 2] = 2.0
    row(f"hilbert_device {n}", lambda: gt.hilbert_device(x1),
        lambda: torch.fft.ifft(torch.fft.fft(x1) * mask), "torch.fft.fft*mask*ifft")

    def makhoul_roundtrip(v):
        nn = v.shape[-1]
        k = torch.arange(nn, device=dev, dtype=torch.float32)
        w = torch.exp(-0.5j * torch.pi * k / nn)
        f = torch.full((nn,), (1.0 / (2.0 * nn)) ** 0.5, device=dev)
        f[0] = (1.0 / (4.0 * nn)) ** 0.5

        def step():
            p = torch.cat([v[:, 0::2], v[:, 1::2].flip(-1)], -1)
            y = 2.0 * (torch.fft.fft(p) * w).real * f  # DCT-II, ortho
            t = torch.cat([torch.zeros_like(y[:, :1]), y[:, 1:].flip(-1)], -1) / f[None] / 2.0
            z = torch.fft.ifft((y / f[None] / 2.0 - 1j * t) * w.conj()).real
            out = torch.empty_like(z)
            out[:, 0::2], out[:, 1::2] = z[:, : (nn + 1) // 2], z[:, (nn + 1) // 2:].flip(-1)
            return out

        return step

    for shape in ((1, n), (64, 4096)):
        v = torch.randn(*shape, generator=gen, device=dev)
        row(f"dct+idct type 2 ortho {shape}", lambda v=v: gt.idct_device(gt.dct_device(v, 2, "ortho"), 2, "ortho"),
            makhoul_roundtrip(v), "Makhoul on torch.fft")


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
        ("whole_transform", n, b) for n in (2048, 4096, 8192, 16384) for b in (1, 3)
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

    # The shipped ct at 2^17, 2^20, 2^21 (phase 3d's convolution) and 2^24;
    # at 2^18 (n2 = 2,048) every ct that the L4 lever of ablate_2e20_levers
    # sets.
    k3_cases = [(1 << 17, None), *(((1 << 18), ct) for ct in (512, 1024, 2048)),
                (1 << 20, None), (1 << 21, None), (1 << 24, None)]
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
    # path's (the plan's default tile), 1,024 and 2,048 the L4 lever's.  2^19
    # and 2^21 are the folds of phase 3d's resample and convolution.
    for n in sorted((*IRFFT_STAGED, 1 << 19, 1 << 21)):
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

    # S2 on the legacy plans of the levers harness (2^20, n1 = 128), the
    # widest n1 it takes (256) and the narrowest (32, at 2^17).
    for n, n1 in ((1 << 17, 32), (1 << 20, 128), (1 << 20, 256)):
        s2_plan = A.manual_tables(P.on_device(ablate_large.make_plan, n, n1, -1, device=dev))
        x = randn(n1, s2_plan["n2"])
        compare("stage_a_manual", f"n={n} n1={n1} real {A.manual_geometry(n1, s2_plan['n2'])}",
                A.stage_a_manual(x, s2_plan), A.stage_a_manual_plain(x, s2_plan))
        del x, s2_plan
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
        record(report, "main_path", label, n, err, limit)

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

    # ── Phase 3b: gradients on the card ─────────────────────────────────────
    stamp("phase 3b")
    print("phase 3b: gradients through the autograd seams on device='cuda'")
    grad_launches = grad_phase(report, dev, rng)

    # ── Phase 3c: the spectral path on the card ─────────────────────────────
    stamp("phase 3c")
    print("phase 3c: the spectral path on device='cuda' against scipy.signal / numpy in float64")
    analysis_launches = analysis_phase(report, dev, rng)

    # ── Phase 3d: the filtering path on the card ────────────────────────────
    stamp("phase 3d")
    print("phase 3d: the filtering path on device='cuda' against scipy.signal / scipy.fft in float64")
    filter_launches = filter_phase(report, dev, rng)

    # ── Phase 4: warm median times (CUDA events) ────────────────────────────
    stamp("phase 4")
    print(f"phase 4: warm medians, CUDA events ({smi})")
    kernel_ms = {}

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    flush_buf = torch.ones(64 << 20, device=dev)  # 256 MiB, five times the H100's L2

    def time_pair(label, name, kern_fn, plain_fn, bnd, lib_fn=None, dense=None, cold=None):
        """Kernel, plain version and (where one exists) the library call:
        event and profiler times, and the kernel's share of its bound (and
        of ``dense``, the dense products' bound, where given).  With
        ``cold`` (a part of the kernel's profiled name) the kernel's device
        time is also taken with L2 flushed before each call (a read of
        ``flush_buf``), and the shares read that time."""
        k_ms, p_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        (k_dev, _), (p_dev, _) = device_ms(kern_fn), device_ms(plain_fn)
        lib_ms, lib_dev = (cuda_ms(lib_fn), device_ms(lib_fn)[0]) if lib_fn else (None, None)
        cold_dev = device_ms(lambda: (flush_buf.sum(), kern_fn()), match=cold)[0] if cold else None
        shared = cold_dev if cold else k_dev
        share = None if shared is None else bnd[0] / shared
        rec = dict(what=label, kernel=name, ms=k_ms, plain_ms=p_ms, device_ms=k_dev,
                   plain_device_ms=p_dev, bound_ms=bnd[0], bound_by=bnd[1], share_of_bound=share,
                   library_ms=lib_ms, library_device_ms=lib_dev)
        if cold:
            rec.update(cold_device_ms=cold_dev)
        if dense:
            rec.update(dense_bound_ms=dense[0], dense_bound_by=dense[1],
                       share_of_dense_bound=None if shared is None else dense[0] / shared)
        report["times"].append(rec)
        print(f"  {label:44s} events: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms"
              + (f" library {lib_ms:.4f} ms" if lib_fn else "")
              + f" | device: kernel {fmt(k_dev)} plain {fmt(p_dev)}"
              + (f" library {fmt(lib_dev)}" if lib_fn else "")
              + (f" kernel, L2 flushed, {fmt(cold_dev)}" if cold else "")
              + f" | bound {bnd[0] * 1e3:.2f} us ({bnd[1]})"
              + ("" if share is None else f", {share * 100:.1f}% of bound")
              + ("" if not dense else f"; dense bound {dense[0] * 1e3:.2f} us ({dense[1]})"
                 + ("" if shared is None else f", {dense[0] / shared * 100:.1f}%")))
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
        # K3-legacy at the same shapes, the radix bound with the materialized
        # twiddle's bytes (the dense products' bound beside it: the JAX
        # bodies' count, Karatsuba for complex input), and S2.
        legacy = A.manual_tables(P.on_device(ablate_large.make_plan, n, n1, -1, device=dev))
        lct = P.stage_a_col_tile(n1, n2)
        if n == 1 << 20:  # all rows: the shape S2 computes
            time_pair(f"stage_a_legacy n={n} real all rows", "stage_a_legacy",
                      lambda: K.stage_a(x, None, n1, n2, legacy, lct),
                      lambda: K.stage_a_plain(x, None, n1, n2, legacy, lct),
                      stage_a_bound(n1, n2, n1, False, None), dense=dense_stage_a_bound(n1, n2, n1),
                      cold="stage_a_radix")
            xi = randn(1, n1, n2)
            time_pair(f"stage_a_legacy n={n} complex all rows", "stage_a_legacy",
                      lambda: K.stage_a(x, xi, n1, n2, legacy, lct),
                      lambda: K.stage_a_plain(x, xi, n1, n2, legacy, lct),
                      stage_a_bound(n1, n2, n1, True, None), dense=dense_stage_a_bound(n1, n2, n1, True),
                      cold="stage_a_radix")
            del xi
            x2 = x[0]
            time_pair(f"stage_a_manual n={n} real", "stage_a_manual",
                      lambda: A.stage_a_manual(x2, legacy), lambda: A.stage_a_manual_plain(x2, legacy),
                      dense_stage_a_bound(n1, n2, n1))
        time_pair(f"stage_a_legacy n={n} real rows={rows}", "stage_a_legacy",
                  lambda: K.stage_a(x, None, n1, n2, legacy, lct, rows=rows),
                  lambda: K.stage_a_plain(x, None, n1, n2, legacy, lct, rows=rows),
                  stage_a_bound(n1, n2, rows, False, None), dense=dense_stage_a_bound(n1, n2, rows),
                  cold="stage_a_radix")
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

    analysis_times(report, dev)
    filter_times(report, dev)

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
    if [r["block"] for r in chip_res["oa_block"]] != list(calibrate_chip.OA_BLOCKS):
        fail(f"calibrate_chip: the overlap-add block section timed {chip_res['oa_block']}")
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
    times += [r["us"] for r in chip_res["oa_block"]]
    if not all(np.isfinite(t) and t > 0 for t in times):
        fail(f"a calibration time is not a positive number: {times}")
    for name, row in lat_res["roofline"].items():
        if row["n_kernels"] < 1 or not row["sol_us"] > 0:
            fail(f"calibrate_latency roofline row {name} is empty: {row}")
    print(f"  calibration: {len(times)} timed values, all positive; parity within 5*log2(n)*eps; "
          f"no error rows but the retired ones")

    sources = {
        "whole_transform_packed": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:383"),
        "whole_transform": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:424"),
        "stage_a": ("gpu_fft_tpu_torch/csrc/stage_a.cu", "gpu_fft_tpu/kernels/fused.py:188"),
        "stage_a_legacy": ("gpu_fft_tpu_torch/csrc/stage_a.cu", "gpu_fft_tpu/kernels/fused.py:153"),
        "stage_a_manual": ("gpu_fft_tpu_torch/csrc/dense_f32.cuh", "scripts/ablate_2e20_levers.py:188"),
        **{f"stage_a_dot_{v}": ("gpu_fft_tpu_torch/csrc/stage_a_dot.cu", "scripts/ablate_mosaic_x6.py:105")
           for v in A.VARIANTS},
        "fused_fft_lm": ("gpu_fft_tpu_torch/csrc/fused_lm.cu", "scripts/ablate_engines.py:111"),
        "operand_probe": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/ablate_whole_packed.py:66"),
        "copy_min": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/calibrate_latency.py:79"),
    }
    # The main path's launches: fft/ifft and the real-output path together.
    all_launches = {**{k: main_launches[k] + irfft_launches[k] + grad_launches[k] + analysis_launches[k]
                          + filter_launches[k]
                       for k in MAIN_PATH_KERNELS},
                    **second_launches, **{k: third_launches[k] for k in CALIBRATION_KERNELS}}
    kernels = []
    for name, (src, rep) in sources.items():
        t = kernel_ms[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=all_launches[name],
            irfft_path_launches=irfft_launches.get(name, 0), grad_path_launches=grad_launches.get(name, 0),
            analysis_path_launches=analysis_launches.get(name, 0),
            filter_path_launches=filter_launches.get(name, 0),
            max_abs_err=max_err[name], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"], device_ms=t["device_ms"],
            **{k: t[k] for k in ("dense_bound_ms", "dense_bound_by", "cold_device_ms") if k in t},
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
