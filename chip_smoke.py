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
   2^18 … 2^24 for ct = 512, 1,024, 2,048); K4 (stage B of a complex
   staged transform) at B = 1 at 2^17, 2^20, 2^22 and 2^24 and at the
   matched filter's (64, 128, 8,192), the forward unscaled and the inverse
   with 1/n in its store; the matched filter's correlation and SNR kernels
   (``kernels/matched.py``) at (T, N) = (2, 2^17) and (64, 2^20) on strided
   template rows, the SNR over the cell's window and over one whose edges
   are no multiple of 4 (the kernel's 4-byte path), the peak's index the
   first maximum, then one ``matched_filter_device`` call each with its
   five launches pinned and counted (correlation, K3, K4, SNR, peak; timed
   in phase 4 at (64, 2^20));
   K3-legacy (K3's radix kernel
   reading a materialized twiddle) at every ablate_large shape and in its
   complex, rows and col_tiles forms, S2 at n1 = 32, 128 and 256, and S3 of
   the stage-A ablation harnesses, with S3's error against float64 (gate
   for f32 and bf16_x6: 5*log2(n1)*eps; bf16_x1 printed); K3LF and S2F,
   the "fast" forms of K3-legacy and S2, at the same shapes (K3LF also at
   2^20 complex and rows = 72, 2^22 rows = 72, n1 = 256 complex with rows =
   136 on two column tiles, and n1 = 512 complex, whose F streams), gate
   max|d| <= 1e-3 max|plain| and, against float64, at most 1.5 times the
   plain version's error;
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
   48,000 mixed, 1,000,003 Bluestein with two K3 and two K4 launches) and
   fft_exact / ifft_exact; the engine each estimator's transform took;
3d. the filtering path at full size, counted from 0, against scipy.signal
   / scipy.fft in float64 with the JAX package's tests' gates:
   oaconvolve_device, fftfilt_device (8, 2^20) * 1,025 taps, filtfilt_fir,
   fft_convolve_device at m = 2^21 (three K3 launches), FIRStream (256
   chunks of 4,096, 257 taps, K1 twice a step), lfilter_device and
   sosfiltfilt (8, 2^20), resample_poly_device 3/2, decimate (iir, fir),
   hilbert_device 2^20 (two K3, one K4), resample_device, dct/idct at (1, 2^20)
   (one K3 each) and (64, 4,096), types 1/3/4 and DSTs at 48,000, czt at
   2^16 (two K3, two K4) and 1,000 (two K1), zoom_fft, fht / ifht at 2^20 and
   10,000; each row's launches, no plain call;
3e. the 2-D / N-D path, NATIVE and the examples, counted from 0, against
   numpy / scipy in float64: fft2_device / ifft2_device and rfft2_device /
   irfft2_device on a 512 x 131,072 panel (K3 once each way, K4 on the
   inverses' complex rows, the rows at B = 512; gate 5*log2(H*W)*eps), the host fft2 / ifft2 / rfft2 / irfft2
   of a 4,096^2 image (K1 on the rows and on the columns, B = 4,096 in the
   whole band) and its fft_convolve2d_device with a 33 x 33 kernel at
   8,192^2 (rows of 16,384 at B = 16,384: torch engines, no launch;
   2*5*log2(m1*m2)*eps against
   scipy.signal.fftconvolve), fftn / rfftn and their inverses on a 256^3
   volume, fftn_device of a 1-D 1,024 / 16,384 array (K2 / K1 once), the
   four ndimage Fourier filters on the image's spectrum against
   scipy.ndimage (2e-6) and their ifft2 against numpy; NATIVE (built with
   ``make -C native`` where missing; the phase fails if it does not load)
   at 1,024 ... 65,536 and B = 16; the eight ``gpu_fft_tpu_torch.examples``
   (with ``fno`` and ``extensions``) to their OK lines; each call's launches, no plain call,
   then every kernel geometry the phase launched (K3 at B = 512 among
   them) against its plain version;
3f. the scipy.fft / scipy.signal namespaces and the FNO, counted from 0:
   compat's fft / ifft at 1,024 (K2), 4,096 and 16,384 (K1), 2^20 (K3),
   1,000 (the mixed four-step, torch) and 1,009 (Bluestein, K1 twice),
   rfft / irfft at 4,096 and 2^20, fftn / rfftn / irfftn and dctn(ortho) on
   512 x 512 and hfft at 4,096, each on a CUDA complex64 tensor and through
   ``scipy.fft.set_backend(compat.backend)`` on numpy input, against
   scipy.fft in float64 (5*log2(N)*eps for powers of two, else 3e-5);
   signal.hilbert at 2^20 (K3 twice, K4 once), csd (8, 2^20) / 4,096, stft / istft
   at 2^16, czt at 1,000, hilbert2 on 512^2 and envelope at 2^16 against
   scipy.signal in float64 on the JAX tests' gates; the FNO at the
   published widths on synthetic fields, (a) Burgers FNO1d B = 20 at 8,192,
   (b) Navier-Stokes FNO2d B = 20 at 64^2 with 10 input steps, (c) FNO1d
   at 2^18, B = 2 (K3 three times a layer, K4 once): a forward and backward against
   a float64 twin on torch.fft (output 2*5*log2(N)*eps, gradients 1e-4)
   and 20 Adam steps whose loss falls; each call's launches, no plain
   call, every geometry against its plain version; ``python -m
   gpu_fft_tpu_torch.examples.fno`` to its OK line;
3g. the parallel layer, the mesh train steps, serving and the CLI, counted
   from 0, on a one-rank NCCL process group (``default_mesh()`` and the
   (dp, sp) and (dp, tp) meshes of size 1: real collectives and DTensors,
   the local kernels at full size): ``distributed_fft`` / ``_ifft`` at
   (2, 2^22) and (1, 2^24); ``fft2_sharded`` / ``ifft2_sharded`` on the
   panel (K3 once each way at B = 512, the rows' sharding kept);
   ``fftn_sharded`` 256^3; ``fft_batch_sharded`` / ``ifft_batch_sharded``
   at (1, 16,384) (K1) and (1, 2^20) (K3); ``fft2_batch_sharded``
   (8, 512, 512), each against numpy f64 (5*log2(N)*eps); ``welch_sharded``
   2^20 / 4,096 (1e-4), ``oaconvolve_sharded`` 2^21 * 1,025 (2e-3),
   ``lfilter_sharded`` butter(4) 2^20 (2e-4 abs) against scipy.signal f64;
   ``make_data_parallel_step`` on FNO (c) (K3 12, K4 4 times a step) and
   ``make_gspmd_step`` (FSDP2, dp = tp = 1) on FNO (a), each step's loss and
   parameters against the single-device step from the same weights (1e-5),
   20 steps whose loss falls; every serving kind at (1, 1,024), (1, 4,096),
   (16, 65,536) and (1, 2^20) exported on the card, written, read and run,
   bit-equal to the live call with its launches; ``python -m
   gpu_fft_tpu_torch plan``, ``demo`` and ``serve-check`` as processes (the
   ``extensions`` example, its serving step included, runs with the other
   examples in phase 3e); no plain call, every geometry against its plain
   version;
3h. the precision modes (``GPU_FFT_TPU_PRECISION``), each set within the
   run (``config.PRECISION``) and set back to "full": fft, ifft, rfft and
   irfft through the ``*_device`` entries at n = 1,024 … 2^22 and at
   (16, 65,536), each against numpy in float64 (max|d| / max|ref|) within
   its mode's band (full < 1e-6 and the 5*log2(N)*eps gate, high < 2e-4,
   fast < 2e-2) and ordered full < high < fast with 1e-6 < high and
   1e-4 < fast; the counts, set to 0 before each mode: "high" launches
   none of K1/K2/K3/K1F/K2F/K3F, "fast" launches K2F/K1F/K3F where "full"
   launches K2/K1/K3 (K2F/K1F only in their band, B = 1 and n <= 16,384)
   and no fp32 kernel, no plain call in any mode; every
   K1F/K2F/K3F geometry the mode launched against its plain version
   (max|d| <= 1e-3 max|plain|: a one-ulp fp32 difference before Z's bf16
   rounding moves one intermediate by a bf16 ulp) and against float64,
   where the kernel's error is at most 1.5 times the plain version's, and
   so every geometry the K1F / K2F launch rule picks at n = 1,024 ...
   16,384 for B = 1 and 3, real and complex input, and every geometry the
   K3F rule picks at 2^17 ... 2^24 (B = 1; B = 3 up to 2^20) on real input
   with the real rows, complex input and the irfft fold's column tiles, and
   on the 2-D panel's B = 512; a Parseval gradient at 4,096 and 2^20 in
   each mode, within its band;
3i. the gate-closed engines, counted from 0, each gate opened inside the
   phase only by patching its threshold in ``plan`` (``RFFT_PACK_MIN``,
   ``AXIS0_H_MIN``) and both checked closed after: the packed real forward through fft_device at
   (1 and 3) x (4,096, 32,768, 2^17, 2^21, 2^22) against numpy f64
   (5*log2(n)*eps) with a roundtrip through ifft_device, its half
   transform's launches pinned (K1 once where n/2 is in the whole band, at
   4,096, 32,768 and 2^17, K3 and K4 once at 2^21 and 2^22), and at
   32,768 under "fast" (K1F once, within 2e-2); fft2 / ifft2 / rfft2 /
   irfft2_device on the 4,096^2 image through the axis-0 branch (four
   transform_axis0 calls, phase 3e's gates), the 512 x 131,072 panel's
   fft2_device still on the transpose branch (H = 512 is not above W/2:
   K3 once) and its column pass through transform_axis0 directly (against
   the transpose route on the card, and 4,096 columns against numpy);
   rfft_direct_packed / rfft_packed_psd at (1,024, 256) and (1,024, 512)
   against numpy (5*log2(n)*eps, the PSD twice it); the soak
   (``scripts/soak.py``, seed 0, 40 + 20 checks, 2 GiB) in-process, every
   check ok; each opened engine's device time beside its closed route's
   and torch.fft's; every kernel geometry it launched against its plain
   version.  No tuning row takes these routes, so the phase's launches
   stand only under ``gate_closed_path_launches`` in the kernels line, not
   in ``launches``;
4. warm median times with CUDA events (back-to-back calls, host included)
   and device times from torch.profiler (the kernels alone): each kernel
   against its plain version, its bound on the card and, where one exists,
   the one PyTorch call that computes the same function (K1 and K2 on real
   forward and on complex inverse input, beside torch.fft.fft and
   torch.fft.ifft; K3 at 2^20 and 2^22 on real input with the real path's
   rows and on complex input with the inverse plan, the ifft path, and on
   the irfft path's column tiles; K4 on the inverse at (64, 128, 8,192),
   2^17 and 2^22 against its bytes bound, 16 B a point; K3-legacy at 2^20 on real and complex
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
   on torch.fft where torch has one, and the 2-D rows (fft2, rfft2, irfft2
   on the panel and the image, fft_convolve2d_device, fftn on the volume)
   beside torch.fft's, compat.fft at 4,096 and 2^20 beside torch.fft.fft
   and the FNO train steps (a)-(c) beside the same model on torch.fft;
   phase 3g's rows: fft2_sharded on the panel beside fft2_device, the
   data-parallel FNO (c) step beside the single-device step, an artifact's
   module at (1, 4,096) and (1, 2^20) beside fft_device, and the band's
   fft_device (1, 1,024 ... 16,384) with K1 / K2 through their operator
   beside the same entry called directly (the dispatcher's host time);
   phase 3h's rows: K2F, K1F and K3F against their plain versions and their
   bounds (bf16 operations at the tensor-core peak, bytes at the HBM rate;
   K2F / K1F beside torch.fft on complex32, cuFFT's half precision, the
   kernels' device times the median of 5 profiles with min and max; K3F
   at 2^20 and 2^22, real rows, complex and the irfft tiles, also with L2
   flushed, with its geometry, beside this phase's K3 rows), and
   fft_device in each mode at phase 3h's shapes beside torch.fft.fft in
   fp32 and on complex32; K3LF at 2^20 real and complex, all rows, and at
   2^22 rows = 72, back to back and with L2 flushed, beside K3-legacy; S2F
   at 2^20 with n1 = 128 and 256 beside S2 and S3 bf16_x1 (no PyTorch call
   computes either);
5. the second path: the three stage-A ablation harnesses
   (``python -m gpu_fft_tpu_torch.scripts.<name>``) in their quick setting;
   the launch counts show K3-legacy, S2 and S3 ran, no row holds an error,
   and every timed levers row (the L4 irfft rows too) agrees with its
   reference row within 5*log2(2^22)*eps; then, counted from 0 with
   ``GPU_FFT_TPU_PRECISION=fast`` set in the run, ``ablate_large``,
   ``ablate_2e20_levers`` (quick) and ``time_stage_a``'s legacy rows: K3LF
   and S2F ran, K3-legacy, S2 and every plain version did not, no error
   row, every levers row within twice the "fast" band of its reference and
   L3 (K3F against S2F) within 1e-3; every K3LF / S2F geometry they
   launched against its plain version and float64, and more than 1e-4 of
   max|.| from the fp32 kernel on the same input (the mode was engaged);
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

import contextlib
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
MAIN_PATH_KERNELS = ("whole_transform", "whole_transform_packed", "stage_a", "stage_b")
# A counter whose entry has another name in kernels/fused.py and large.py
# (K4's counter is "stage_b"; large.stage_b is the torch engine).
ENTRIES = {"stage_b": "stage_b_kernel"}
CALIBRATION_KERNELS = ("fused_fft_lm", "operand_probe", "copy_min")
# The transform-path kernels the calibration scripts also drive (not K4:
# none of them runs a complex staged transform).
CALIBRATION_PATH_KERNELS = (*CALIBRATION_KERNELS, *(k for k in MAIN_PATH_KERNELS if k != "stage_b"))
LM_CASES = ((1, 4096), (1, 16384), (1, 65536), (16, 4096), (16, 65536), (64, 4096), (1, 32768))
# The real-output path: B = 1 sizes, batches, the staged sizes where K3 runs
# on half the column tiles, and the shapes timed in phase 4.
IRFFT_SIZES = (256, 1024, 4096, 16384, 65536, 1 << 17, 1 << 20, 1 << 22, 1 << 24)
IRFFT_BATCHES = ((16, 65536), (64, 4096))
IRFFT_STAGED = (1 << 18, 1 << 20, 1 << 22, 1 << 24)
IRFFT_TIMED = ((1, 32768), (1, 65536), (1, 1 << 20), (1, 1 << 22), (16, 65536))
# K4's (B, n) in phase 2: B = 1 across its n2 range (1,024 ... 65,536) and
# the matched filter's 64 rows of 2^20; phase 4 times STAGE_B_TIMED, the
# first row the kernels line's (PERF.md's kernel table has the three).
STAGE_B_CASES = ((1, 1 << 17), (1, 1 << 20), (1, 1 << 22), (1, 1 << 24), (64, 1 << 20))
STAGE_B_TIMED = ((64, 1 << 20), (1, 1 << 17), (1, 1 << 22))
# The matched filter's own kernels (kernels/matched.py) at the benchmark
# cell's (T, N) = (64, 2^20) and at (2, 2^17): held against their plain
# versions in phase 2 (one matched_filter_device call each, its launches
# pinned), timed at the cell's shape in phase 4 (the cell's proportions:
# scripts/time_matched.py, layout).
MATCHED_CASES = ((2, 1 << 17), (64, 1 << 20))
MATCHED_LAUNCHES = {"matched_correlate": 1, "matched_snr": 2}
# Phase 3b: the Parseval gradient at (1, n) and the kernel whose band n is
# (None: the torch engines, the control); dot tests; forward mode.
GRAD_SIZES = ((1024, "whole_transform_packed"), (4096, "whole_transform"), (16384, "whole_transform"),
              (65536, "whole_transform"), (1 << 20, "stage_a"), (1 << 22, "stage_a"))
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
# Phase 3e: the 2-D / N-D path, NATIVE and the examples.
PANEL = (512, 1 << 17)  # channels x samples: K3 on the row passes at B = 512
IMAGE = 4096  # square image; K1 at B = 4,096, the whole band's batch edge
CONV_KERNEL = 33  # the image's convolution kernel side: padded to 8,192^2
VOLUME = 256  # cube side: the direct product on each axis
NATIVE_SIZES = (1024, 4096, 16384, 65536)
NATIVE_BATCH = 16
# Phase 3f: the scipy.fft / scipy.signal namespaces and the FNO.  compat's
# complex transforms at B = 1: (n, launches the dispatch gives); 1,000 is
# the mixed four-step (25 x 40, torch), 1,009 Bluestein on K1 at m = 2,048.
COMPAT_FFT = ((1024, {"whole_transform_packed": 1}), (4096, {"whole_transform": 1}),
              (16384, {"whole_transform": 1}), (1 << 20, {"stage_a": 1, "stage_b": 1}), (1000, {}),
              (1009, {"whole_transform": 2}))
COMPAT_REAL = ((4096, {"whole_transform": 1}), (1 << 20, {"stage_a": 1}))
COMPAT_IMAGE = 512
SIGNAL_HILBERT = 1 << 20
SIGNAL_CSD = (8, 1 << 20, 4096)  # channels, samples, nperseg
SIGNAL_STFT = (1 << 16, 256)  # samples, nperseg
SIGNAL_ENVELOPE = (1 << 16, (5, 600))
# The FNO at the published widths (Li et al. 2021, arXiv 2010.08895, and the
# authors' fourier_1d.py / fourier_2d_time.py): (a) Burgers at the finest
# grid, (b) Navier-Stokes 64^2 with T_in = 10, (c) a record long enough for
# K3 (B * width = 128 rows of 2^18; 2^18 = irfft_half_staged_min, so the
# irfft takes the staged fold).  Synthetic fields from the seed; depth 4.
FNO_CELLS = {
    "a": dict(dims=1, batch=20, size=8192, in_channels=1, modes=16, width=64, depth=4),
    "b": dict(dims=2, batch=20, size=64, in_channels=10, modes=12, width=20, depth=4),
    "c": dict(dims=1, batch=2, size=1 << 18, in_channels=1, modes=16, width=64, depth=4),
}
FNO_STEPS = 20
EXAMPLE_GATES = {"training": "OK", "fno": "[OK] antiderivative operator learned", "extensions": "OK"}
# Phase 3g: the parallel layer at world size 1 over NCCL, serving and the CLI.
DIST_SHAPES = ((2, 1 << 22), (1, 1 << 24))  # distributed_fft / _ifft
BATCH_SHARDED = ((1, 16384), (1, 1 << 20))  # fft_batch_sharded: K1, K3
BATCH_2D = (8, 512, 512)
WELCH_SHARDED = (1 << 20, 4096)  # samples, nperseg
OACONV_SHARDED = (1 << 21, 1025)  # samples, taps
LFILTER_SHARDED = 1 << 20
EXPORT_SHAPES = ((1, 1024), (1, 4096), (16, 65536), (1, 1 << 20))
# Phase 3h: the precision modes, flipped within the run.  The JAX package's
# bands (tests/test_precision.py) and the "fast" kernels of the fp32 ones.
PRECISION_BANDS = {"full": 1e-6, "high": 2e-4, "fast": 2e-2}
PRECISION_SHAPES = (*((1, n) for n in (1024, 4096, 16384, 65536, 1 << 20, 1 << 22)), (16, 65536))
PRECISION_GRAD = (4096, 1 << 20)
FAST_KERNELS = {"whole_transform_packed": "whole_transform_packed_bf16",
                "whole_transform": "whole_transform_bf16", "stage_a": "stage_a_bf16"}
FAST_TOL = 1e-3  # K1F/K2F/K3F/K3LF/S2F vs plain, relative to max|plain|: see phase 3h
# A fast kernel's error against float64 may be at most this many times its
# plain version's (the same rounded operands; fp32 sums in another order).
F64_RATIO = 1.5
# The "fast" forms of the stage-A ablation kernels (phase 5 under "fast").
FAST_LEGACY_KERNELS = {"stage_a_legacy": "stage_a_legacy_bf16", "stage_a_manual": "stage_a_manual_bf16"}
# Phase 3i: the gate-closed engines, each gate opened inside the phase only.
# The packed real forward at B = 1 and 3 (its n/2-point half on K1 at
# 2,048 ... 16,384 when B = 1, K3 above 65,536), once under "fast"; the
# axis-0 column pass (H > W/2 in the predicate, so the panel's H = 512 keeps
# the transpose branch); the packed direct rfft / PSD; the soak.
GATE_PACK_SIZES = (4096, 32768, 1 << 17, 1 << 21, 1 << 22)
GATE_PACK_FAST = 32768
PACK_OPEN = dict(RFFT_PACK_MIN=8)  # plan's thresholds, patched inside the phase
AXIS0_OPEN = dict(AXIS0_H_MIN=2)
GATE_DIRECT = ((1024, 256), (1024, 512))
SOAK = dict(iters=40, analysis_iters=20, max_bytes=1 << 31, seed=0)


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


def stage_a_bound(n1: int, n2: int, rows: int, complex_: bool, ct: int | None, ncols: int | None = None,
                  batch: int = 1):
    """K3 and K3-legacy (the same radix kernel) on ``batch`` signals, on the
    first ``ncols`` (default n2) columns: a radix-2 FFT's 5 n1 log2 n1 FLOP
    per column and 6 per stored output for the twiddle (K3's factored one is
    rebuilt: 6 more); those columns of x (both parts for complex input), the
    n1-point root row and the twiddle's rows read once (K3: two (rows,
    ncols/ct) and twi (rows, ct); K3-legacy, ``ct`` None: the materialized
    (rows, ncols)), the output written once."""
    ncols = n2 if ncols is None else ncols
    flop = batch * (5 * n1 * (n1.bit_length() - 1) * ncols + (6 if ct is None else 12) * rows * ncols)
    twiddle = rows * ncols if ct is None else rows * (ncols // ct + ct)
    nbytes = 4 * (batch * ((2 if complex_ else 1) * n1 * ncols + 2 * rows * ncols) + 2 * n1 + 2 * twiddle)
    return bound(flop, "fp32", nbytes)


def stage_b_bound(b: int, n1: int, n2: int):
    """K4 on (b, n1, n2): per row of n2 a radix-2 FFT's 5 n2 log2 n2 FLOP
    and 6 a point for the row four-step's twiddle; Y read once and the
    spectrum written once, 16 bytes a complex point (the tables stay in
    L2)."""
    points = b * n1 * n2
    return bound(points * (5 * (n2.bit_length() - 1) + 6), "fp32", 16 * points)


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


def fast_whole_bound(n: int, complex_: bool):
    """K2F / K1F, B = 1: ``roofline_row`` with ``precision_passes=1`` (each
    matmul stage's flops once at the bf16 tensor-core peak: the Karatsuba
    count, K1F's own and the least of K2F's), x read and the complex output
    written once at the HBM rate, the elementwise flops at the fp32 peak;
    the largest wall.  Returns (ms, wall, the launch-latency wall in ms)."""
    from gpu_fft_tpu_torch.utils.roofline import roofline_row

    walls = roofline_row(1, n, "ifft" if complex_ else "fft", 1.0, chip=h100(), n_kernels=1,
                         precision_passes=1)["walls_us"]
    wall = max(("hbm", "matmul", "elementwise"), key=walls.get)
    return walls[wall] * 1e-3, "bytes" if wall == "hbm" else "operations", walls["latency"] * 1e-3


def fast_stage_a_bound(n1: int, n2: int, rows: int, complex_: bool, ct: int | None, ncols: int | None = None,
                       batch: int = 1):
    """K3F, and with ``ct`` None K3LF and S2F (the materialized table): per
    kept column ``rows`` x n1 multiply-adds per product (real input Fr x and
    Fi x; complex the Karatsuba three) at the bf16 peak, plus the fp32
    twiddle (K3F: its rebuild and the complex product, 12 FLOP an output;
    the table: the product, 6; 2 more for Karatsuba's combination); x's kept
    columns (both parts for complex input), the n1 x n1 bf16 tables the
    products read (real input Fr and Fi, S2's stacking; complex Fr, Fd, Fs),
    the twiddle read once (K3F: the two factors' rows; the table: its kept
    rows x columns), the output written once."""
    ncols = n2 if ncols is None else ncols
    products = 3 if complex_ else 2
    outputs = batch * rows * ncols
    spec = h100()
    twiddle_flop = (12 if ct else 6) + (2 if complex_ else 0)
    t_ops = (2 * products * n1 * outputs / (spec.bf16_tflops * 1e12)
             + twiddle_flop * outputs / (spec.vpu_tflops * 1e12)) * 1e3
    twiddle = rows * (ncols // ct + ct) if ct else rows * ncols
    nbytes = (4 * batch * (2 if complex_ else 1) * n1 * ncols + 8 * outputs + 2 * products * n1 * n1
              + 8 * twiddle)
    t_bytes = nbytes / (spec.hbm_gbps * 1e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    ``top`` kernels by time.  A profile that comes back with no such kernel,
    or with a kernel recorded other than a whole number of times a call
    (CUPTI at times starts a few ms late and loses a profile's first
    kernels), is taken again, up to ``attempts`` times; None where none of
    them records one."""
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
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0.0) > 0 and match in e.key]
        by_name = {e.key: e.self_device_time_total / iters / 1000.0 for e in events}
        if by_name and all(e.count % iters == 0 for e in events):
            break
    if not by_name:
        return None, []
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [(k[:60], v) for k, v in ranked]


def capture_launches(module, names=MAIN_PATH_KERNELS) -> tuple[dict, object]:
    """Wraps kernel entries of ``module`` (by default the dispatch's
    ``large.stage_a``, ``large.stage_b_kernel``, ``large.whole_transform``,
    ``large.whole_transform_packed``) so that the first input of every
    distinct launch geometry is kept, cloned: (kernel, input shape, real or
    complex, plan, tile arguments) -> (xr, xi, args, kwargs).  An entry
    whose second argument is not a tensor (S2F's tables) keeps it as it
    is.  The counts
    are the wrapped kernels' own.  Returns the dict and a function that puts
    the entries back."""
    import torch

    seen = {}
    originals = {name: getattr(module, ENTRIES.get(name, name)) for name in names}

    def wrap(name, fn):
        def call(xr, xi, *args, **kw):
            key = (name, tuple(xr.shape), xi is None,
                   *(id(a) if isinstance(a, dict) else a for a in args), *sorted(kw.items()))
            if key not in seen and type(xr) is torch.Tensor:  # not a tensor torch.export traces with
                seen[key] = (xr.clone(), xi.clone() if isinstance(xi, torch.Tensor) else xi, args, kw)
            return fn(xr, xi, *args, **kw)

        return call

    for name, fn in originals.items():
        setattr(module, ENTRIES.get(name, name), wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(module, ENTRIES.get(name, name), fn)

    return seen, restore


def check_geometries(report: dict, geometries: dict, phase: str) -> None:
    """Hold each kernel geometry ``capture_launches`` kept against its plain
    version on the same input (gate max|d| <= TOL max|plain|); fail on the
    first that disagrees.  Empties ``geometries``."""
    import torch

    from gpu_fft_tpu_torch.kernels import fused as K

    print(f"  {len(geometries)} kernel geometries launched in {phase}, each vs its plain version "
          f"(gate max|d| <= {TOL} max|plain|):")
    while geometries:
        (name, shape, real, *_), (gx, gy, args, kw) = geometries.popitem()
        entry = ENTRIES.get(name, name)
        got = getattr(K, entry)(gx, gy, *args, **kw)
        want = getattr(K, entry + "_plain")(gx, gy, *args, **kw)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        ok = err <= TOL * scale
        case = (f"{phase} {shape} {'real' if real else 'complex'} "
                f"{[a for a in args if not isinstance(a, dict)]} {kw or ''}")
        report["kernel_checks"].append(dict(kernel=name, case=case, max_abs_err=err, max_abs=scale,
                                            exact=False, ok=ok))
        print(f"    {name:24s} {case:56s} max|d| {err:.3e} max|plain| {scale:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")
        del got, want, gx, gy
    torch.cuda.synchronize()


def hold_fast(report: dict, name: str, case: str, got, want, truth) -> float:
    """Hold a "fast" kernel's output ``got`` against its plain version's
    ``want`` (gate max|d| <= FAST_TOL max|plain|) and both against ``truth``,
    the fp32 plain version on float64 operands (the kernel's error at most
    F64_RATIO times the plain version's); fail on either.  Returns max|d|."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    e64 = [max(float((o.double() - t).abs().max()) for o, t in zip(out, truth)) for out in (got, want)]
    ok = err <= FAST_TOL * scale and e64[0] <= F64_RATIO * e64[1]
    report["kernel_checks"].append(dict(kernel=name, case=case, max_abs_err=err, max_abs=scale, f64_err=e64[0],
                                        plain_f64_err=e64[1], exact=False, ok=ok))
    print(f"    {name:28s} {case:44s} max|d| {err:.3e} max|plain| {scale:.3e} | vs f64: kernel "
          f"{e64[0]:.3e} plain {e64[1]:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {case}: kernel disagrees with its plain version or float64")
    return err


def f64(t):
    """A tensor (or a plan's tensors) in float64; anything else as it is."""
    import torch

    if isinstance(t, dict):
        return {k: f64(v) for k, v in t.items()}
    return t.double() if isinstance(t, torch.Tensor) else t


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
    """The first kernel ``kernels/large.py:transform_any`` launches for a (b, n)
    transform (K1, K2 or K3, by ``plan.route``), or None where the torch
    engines run it."""
    from gpu_fft_tpu_torch import plan as P

    kernels = P.route(b, n).kernels
    return P.KERNELS[kernels[0]] if kernels else None


def launches_of(b: int, n: int, complex_input: bool) -> dict:
    """The launches of one ``transform_any`` call on a (b, n) batch, by
    ``plan.route``: the band's kernel, or K3 and, on complex rows, K4."""
    from gpu_fft_tpu_torch import plan as P

    return summed(*({P.KERNELS[k]: 1} for k in P.route(b, n, real_input=not complex_input).kernels))


def summed(*launches: dict, times: int = 1) -> dict:
    """Launch dicts added key by key, each ``times`` over."""
    out = {}
    for d in launches:
        for k, v in d.items():
            out[k] = out.get(k, 0) + times * v
    return out


def fno_launches(cell: dict) -> dict:
    """K1 / K3 / K4 launches of one FNO train step (forward and backward).
    Rows longer than 65,536: K3 for the forward rfft, the irfft's staged fold
    and the rfft's backward, K4 for that backward's complex stage B (the
    fold's backward is torch).  1-D rows in the
    whole band (B = batch x width): K1 for the forward rfft and irfft and
    for each one's backward.  None for the 2-D cell's 64-point rows."""
    if cell["dims"] != 1:
        return {}
    depth, size = cell["depth"], cell["size"]
    if size > 65536:
        return {"stage_a": 3 * depth, "stage_b": depth}
    kernel = band_kernel(cell["batch"] * cell["width"], size)
    return {kernel: 4 * depth} if kernel else {}


def engine(b: int, n: int, real_input: bool) -> str:
    """The engine ``kernels/large.py:transform_any`` takes for a (b, n)
    transform, as ``plan.describe_plan`` names it."""
    from gpu_fft_tpu_torch import plan as P

    d = P.describe_plan(n, b, real_input)
    return f"{d['path']}: {d['engine']}" + (f", {d['layout']}" if d["layout"] else "")


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
        # The real forward, then its backward: a complex transform of the cotangent.
        want = {k: 0 for k in launched} | summed(launches_of(1, n, False), launches_of(1, n, True))
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
    for n in periodogram_sizes:  # Bluestein: the launches of its two complex m-point transforms
        want = summed(launches_of(1, 1 << (2 * n - 2).bit_length(), True), times=2)
        got = per_size[f"periodogram {n}"]
        if n & (n - 1) and mixed_split(n) is None and got != {k: 0 for k in got} | want:
            fail(f"periodogram n={n}: launches {got}, expected {want}")
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
              f"hilbert_device {n}": {"stage_a": 2, "stage_b": 1},
              f"dct_device type 2 ortho {(1, n)}": {"stage_a": 1},
              f"idct_device type 2 ortho {(1, n)}": {"stage_a": 1},
              f"czt_device n = m = {nc}": {"stage_a": 2, "stage_b": 2},
              "czt_device n = m = 1000": {"whole_transform": 2}}
    for label, want in expect.items():
        got = {k: v for k, v in per_call[label].items() if v}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
    report.update(filter_launches=launched, filter_launches_per_call=per_call)

    # Every kernel geometry the phase launched, held against its plain version
    # on the input the path gave it (after the counts are read: these
    # launches are not the path's).
    check_geometries(report, geometries, "phase 3d")
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


def twod_phase(report: dict, dev, rng, panel=PANEL, image=IMAGE, ktaps=CONV_KERNEL, volume=VOLUME) -> dict:
    """Phase 3e: the 2-D / N-D transforms, the ndimage Fourier filters, the
    2-D convolution, NATIVE and the port's examples on the card, each call
    against numpy / scipy in float64 and counted; no plain version may run.
    Returns the launches of the phase (counted from 0)."""
    import contextlib
    import importlib
    import io

    import numpy as np
    import scipy.fft as sf
    import scipy.ndimage as nd
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt
    import gpu_fft_tpu_torch.ndimage as ndi
    from gpu_fft_tpu_torch.backends import native
    from gpu_fft_tpu_torch.examples import NAMES
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import large as L

    per_call = {}

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def cerr(re, im, ref):
        """max |(re, im) - ref| / max |ref| for a complex float64 ref."""
        return max(float(np.abs(host(re) - ref.real).max()), float(np.abs(host(im) - ref.imag).max())) \
            / float(np.abs(ref).max())

    def rerr(got, ref):
        return float(np.abs(host(got) - ref).max()) / float(np.abs(ref).max())

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
        record(report, "twod_path", f"{label} (launches {per_call.get(label.split(' vs ')[0], {})})", n, err,
               limit)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    K.reset_counts()
    geometries, restore = capture_launches(L)

    # The panel: channels x samples, K3 on the rows at B = h.
    h, w = panel
    x = rng.standard_normal((h, w)).astype(np.float32)
    xt = tensor(x)
    ref = sf.fft2(x.astype(np.float64), workers=-1)
    lbl = f"fft2_device {h} x {w}"
    yr, yi = run(lbl, lambda: gt.fft2_device(xt))
    row(f"{lbl} vs numpy f64 (rel)", h * w, cerr(yr, yi, ref), gate(h * w))
    lbl = f"ifft2_device {h} x {w}"
    br, bi = run(lbl, lambda: gt.ifft2_device(yr, yi))
    row(f"{lbl} vs input, roundtrip (rel)", h * w, max(rerr(br, x), float(bi.abs().max()) / float(np.abs(x).max())),
        gate(h * w))
    del yr, yi, br, bi
    lbl = f"rfft2_device {h} x {w}"
    hr, hi = run(lbl, lambda: gt.rfft2_device(xt))
    row(f"{lbl} vs numpy f64 (rel)", h * w, cerr(hr, hi, ref[:, : w // 2 + 1]), gate(h * w))
    del ref
    lbl = f"irfft2_device {h} x {w}"
    back = run(lbl, lambda: gt.irfft2_device(hr, hi))
    row(f"{lbl} vs input, roundtrip (rel)", h * w, rerr(back, x), gate(h * w))
    del hr, hi, back, xt, x

    # The image, through the host forms (numpy in and out).
    img = rng.standard_normal((image, image)).astype(np.float32)
    img64 = img.astype(np.float64)
    iref = sf.fft2(img64, workers=-1)
    nn = image * image
    lbl = f"fft2 {image} x {image}"
    re, im = run(lbl, lambda: gt.fft2(img, device=dev))
    row(f"{lbl} vs numpy f64 (rel)", nn, cerr(re, im, iref), gate(nn))
    lbl = f"ifft2 {image} x {image}"
    br, bi = run(lbl, lambda: gt.ifft2(re, im, device=dev))
    row(f"{lbl} vs input, roundtrip (rel)", nn, max(rerr(br, img64), float(np.abs(bi).max()) / float(np.abs(img).max())),
        gate(nn))
    lbl = f"rfft2 {image} x {image}"
    hr, hi = run(lbl, lambda: gt.rfft2(img, device=dev))
    row(f"{lbl} vs numpy f64 (rel)", nn, cerr(hr, hi, iref[:, : image // 2 + 1]), gate(nn))
    lbl = f"irfft2 {image} x {image}"
    back = run(lbl, lambda: gt.irfft2(hr, hi, device=dev))
    row(f"{lbl} vs input, roundtrip (rel)", nn, rerr(back, img64), gate(nn))
    del re, im, br, bi, hr, hi, back

    # The image convolved with a 33 x 33 kernel: both padded to 8,192^2.
    kern = rng.standard_normal((ktaps, ktaps)).astype(np.float32)
    img_t = tensor(img)
    m = 1 << (image + ktaps - 2).bit_length()
    lbl = f"fft_convolve2d_device {image}^2 * {ktaps}^2 (m = {m}^2)"
    conv = run(lbl, lambda: gt.fft_convolve2d_device(img_t, tensor(kern)))
    cref = ss.fftconvolve(img64, kern.astype(np.float64))
    row(f"{lbl} vs scipy.signal.fftconvolve f64 (rel)", m * m, rerr(conv, cref), 2 * gate(m * m))
    del conv, cref

    # The volume: every axis on the direct product.
    vol = rng.standard_normal((volume,) * 3).astype(np.float32)
    vol64 = vol.astype(np.float64)
    vt = tensor(vol)
    nv = volume ** 3
    vref = sf.fftn(vol64, workers=-1)
    lbl = f"fftn_device {volume}^3"
    yr, yi = run(lbl, lambda: gt.fftn_device(vt))
    row(f"{lbl} vs numpy f64 (rel)", nv, cerr(yr, yi, vref), gate(nv))
    lbl = f"ifftn_device {volume}^3"
    br, bi = run(lbl, lambda: gt.ifftn_device(yr, yi))
    row(f"{lbl} vs input, roundtrip (rel)", nv, max(rerr(br, vol64), float(bi.abs().max()) / float(np.abs(vol).max())),
        gate(nv))
    del yr, yi, br, bi
    lbl = f"rfftn_device {volume}^3"
    hr, hi = run(lbl, lambda: gt.rfftn_device(vt))
    row(f"{lbl} vs numpy f64 (rel)", nv, cerr(hr, hi, vref[..., : volume // 2 + 1]), gate(nv))
    lbl = f"irfftn_device {volume}^3"
    back = run(lbl, lambda: gt.irfftn_device(hr, hi))
    row(f"{lbl} vs input, roundtrip (rel)", nv, rerr(back, vol64), gate(nv))
    del hr, hi, back, vt, vref

    # fftn of a 1-D array: the band's kernels.
    for n in (1024, 16384):
        x1 = rng.standard_normal(n).astype(np.float32)
        lbl = f"fftn_device 1-D {n}"
        yr, yi = run(lbl, lambda: gt.fftn_device(tensor(x1)))
        row(f"{lbl} vs numpy f64 (rel)", n, cerr(yr, yi, np.fft.fft(x1.astype(np.float64))), gate(n))

    # The ndimage Fourier filters on the image's spectrum, then ifft2: each
    # filtered spectrum against scipy.ndimage on the same float32 spectrum
    # (tests/test_ndimage_fourier.py's gate, 2e-6 of max(1, max|ref|)), each
    # image against numpy's float64 inverse of scipy's spectrum.
    lbl = f"fft2_device {image} x {image} spectrum"
    fr, fi = run(lbl, lambda: gt.fft2_device(img_t))
    spec = host(fr).astype(np.float64) + 1j * host(fi)
    for name, param in (("fourier_gaussian", 3.0), ("fourier_uniform", 9.0), ("fourier_ellipsoid", 9.0),
                        ("fourier_shift", (10.5, -20.25))):
        lbl = f"{name}_device {image}^2"
        gr, gi = run(lbl, lambda name=name, param=param: getattr(ndi, f"{name}_device")(fr, fi, param))
        fref = getattr(nd, name)(spec, param)
        scale = max(1.0, float(np.abs(fref).max()))
        row(f"{lbl} vs scipy.ndimage (abs / max(1, max|ref|))", nn,
            max(float(np.abs(host(gr) - fref.real).max()), float(np.abs(host(gi) - fref.imag).max())) / scale,
            2e-6)
        lbl = f"ifft2_device after {name} {image}^2"
        br, bi = run(lbl, lambda gr=gr, gi=gi: gt.ifft2_device(gr, gi))
        row(f"{lbl} vs numpy f64 (rel)", nn, cerr(br, bi, sf.ifft2(fref, workers=-1)), gate(nn))
        del gr, gi, br, bi, fref
    del fr, fi, spec, img_t

    # NATIVE: the host library, built here where it is missing.
    if not native.is_available():
        proc = subprocess.run(["make", "-C", str(ROOT / "native")], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"make -C native failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        native._load.cache_clear()
    if not native.is_available():
        fail(f"the NATIVE library does not load from {native.lib_path()}")
    print(f"  NATIVE: {native.lib_path()}")
    for n in NATIVE_SIZES:
        x1 = rng.standard_normal(n).astype(np.float32)
        lbl = f"fft_native {n}"
        re, im = run(lbl, lambda: gt.fft_native(x1))
        row(f"{lbl} vs numpy f64 (rel)", n, cerr(re, im, np.fft.fft(x1.astype(np.float64))), gate(n))
        lbl = f"ifft_native {n}"
        out = run(lbl, lambda: gt.ifft_native(re, im))
        row(f"{lbl} vs input, roundtrip (rel)", n, max(rerr(out[:n], x1), float(np.abs(out[n:]).max()) / float(np.abs(x1).max())),
            gate(n))
    n = NATIVE_SIZES[-1]
    xs = rng.standard_normal((NATIVE_BATCH, n)).astype(np.float32)
    lbl = f"fft_batch(backend=NATIVE) B={NATIVE_BATCH} n={n}"
    specs = run(lbl, lambda: gt.fft_batch(list(xs), backend=gt.Backend.NATIVE))
    bref = np.fft.fft(xs.astype(np.float64), axis=-1)
    row(f"{lbl} vs numpy f64 (rel)", n,
        cerr(np.stack([r for r, _ in specs]), np.stack([i for _, i in specs]), bref), gate(n))

    # The port's examples on the card, each to its own OK gate.
    report["examples"] = {}
    for name in NAMES:
        mod = importlib.import_module(f"gpu_fft_tpu_torch.examples.{name}")
        buf = io.StringIO()
        lbl = f"example {name}"
        with contextlib.redirect_stdout(buf):
            rc = run(lbl, lambda mod=mod: mod.main(device=dev))
        out = buf.getvalue()
        print(f"  {lbl} (launches {per_call[lbl]}):")
        for line in out.splitlines():
            print(f"    | {line}")
        last = out.strip().splitlines()[-1] if out.strip() else ""
        ok = rc == 0 and "FAIL" not in out and last.endswith(EXAMPLE_GATES.get(name, "[OK]"))
        if name == "backends":
            ok &= "NATIVE" in out
        if name == "simple":
            ok &= "Dominant frequency: 15.04 Hz" in out
        report["examples"][name] = dict(ok=ok, rc=rc, output=out, launches=per_call[lbl])
        if not ok:
            fail(f"{lbl}: no OK gate (rc {rc}): {out[-500:]}")

    restore()
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    plain = sum(c.plain_calls for c in K.COUNTS.values())
    print(f"  launches in phase 3e: {launched}; plain calls {plain}")
    for label, got in per_call.items():
        print(f"    {label}: {got}")
    if plain:
        fail(f"phase 3e ran {plain} plain kernel versions on the card")
    # The rows by K3; K4 after it where the rows are complex (the inverses).
    expect = {**{f"{f} {h} x {w}": {"stage_a": 1} for f in ("fft2_device", "rfft2_device")},
              **{f"{f} {h} x {w}": {"stage_a": 1, "stage_b": 1} for f in ("ifft2_device", "irfft2_device")},
              # K1 on the rows and on the columns (B = 4,096 and 2,049 in the band)
              **{f"{f} {image} x {image}": {"whole_transform": 2} for f in ("fft2", "ifft2", "rfft2", "irfft2")},
              f"fft_convolve2d_device {image}^2 * {ktaps}^2 (m = {m}^2)": {},
              **{f"{f} {volume}^3": {} for f in ("fftn_device", "ifftn_device", "rfftn_device", "irfftn_device")},
              f"fft2_device {image} x {image} spectrum": {"whole_transform": 2},
              "fftn_device 1-D 1024": {"whole_transform_packed": 1},
              "fftn_device 1-D 16384": {"whole_transform": 1},
              **{label: {} for label in per_call if label.startswith(("fourier_", "fft_native", "ifft_native",
                                                                      "fft_batch"))},
              **{label: {"whole_transform": 2} for label in per_call if label.startswith("ifft2_device after")}}
    for label, want in expect.items():
        got = {k: v for k, v in per_call[label].items() if v}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
    report.update(twod_launches=launched, twod_launches_per_call=per_call)

    # Every kernel geometry the phase launched, held against its plain
    # version on the input the path gave it (K3 at B = 512 among them).
    if not any(name == "stage_a" and shape[0] == h for name, shape, *_ in geometries):
        fail(f"K3 was not launched at B = {h} on the panel's rows")
    check_geometries(report, geometries, "phase 3e")
    return launched


def twod_times(report: dict, dev) -> None:
    """Phase 4's rows for the 2-D / N-D path, each beside its torch.fft
    counterpart in the same call: CUDA events and profiler device time."""
    import torch

    import gpu_fft_tpu_torch as gt

    gen = torch.Generator(device=dev).manual_seed(11)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def row(label, port_fn, torch_fn, torch_name, iters=5):
        ms = cuda_ms(port_fn, iters=iters, repeats=3)
        dev_ms, top = device_ms(port_fn, iters=iters, top=6)
        tms, (tdev_ms, _) = cuda_ms(torch_fn, iters=iters, repeats=3), device_ms(torch_fn, iters=iters)
        report["times"].append(dict(what=label, ms=ms, torch_ms=tms, torch_call=torch_name, device_ms=dev_ms,
                                    torch_device_ms=tdev_ms, top_kernels=top))
        print(f"  {label:44s} events: port {ms:.4f} ms {torch_name} {tms:.4f} ms | device: port {fmt(dev_ms)}"
              f" {torch_name} {fmt(tdev_ms)}")
        print(f"    top kernels: {[(k, round(v, 4)) for k, v in top]}")

    h, w = PANEL
    for shape in ((h, w), (IMAGE, IMAGE)):
        x = torch.randn(*shape, generator=gen, device=dev)
        row(f"fft2_device {shape}", lambda x=x: gt.fft2_device(x), lambda x=x: torch.fft.fft2(x), "torch.fft.fft2")
        hr, hi = (t.contiguous() for t in gt.rfft2_device(x))
        z = torch.complex(hr, hi)
        row(f"rfft2_device {shape}", lambda x=x: gt.rfft2_device(x), lambda x=x: torch.fft.rfft2(x),
            "torch.fft.rfft2")
        row(f"irfft2_device {shape}", lambda hr=hr, hi=hi: gt.irfft2_device(hr, hi),
            lambda z=z, shape=shape: torch.fft.irfft2(z, s=shape), "torch.fft.irfft2")
        del x, hr, hi, z
    img = torch.randn(IMAGE, IMAGE, generator=gen, device=dev)
    kern = torch.randn(CONV_KERNEL, CONV_KERNEL, generator=gen, device=dev)
    m = 1 << (IMAGE + CONV_KERNEL - 2).bit_length()
    out = IMAGE + CONV_KERNEL - 1

    def torch_conv():
        return torch.fft.irfft2(torch.fft.rfft2(img, s=(m, m)) * torch.fft.rfft2(kern, s=(m, m)),
                                s=(m, m))[:out, :out]

    row(f"fft_convolve2d_device {IMAGE}^2 * {CONV_KERNEL}^2", lambda: gt.fft_convolve2d_device(img, kern),
        torch_conv, "torch.fft.rfft2*rfft2->irfft2")
    vol = torch.randn(VOLUME, VOLUME, VOLUME, generator=gen, device=dev)
    row(f"fftn_device {VOLUME}^3", lambda: gt.fftn_device(vol), lambda: torch.fft.fftn(vol), "torch.fft.fftn")


def counted(per_call: dict, label: str, fn, want: dict):
    """``fn()`` with the launches it made kept under ``per_call[label]``;
    fails on a plain call, or where the kernels that ran and their counts
    are not ``want`` (None: not pinned)."""
    import torch

    before = counts()
    out = fn()
    torch.cuda.synchronize()
    per_call[label], plain = count_delta(before)
    if plain:
        fail(f"{label}: {plain} plain kernel versions ran on the card")
    got = {k: v for k, v in per_call[label].items() if v}
    if want is not None and got != {k: v for k, v in want.items() if v}:
        fail(f"{label}: launches {got}, expected {want}")
    return out


def namespace_phase(report: dict, dev, rng) -> dict:
    """Phase 3f, first half: the scipy.fft namespace (``compat``) on CUDA
    complex64 tensors and through ``scipy.fft.set_backend(compat.backend)``
    on numpy input, and the scipy.signal namespace, each against scipy in
    float64 without the backend; each call's launches pinned, no plain
    call, then every kernel geometry it launched against its plain
    version.  Returns the launches of this half (counted from 0)."""
    import numpy as np
    import scipy
    import scipy.fft as sf
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt
    import gpu_fft_tpu_torch.compat as cf
    import gpu_fft_tpu_torch.signal as sg
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import large as L

    print(f"  scipy {scipy.__version__}")
    per_call = {}

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def rel(got, ref, floor=0.0):
        return float(np.abs(host(got) - ref).max()) / max(floor, float(np.abs(ref).max()))

    def both(label, n, name, a, ref, want, limit, floor=0.0, **kw):
        """``compat.<name>`` on the CUDA tensor of ``a`` and ``scipy.fft.<name>``
        under the backend on ``a`` itself, each against ``ref``."""
        t = torch.from_numpy(a).to(dev)
        got = counted(per_call, f"compat.{label} (tensor)", lambda: getattr(cf, name)(t, **kw), want)
        if not (isinstance(got, torch.Tensor) and got.device == t.device):
            fail(f"compat.{label}: a tensor on {t.device} in gave {type(got)} out")
        record(report, "namespace_path", f"compat.{label} on a CUDA tensor vs scipy f64 (launches {want})", n,
               rel(got, ref, floor), limit)
        with sf.set_backend(cf.backend):
            got = counted(per_call, f"compat.{label} (backend)", lambda: getattr(sf, name)(a, **kw), want)
        if not isinstance(got, np.ndarray) or got.dtype not in (np.complex64, np.float32):
            fail(f"scipy.fft.{name} under the backend returned {type(got)} {getattr(got, 'dtype', '')}")
        record(report, "namespace_path", f"scipy.fft.{label} under compat.backend vs scipy f64", n,
               rel(got, ref, floor), limit)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    K.reset_counts()
    geometries, restore = capture_launches(L)

    # scipy.fft: 5*log2(N)*eps of max|ref| for powers of two, the JAX
    # tests' 3e-5 of max(1, max|ref|) elsewhere.
    for n, want in COMPAT_FFT:
        z = cplx(n)
        limit, floor = (gate(n), 0.0) if n & (n - 1) == 0 else (3e-5, 1.0)
        for name in ("fft", "ifft"):
            both(f"{name} {n}", n, name, z, getattr(sf, name)(z.astype(np.complex128)), want, limit, floor)
    for n, want in COMPAT_REAL:
        x = rng.standard_normal(n).astype(np.float32)
        both(f"rfft {n}", n, "rfft", x, sf.rfft(x.astype(np.float64)), want, gate(n))
        h = cplx(n // 2 + 1)
        both(f"irfft {n}", n, "irfft", h, sf.irfft(h.astype(np.complex128)), want, gate(n))
    m = COMPAT_IMAGE
    img, zimg, himg = rng.standard_normal((m, m)).astype(np.float32), cplx(m, m), cplx(m, m // 2 + 1)
    both(f"fftn {m}x{m}", m * m, "fftn", zimg, sf.fftn(zimg.astype(np.complex128)), {}, gate(m * m))
    both(f"rfftn {m}x{m}", m * m, "rfftn", img, sf.rfftn(img.astype(np.float64)), {}, gate(m * m))
    both(f"irfftn {m}x{m}", m * m, "irfftn", himg, sf.irfftn(himg.astype(np.complex128)), {}, gate(m * m))
    both(f"dctn ortho {m}x{m}", m * m, "dctn", img, sf.dctn(img.astype(np.float64), norm="ortho"), {}, 3e-5,
         1.0, norm="ortho")
    h = cplx(2049)
    both("hfft 4096", 4096, "hfft", h, sf.hfft(h.astype(np.complex128)), {"whole_transform": 1}, gate(4096))

    # scipy.signal, on the JAX tests' gates.
    def sig_row(label, n, err, limit):
        ran = {k: v for k, v in per_call[label.split(" vs ")[0]].items() if v}
        record(report, "namespace_path", f"{label} (launches {ran})", n, err, limit)

    n = SIGNAL_HILBERT
    x = rng.standard_normal(n).astype(np.float32)
    lbl = f"signal.hilbert {n}"
    got = counted(per_call, lbl, lambda: sg.hilbert(x), {"stage_a": 2, "stage_b": 1})
    sig_row(f"{lbl} vs scipy.signal f64 (rel)", n, rel(got, ss.hilbert(x.astype(np.float64))), 3e-5)
    b, n, seg = SIGNAL_CSD
    xs, ys = rng.standard_normal((b, n)).astype(np.float32), rng.standard_normal((b, n)).astype(np.float32)
    lbl = f"signal.csd ({b}, {n}) / {seg}"
    f, pxy = counted(per_call, lbl, lambda: sg.csd(xs, ys, fs=1e3, nperseg=seg), {"whole_transform": 2})
    fr, pref = ss.csd(xs.astype(np.float64), ys.astype(np.float64), fs=1e3, nperseg=seg)
    if not (np.iscomplexobj(pxy) and np.allclose(f, fr)):
        fail(f"{lbl}: not complex, or its frequencies differ from scipy's")
    sig_row(f"{lbl} vs scipy.signal f64 (rel)", seg, rel(pxy, pref), 1e-4)
    n, seg = SIGNAL_STFT
    x = rng.standard_normal(n).astype(np.float32)
    lbl = f"signal.stft {n} / {seg}"
    f, t, zxx = counted(per_call, lbl, lambda: sg.stft(x, fs=1e3, nperseg=seg), {})
    fr, tr, zref = ss.stft(x.astype(np.float64), fs=1e3, nperseg=seg)
    if not (np.allclose(f, fr) and np.allclose(t, tr)):
        fail(f"{lbl}: its frequencies or times differ from scipy's")
    sig_row(f"{lbl} vs scipy.signal f64 (rel)", seg, rel(zxx, zref), 1e-4)
    lbl = f"signal.istft {n} / {seg}"
    _, back = counted(per_call, lbl, lambda: sg.istft(zxx, fs=1e3, nperseg=seg), {})
    if back.shape != ss.istft(zref, fs=1e3, nperseg=seg)[1].shape:
        fail(f"{lbl}: shape {back.shape} differs from scipy's")
    sig_row(f"{lbl} vs input, roundtrip (abs)", seg, float(np.abs(back[:n] - x).max()), 1e-3)
    x = rng.standard_normal(1000).astype(np.float32)
    lbl = "signal.czt 1000"
    got = counted(per_call, lbl, lambda: sg.czt(x), {"whole_transform": 2})
    sig_row(f"{lbl} vs scipy.signal f64 (rel)", 1000, rel(got, ss.czt(x.astype(np.float64))), 3e-5)
    lbl = f"hilbert2 {m}x{m}"
    got = counted(per_call, lbl, lambda: gt.hilbert2(img), {})
    sig_row(f"{lbl} vs scipy.signal f64 (rel)", m * m, rel(got, ss.hilbert2(img.astype(np.float64))), 1e-5)
    n, bp = SIGNAL_ENVELOPE
    t = np.arange(n) / n
    x = (np.sin(2 * np.pi * 300 * t) * (1 + 0.5 * np.cos(2 * np.pi * 7 * t))
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    lbl = f"signal.envelope {n} bp_in={bp}"
    got = counted(per_call, lbl, lambda: sg.envelope(x, bp), {"whole_transform": 2})
    ref = ss.envelope(x.astype(np.float64), bp)
    # the JAX test's assert_allclose(atol=2e-4, rtol=1e-3) as one number
    sig_row(f"{lbl} vs scipy.signal f64 (|d| - 1e-3 |ref|)", n,
            float((np.abs(got - ref) - 1e-3 * np.abs(ref)).max()), 2e-4)

    restore()
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    print(f"  launches in phase 3f's namespaces: {launched}")
    report.update(namespace_launches=launched, namespace_launches_per_call=per_call)
    check_geometries(report, geometries, "phase 3f namespaces")
    return launched


def fno_data(cell: dict, seed: int):
    """Synthetic fields at a cell's shapes, from ``seed``: band-limited
    random fields and their heat-equation evolution, (x, y) channels-last
    float32.  1-D (Burgers' shapes): u0 -> u(t); 2-D (Navier-Stokes'):
    ``in_channels`` steps of a field -> the next one."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, s, c = cell["batch"], cell["size"], cell["in_channels"]
    k = np.fft.fftfreq(s, 1.0 / s)
    if cell["dims"] == 1:
        spec = np.zeros((b, s), complex)
        spec[:, 1:17] = (rng.standard_normal((b, 16)) + 1j * rng.standard_normal((b, 16))) / np.arange(1, 17)
        u0 = np.fft.ifft(spec, axis=-1).real * s
        u1 = np.fft.ifft(spec * np.exp(-0.002 * k ** 2), axis=-1).real * s
        return u0[..., None].astype(np.float32), u1[..., None].astype(np.float32)
    kk = k[:, None] ** 2 + k[None, :] ** 2
    spec = (rng.standard_normal((b, s, s)) + 1j * rng.standard_normal((b, s, s))) * (kk <= 64) / (1 + kk)
    steps = [np.fft.ifft2(spec * np.exp(-0.01 * kk * i)).real * s for i in range(c + 1)]
    return np.stack(steps[:c], axis=-1).astype(np.float32), steps[c][..., None].astype(np.float32)


def fno_model(cell: dict, dev, seed: int):
    """The port's FNO of a cell, its weights drawn from ``seed``."""
    import torch

    from gpu_fft_tpu_torch.models import FNO1d, FNO2d

    common = dict(width=cell["width"], depth=cell["depth"], in_channels=cell["in_channels"], device=dev,
                  generator=torch.Generator().manual_seed(seed))
    if cell["dims"] == 1:
        return FNO1d(modes=cell["modes"], **common)
    return FNO2d(modes1=cell["modes"], modes2=cell["modes"], **common)


def fft_twin(model, dtype):
    """A copy of the port's FNO ``model`` in ``dtype`` whose spectral layers
    run their transforms on ``torch.fft`` (``rfft`` / ``irfft``, ``rfft2`` /
    ``irfft2``): the same parameters under the same names and the same
    channel mix; nothing else changes.  In float64 the reference of the
    phase 3f checks, in float32 phase 4's library call."""
    import copy

    import torch
    import torch.nn.functional as F

    from gpu_fft_tpu_torch.models.fno import _cmul_mix

    class Spectral(torch.nn.Module):
        def __init__(self, spec):
            super().__init__()
            for name, p in spec.named_parameters(recurse=False):
                self.register_parameter(name, p)
            self.modes = tuple(getattr(spec, a, None) for a in ("modes", "modes1", "modes2"))

        def forward(self, x):
            if x.dim() == 3:
                length, m = x.shape[1], self.modes[0]
                half = length // 2 + 1
                y = torch.fft.rfft(x.permute(0, 2, 1), dim=-1)[..., :m]
                zr, zi = _cmul_mix(y.real, y.imag, self.w_real, self.w_imag)
                z = torch.complex(F.pad(zr, (0, half - m)), F.pad(zi, (0, half - m)))
                return torch.fft.irfft(z, n=length, dim=-1).permute(0, 2, 1)
            b, h, w, _ = x.shape
            _, m1, m2 = self.modes
            hw = w // 2 + 1
            y = torch.fft.rfft2(x.permute(0, 3, 1, 2))
            tr, ti = _cmul_mix(y.real[:, :, :m1, :m2], y.imag[:, :, :m1, :m2], self.w1_real, self.w1_imag)
            br, bi = _cmul_mix(y.real[:, :, h - m1:, :m2], y.imag[:, :, h - m1:, :m2], self.w2_real, self.w2_imag)
            gap = tr.new_zeros(b, tr.shape[1], h - 2 * m1, m2)
            zr = F.pad(torch.cat([tr, gap, br], dim=2), (0, hw - m2))
            zi = F.pad(torch.cat([ti, gap, bi], dim=2), (0, hw - m2))
            return torch.fft.irfft2(torch.complex(zr, zi), s=(h, w)).permute(0, 2, 3, 1)

    twin = copy.deepcopy(model).to(dtype)
    for i in range(model.depth):
        setattr(twin, f"spec{i}", Spectral(getattr(twin, f"spec{i}")))
    return twin


def fno_phase(report: dict, dev) -> dict:
    """Phase 3f, second half: the FNO cells (a)-(c) at the published widths
    on the card: one forward and backward against the float64 twin
    (``fft_twin``; output 2*5*log2(N)*eps of max|twin|, every parameter's
    gradient 1e-4 of max|twin's|), then ``FNO_STEPS`` Adam steps (lr 1e-3)
    whose loss must fall; launches pinned (K3 three times and K4 once a
    layer at 2^18, none at the published grids), no plain call, every geometry
    against its plain version; then ``python -m
    gpu_fft_tpu_torch.examples.fno`` to its OK line.  Returns the launches
    of this half (counted from 0)."""
    import math
    import os

    import torch

    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import large as L
    from gpu_fft_tpu_torch.models import make_train_step, mse

    per_call = {}
    K.reset_counts()
    geometries, restore = capture_launches(L)
    report["fno"] = {}
    for name, cell in FNO_CELLS.items():
        x_np, y_np = fno_data(cell, seed=ord(name))
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        model = fno_model(cell, dev, seed=ord(name))
        n = cell["size"] ** cell["dims"]
        want = fno_launches(cell)
        lbl = f"FNO({name}) forward + backward {tuple(x.shape)}"

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            out = model(x)
            mse(out, y).backward()
            return out.detach()

        out = counted(per_call, lbl, fwd_bwd, want)
        twin = fft_twin(model, torch.float64)
        tout = twin(x.double())
        mse(tout, y.double()).backward()
        tout = tout.detach()
        record(report, "fno_path", f"{lbl} output vs the f64 twin (rel)", n,
               float((out.double() - tout).abs().max()) / float(tout.abs().max()), 2 * gate(n))
        twin_p = dict(twin.named_parameters())
        worst = max((float((p.grad.double() - twin_p[k].grad).abs().max()) / float(twin_p[k].grad.abs().max()), k)
                    for k, p in model.named_parameters())
        record(report, "fno_path", f"{lbl} worst gradient ({worst[1]}) vs the f64 twin (rel)", n, worst[0], 1e-4)
        del twin, tout, twin_p, out
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
        lbl = f"FNO({name}) {FNO_STEPS} Adam steps"
        losses = counted(per_call, lbl, lambda: [float(step(x, y)) for _ in range(FNO_STEPS)],
                         {k: v * FNO_STEPS for k, v in want.items()})
        print(f"  {lbl}: loss {losses[0]:.6g} -> {losses[-1]:.6g} "
              f"(launches {({k: v for k, v in per_call[lbl].items() if v})})")
        report["fno"][name] = dict(cell=cell, losses=losses, launches=per_call[lbl])
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            fail(f"{lbl}: the loss did not fall: {losses}")
        del model, step, x, y
        torch.cuda.empty_cache()
    restore()
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    print(f"  launches in phase 3f's FNO cells: {launched}")
    report.update(fno_launches=launched, fno_launches_per_call=per_call)
    check_geometries(report, geometries, "phase 3f FNO")

    # The example as a user runs it: its own process, on the card by default.
    env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "gpu_fft_tpu_torch.examples.fno"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"    | {line}")
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    report["example_fno_module"] = dict(rc=proc.returncode, output=proc.stdout)
    if proc.returncode != 0 or last != EXAMPLE_GATES["fno"]:
        fail(f"python -m gpu_fft_tpu_torch.examples.fno: rc {proc.returncode}, last line {last!r}: "
             f"{proc.stderr[-1000:]}")
    return launched


def namespace_fno_times(report: dict, dev) -> None:
    """Phase 4's rows for phase 3f: ``compat.fft`` beside ``torch.fft.fft``,
    and each FNO cell's train step beside the same model with its spectral
    layers on torch.fft in f32 (the library call, ``fft_twin``); CUDA
    events and profiler device time, the top device kernels of each."""
    import torch

    import gpu_fft_tpu_torch.compat as cf
    from gpu_fft_tpu_torch.models import make_train_step

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def row(label, port_fn, torch_fn, torch_name, iters):
        ms = cuda_ms(port_fn, iters=iters, repeats=3)
        dev_ms, top = device_ms(port_fn, iters=iters, top=8)
        ours_ms, _ = device_ms(port_fn, iters=iters, attempts=2, match="gft::")  # K1 / K2 / K3
        tms = cuda_ms(torch_fn, iters=iters, repeats=3)
        tdev_ms, ttop = device_ms(torch_fn, iters=iters, top=8)
        report["times"].append(dict(what=label, ms=ms, torch_ms=tms, torch_call=torch_name, device_ms=dev_ms,
                                    own_kernels_device_ms=ours_ms, torch_device_ms=tdev_ms, top_kernels=top,
                                    torch_top_kernels=ttop))
        print(f"  {label:44s} events: port {ms:.4f} ms {torch_name} {tms:.4f} ms | device: port {fmt(dev_ms)}"
              f" (own kernels {fmt(ours_ms)}) {torch_name} {fmt(tdev_ms)}")
        print(f"    top kernels: {[(k, round(v, 4)) for k, v in top]}")
        print(f"    {torch_name} top kernels: {[(k, round(v, 4)) for k, v in ttop]}")

    gen = torch.Generator(device=dev).manual_seed(12)
    for n in (4096, 1 << 20):
        z = torch.complex(torch.randn(n, generator=gen, device=dev), torch.randn(n, generator=gen, device=dev))
        row(f"compat.fft {n} complex", lambda z=z: cf.fft(z), lambda z=z: torch.fft.fft(z), "torch.fft.fft", 20)
    for name, cell in FNO_CELLS.items():
        x_np, y_np = fno_data(cell, seed=ord(name))
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        model = fno_model(cell, dev, seed=ord(name))
        twin = fft_twin(model, torch.float32)
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
        tstep = make_train_step(twin, torch.optim.Adam(twin.parameters(), lr=1e-3))
        row(f"FNO({name}) train step {tuple(x.shape)}", lambda: step(x, y), lambda: tstep(x, y),
            "the model on torch.fft", 5)
        del model, twin, step, tstep, x, y
        torch.cuda.empty_cache()


@contextlib.contextmanager
def nccl_world(dev):
    """A one-rank NCCL process group on ``dev`` (store in memory) for the
    parallel layer, destroyed on the way out."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def parallel_meshes():
    """The meshes of phase 3g: ``default_mesh()`` ("dp",) on the card and the
    (dp, sp) and (dp, tp) meshes, each of size 1."""
    from torch.distributed.device_mesh import init_device_mesh

    import gpu_fft_tpu_torch.parallel as tp

    return (tp.default_mesh(), init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "sp")),
            init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "tp")))


def parallel_phase(report: dict, dev, rng) -> dict:
    """Phase 3g: the parallel layer at world size 1 over NCCL (real
    collectives and DTensors, the local kernels at full size), the mesh
    train steps, serving artifacts and the CLI,
    each against numpy / scipy in float64 or the single-device counterpart;
    each call's launches pinned, no plain call, then every geometry it
    launched against its plain version.  Returns the launches of the phase
    (counted from 0)."""
    import copy
    import math
    import os
    import tempfile

    import numpy as np
    import scipy.fft as sf
    import scipy.signal as ss
    import torch

    import gpu_fft_tpu_torch as gt
    import gpu_fft_tpu_torch.parallel as tp
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import large as L
    from gpu_fft_tpu_torch.models import make_data_parallel_step, make_gspmd_step, make_train_step
    from gpu_fft_tpu_torch.parallel.distributed import _split_for_mesh
    from gpu_fft_tpu_torch.utils import serving

    per_call = {}

    def host(a):
        if hasattr(a, "full_tensor"):
            a = a.full_tensor()
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def cerr(re, im, ref):
        return max(float(np.abs(host(re) - ref.real).max()), float(np.abs(host(im) - ref.imag).max())) \
            / float(np.abs(ref).max())

    def rerr(got, ref):
        return float(np.abs(host(got) - ref).max()) / float(np.abs(ref).max())

    def row(label, n, err, limit):
        record(report, "parallel_path", f"{label} (launches {({k: v for k, v in per_call[label.split(' vs ')[0]].items() if v})})",
               n, err, limit)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def once(*shapes):
        """The launches of one transform_any call per (rows, n)."""
        want = {}
        for b, n in shapes:
            k = band_kernel(b, n)
            if k:
                want[k] = want.get(k, 0) + 1
        return want

    K.reset_counts()
    geometries, restore = capture_launches(L)
    with nccl_world(dev):
        mesh, mesh_sp, mesh_tp = parallel_meshes()
        print(f"  meshes: {mesh} {mesh_sp} {mesh_tp} (NCCL, world size 1)")

        # The four-step with the all-to-all transpose.
        for b, n in DIST_SHAPES:
            x = rng.standard_normal((b, n)).astype(np.float32)
            xt = tensor(x)
            n1, n2 = _split_for_mesh(n, 1)
            want = once((b * n2, n1), (b * n1, n2))
            lbl = f"distributed_fft ({b}, {n})"
            yr, yi = counted(per_call, lbl, lambda: tp.distributed_fft(xt, mesh_sp, "sp", "dp"), want)
            row(f"{lbl} vs numpy f64 (rel)", n, cerr(yr, yi, sf.fft(x.astype(np.float64), axis=-1, workers=-1)),
                gate(n))
            lbl = f"distributed_ifft ({b}, {n})"
            br, bi = counted(per_call, lbl, lambda: tp.distributed_ifft(yr, yi, mesh_sp, "sp", "dp"), want)
            row(f"{lbl} vs input, roundtrip (rel)", n,
                max(rerr(br, x), float(np.abs(host(bi)).max()) / float(np.abs(x).max())), gate(n))
            del xt, yr, yi, br, bi

        # The pencil on phase 3e's panel: K3 on its rows at B = 512, each way.
        h, w = PANEL
        x = rng.standard_normal((h, w)).astype(np.float32)
        xt = tensor(x)
        ref = sf.fft2(x.astype(np.float64), workers=-1)
        lbl = f"fft2_sharded {h} x {w}"
        yr, yi = counted(per_call, lbl, lambda: tp.fft2_sharded(xt, mesh, sp_axis="dp"), {"stage_a": 1})
        if [str(p) for p in yr.placements] != [str(p) for p in tp._sharding.placements(mesh, {"dp": 0})]:
            fail(f"{lbl}: output placements {yr.placements}, not the input's rows")
        row(f"{lbl} vs numpy f64 (rel)", h * w, cerr(yr, yi, ref), gate(h * w))
        del ref
        lbl = f"ifft2_sharded {h} x {w}"
        br, bi = counted(per_call, lbl, lambda: tp.ifft2_sharded(yr, yi, mesh, sp_axis="dp"),
                         {"stage_a": 1, "stage_b": 1})
        row(f"{lbl} vs input, roundtrip (rel)", h * w,
            max(rerr(br, x), float(np.abs(host(bi)).max()) / float(np.abs(x).max())), gate(h * w))
        del xt, yr, yi, br, bi, x
        v = VOLUME
        x = rng.standard_normal((v, v, v)).astype(np.float32)
        lbl = f"fftn_sharded {v}^3"
        yr, yi = counted(per_call, lbl, lambda: tp.fftn_sharded(tensor(x), mesh, sp_axis="dp"), {})
        row(f"{lbl} vs numpy f64 (rel)", v ** 3, cerr(yr, yi, sf.fftn(x.astype(np.float64), workers=-1)),
            gate(v ** 3))
        del yr, yi

        # Batch sharding: no collective.
        for b, n in BATCH_SHARDED:
            x = rng.standard_normal((b, n)).astype(np.float32)
            lbl = f"fft_batch_sharded ({b}, {n})"
            yr, yi = counted(per_call, lbl, lambda: tp.fft_batch_sharded(tensor(x), mesh), launches_of(b, n, False))
            row(f"{lbl} vs numpy f64 (rel)", n, cerr(yr, yi, np.fft.fft(x.astype(np.float64), axis=-1)), gate(n))
            lbl = f"ifft_batch_sharded ({b}, {n})"
            br, _ = counted(per_call, lbl, lambda: tp.ifft_batch_sharded(yr, yi, mesh), launches_of(b, n, True))
            row(f"{lbl} vs input, roundtrip (rel)", n, rerr(br, x), gate(n))
        b, hh, ww = BATCH_2D
        x = rng.standard_normal(BATCH_2D).astype(np.float32)
        lbl = f"fft2_batch_sharded {BATCH_2D}"
        yr, yi = counted(per_call, lbl, lambda: tp.fft2_batch_sharded(tensor(x), mesh), {})
        row(f"{lbl} vs numpy f64 (rel)", hh * ww, cerr(yr, yi, sf.fft2(x.astype(np.float64), workers=-1)),
            gate(hh * ww))

        # The sharded estimators: all-reduce, neighbour exchange, state gather.
        n, seg = WELCH_SHARDED
        x = rng.standard_normal(n).astype(np.float32)
        lbl = f"welch_sharded {n} / {seg}"
        f, pxx = counted(per_call, lbl, lambda: tp.welch_sharded(tensor(x), mesh, nperseg=seg),
                         {"whole_transform": 1})
        fr, pref = ss.welch(x.astype(np.float64), nperseg=seg)
        if not np.allclose(f, fr):
            fail(f"{lbl}: its frequencies differ from scipy's")
        row(f"{lbl} vs scipy.signal.welch f64 (rel)", seg, rerr(pxx, pref), 1e-4)
        n, taps = OACONV_SHARDED
        x = rng.standard_normal(n).astype(np.float32)
        hk = rng.standard_normal(taps).astype(np.float32)
        lbl = f"oaconvolve_sharded {n} * {taps}"
        y = counted(per_call, lbl, lambda: tp.oaconvolve_sharded(tensor(x), tensor(hk), mesh),
                    {"whole_transform": 3})
        row(f"{lbl} vs scipy.signal.oaconvolve f64 (rel)", n,
            rerr(y, ss.oaconvolve(x.astype(np.float64), hk.astype(np.float64))), 2e-3)
        n = LFILTER_SHARDED
        x = rng.standard_normal(n).astype(np.float32)
        bb, aa = ss.butter(4, 0.15)
        lbl = f"lfilter_sharded butter(4) {n}"
        y = counted(per_call, lbl, lambda: tp.lfilter_sharded(bb, aa, tensor(x), mesh, "dp"),
                    {"whole_transform": 3})
        row(f"{lbl} vs scipy.signal.lfilter f64 (abs)", n,
            float(np.abs(host(y) - ss.lfilter(bb, aa, x.astype(np.float64))).max()), 2e-4)

        # The mesh train steps against the single-device step from the same
        # weights: the data-parallel step on FNO (c) (K3 12, K4 4 times a step), the
        # FSDP2 step with dp = tp = 1 on FNO (a).
        report["parallel_fno"] = {}
        for name, kind in (("c", "data_parallel"), ("a", "gspmd")):
            cell = FNO_CELLS[name]
            x_np, y_np = fno_data(cell, seed=ord(name))
            xs, ys = tensor(x_np), tensor(y_np)
            model = fno_model(cell, dev, seed=ord(name))
            twin = copy.deepcopy(model)
            ref_step = make_train_step(twin, torch.optim.Adam(twin.parameters(), lr=1e-3))
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            if kind == "data_parallel":
                step = make_data_parallel_step(model, opt, mesh, axis="dp")
            else:
                step, shard = make_gspmd_step(model, opt, mesh_tp, dp_axis="dp", tp_axis="tp")
                shard()
            want = fno_launches(cell)
            losses, worst = [], 0.0
            for i in range(FNO_STEPS):
                loss = float(counted(per_call, f"FNO({name}) {kind} step {i}", lambda: step(xs, ys), want))
                ref_loss = float(ref_step(xs, ys))
                if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
                    fail(f"FNO({name}) {kind} step {i}: loss {loss} vs the single-device step's {ref_loss}")
                ref_p = dict(twin.named_parameters())
                for k, p in model.named_parameters():
                    pv = p.full_tensor() if hasattr(p, "full_tensor") else p
                    worst = max(worst, float((pv.detach() - ref_p[k].detach()).abs().max())
                                / float(ref_p[k].detach().abs().max()))
                losses.append(loss)
            lbl = f"FNO({name}) {kind} step"
            per_call[lbl] = per_call[f"FNO({name}) {kind} step 0"]
            row(f"{lbl} vs the single-device step, worst parameter over {FNO_STEPS} steps (rel)",
                cell["size"] ** cell["dims"], worst, 1e-5)
            print(f"  FNO({name}) {kind}: loss {losses[0]:.6g} -> {losses[-1]:.6g}")
            report["parallel_fno"][name] = dict(kind=kind, losses=losses, launches=per_call[lbl])
            if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
                fail(f"FNO({name}) {kind}: the loss did not fall: {losses}")
            del model, twin, step, ref_step, opt, xs, ys
            torch.cuda.empty_cache()

        # Serving: every kind at every shape, exported on the card, written,
        # read back and run; bit-equal to the live call on the same input,
        # with the same launches (made from inside the artifact).
        builders = serving._builders()
        with tempfile.TemporaryDirectory() as tmp:
            for b, n in EXPORT_SHAPES:
                for kind in serving.EXPORT_KINDS:
                    fn, shapes_of = builders[kind]
                    args = [rng.standard_normal(sh).astype(np.float32) for sh in shapes_of(b, n)]
                    lbl = f"{kind} ({b}, {n}) live"
                    live = counted(per_call, lbl, lambda: fn(*[tensor(a) for a in args]), None)
                    path = os.path.join(tmp, f"{kind}_{b}_{n}.pt2")
                    size = serving.save_transform(path, kind, b, n)
                    art = serving.load_transform(path)
                    lbl = f"{kind} ({b}, {n}) artifact, {size} bytes"
                    got = counted(per_call, lbl, lambda: serving.exported_call(art, *args),
                                  per_call[f"{kind} ({b}, {n}) live"])
                    live = live if isinstance(live, tuple) else (live,)
                    got = got if isinstance(got, tuple) else (got,)
                    err = max(float(np.abs(g - host(t)).max()) for g, t in zip(got, live))
                    row(f"{lbl} vs the live call (abs)", n, err, 0.0)
                    del art, live, got
            if not {"whole_transform_packed", "whole_transform", "stage_a"} <= {
                    k for lbl, got in per_call.items() if "artifact" in lbl for k, v in got.items() if v}:
                fail("the artifacts did not launch K2, K1 and K3")

            # The command line as a user runs it, each in its own process.
            art = os.path.join(tmp, "fft_1_4096.pt2")
            serving.save_transform(art, "fft", 1, 4096)
            env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
            cli = {"plan": (["plan"], "layout"), "demo": (["demo"], "[OK]"),
                   "serve-check": (["serve-check", art], "device=cuda")}
            procs = {name: subprocess.Popen([sys.executable, "-m", "gpu_fft_tpu_torch", *argv], cwd=ROOT, env=env,
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for name, (argv, _) in cli.items()}
            report["cli"] = {}
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                print(f"  python -m gpu_fft_tpu_torch {name}: rc {proc.returncode}")
                for line in out.splitlines():
                    print(f"    | {line}")
                report["cli"][name] = dict(rc=proc.returncode, output=out)
                if proc.returncode != 0 or cli[name][1] not in out:
                    fail(f"python -m gpu_fft_tpu_torch {name}: rc {proc.returncode}: {err[-1000:]}")

    restore()
    launched = {k: c.launches for k, c in K.COUNTS.items() if k in MAIN_PATH_KERNELS}
    print(f"  launches in phase 3g: {launched}")
    report.update(parallel_launches=launched, parallel_launches_per_call=per_call)
    check_geometries(report, geometries, "phase 3g")
    return launched


def parallel_times(report: dict, dev) -> None:
    """Phase 4's rows for phase 3g, each beside its single-device
    counterpart in the same call (CUDA events and profiler device time):
    fft2_sharded on the panel beside fft2_device (the layer's own cost at
    world size 1: DTensors and two NCCL all-to-alls a part), the
    data-parallel FNO (c) step beside the single-device step, an artifact's
    module beside fft_device, and the band's fft_device with the kernel
    called through its operator beside the same kernel's entry called
    directly (the dispatcher's host time)."""
    import copy
    import tempfile

    import torch

    import gpu_fft_tpu_torch as gt
    import gpu_fft_tpu_torch.parallel as tp
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.models import make_data_parallel_step, make_train_step
    from gpu_fft_tpu_torch.utils import serving

    gen = torch.Generator(device=dev).manual_seed(13)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def row(label, fn, ref_fn, ref_name, iters=20):
        ms, ref_ms = cuda_ms(fn, iters=iters, repeats=3), cuda_ms(ref_fn, iters=iters, repeats=3)
        (dev_ms, top), (ref_dev_ms, _) = device_ms(fn, iters=iters, top=6), device_ms(ref_fn, iters=iters)
        report["times"].append(dict(what=label, ms=ms, ref_ms=ref_ms, ref_call=ref_name, device_ms=dev_ms,
                                    ref_device_ms=ref_dev_ms, top_kernels=top))
        print(f"  {label:44s} events: {ms:.4f} ms {ref_name} {ref_ms:.4f} ms | device: {fmt(dev_ms)}"
              f" {ref_name} {fmt(ref_dev_ms)}")
        print(f"    top kernels: {[(k, round(v, 4)) for k, v in top]}")

    with nccl_world(dev):
        mesh, _, _ = parallel_meshes()
        h, w = PANEL
        x = torch.randn(h, w, generator=gen, device=dev)
        row(f"fft2_sharded {h} x {w} (world 1)", lambda: tp.fft2_sharded(x, mesh, sp_axis="dp"),
            lambda: gt.fft2_device(x), "fft2_device", iters=5)
        del x
        cell = FNO_CELLS["c"]
        x_np, y_np = fno_data(cell, seed=ord("c"))
        xs, ys = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        model = fno_model(cell, dev, seed=ord("c"))
        twin = copy.deepcopy(model)
        step = make_data_parallel_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh)
        ref_step = make_train_step(twin, torch.optim.Adam(twin.parameters(), lr=1e-3))
        row(f"FNO(c) data-parallel step {tuple(xs.shape)} (world 1)", lambda: step(xs, ys),
            lambda: ref_step(xs, ys), "make_train_step", iters=5)
        del model, twin, step, ref_step, xs, ys
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for n in (4096, 1 << 20):
            path = f"{tmp}/fft_{n}.pt2"
            serving.save_transform(path, "fft", 1, n)
            module = serving.load_transform(path).module()
            x = torch.randn(1, n, generator=gen, device=dev)
            row(f"artifact fft (1, {n}) module", lambda: module(x), lambda: gt.fft_device(x), "fft_device")
    for n in (1024, 2048, 4096, 8192, 16384):
        packed = n <= 1024
        plan = P.on_device(P.get_whole_packed_plan if packed else P.get_whole_plan, n, -1, None, device=dev)
        tables = [plan["packed"]] if packed else [plan[k] for k in ("f1r", "f1i", "twr", "twi", "f2r", "f2i")]
        wrapper = K.whole_transform_packed if packed else K.whole_transform
        x = torch.randn(1, n, generator=gen, device=dev)
        op_ms = cuda_ms(lambda: wrapper(x, None, plan))
        direct_ms = cuda_ms(lambda: K._whole_cuda(x, None, tables, n // 128))
        fft_ms = cuda_ms(lambda: gt.fft_device(x))
        fft_dev, _ = device_ms(lambda: gt.fft_device(x))
        report["times"].append(dict(what=f"band fft_device (1, {n})", ms=fft_ms, device_ms=fft_dev,
                                    kernel_through_operator_ms=op_ms, kernel_entry_direct_ms=direct_ms,
                                    dispatcher_ms=op_ms - direct_ms))
        print(f"  band fft_device (1, {n:5d}) events {fft_ms:.4f} ms device {fmt(fft_dev)} | "
              f"{'K2' if packed else 'K1'} through its operator {op_ms:.4f} ms, its entry called directly "
              f"{direct_ms:.4f} ms: the dispatcher adds {(op_ms - direct_ms) * 1e3:.2f} us")


def precision_phase(report: dict, dev, rng, shapes=PRECISION_SHAPES, grad_sizes=PRECISION_GRAD) -> dict:
    """Phase 3h: the three precision modes, each set with ``config.PRECISION``
    and set back to "full" at the end.  Returns the launches of the "fast"
    run (counted from 0) and the largest kernel-vs-plain difference of each
    fast kernel."""
    import numpy as np
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K

    six = (*MAIN_PATH_KERNELS, *FAST_KERNELS.values())

    def snapshot():
        return {k: (K.COUNTS[k].launches, K.COUNTS[k].plain_calls) for k in six}

    def delta(before):
        after = snapshot()
        return ({k: after[k][0] - before[k][0] for k in six if after[k][0] - before[k][0]},
                sum(after[k][1] - before[k][1] for k in six))

    def rel(got, ref):
        got = [g.detach().cpu().double().numpy() for g in got]
        return max(float(np.abs(g - r).max()) for g, r in zip(got, ref)) / max(float(np.abs(r).max()) for r in ref)

    # The inputs and their float64 references, the same for every mode.
    data = {}
    for b, n in shapes:
        x = rng.standard_normal((b, n)).astype(np.float32)
        zr, zi = (rng.standard_normal((b, n)).astype(np.float32) for _ in range(2))
        sp = np.fft.rfft(x.astype(np.float64), axis=-1)
        hr, hi = sp.real.astype(np.float32), sp.imag.astype(np.float32)
        x64 = x.astype(np.float64)
        fwd = np.fft.fft(x64, axis=-1)
        inv = np.fft.ifft(zr.astype(np.float64) + 1j * zi.astype(np.float64), axis=-1)
        half = np.fft.rfft(x64, axis=-1)
        back = np.fft.irfft(hr.astype(np.float64) + 1j * hi.astype(np.float64), n=n, axis=-1)
        data[b, n] = (*(torch.from_numpy(a).to(dev) for a in (x, zr, zi, hr, hi)),
                      {"fft": (fwd.real, fwd.imag), "ifft": (inv.real, inv.imag),
                       "rfft": (half.real, half.imag), "irfft": (back,)})

    errs: dict = {}
    launches: dict = {}
    grads: dict = {}
    # Every K1F/K2F/K3F geometry the modes launch: its first input, cloned
    # (the dispatchers of kernels/fused.py call them through the module).
    seen, restore = capture_launches(K, FAST_KERNELS.values())
    try:
        for mode in PRECISION_BANDS:
            config.PRECISION = mode
            K.reset_counts()
            per = launches[mode] = {}
            plain = 0
            for (b, n), (x, zr, zi, hr, hi, ref) in data.items():
                calls = {"fft": lambda: gt.fft_device(x), "ifft": lambda: gt.ifft_device(zr, zi),
                         "rfft": lambda: gt.rfft_device(x), "irfft": lambda: (gt.irfft_device(hr, hi),)}
                for op, call in calls.items():
                    before = snapshot()
                    out = call()
                    torch.cuda.synchronize()
                    per[f"{op} ({b}, {n})"], p = delta(before)
                    plain += p
                    errs.setdefault((op, b, n), {})[mode] = rel(out, ref[op])
            for n in grad_sizes:
                x = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev).requires_grad_(True)
                before = snapshot()
                yr, yi = gt.fft_device(x)
                (g,) = torch.autograd.grad((yr * yr + yi * yi).sum(), x)
                torch.cuda.synchronize()
                launched, p = delta(before)
                plain += p
                want = 2.0 * n * x.detach().cpu().double().numpy()
                grads[mode, n] = launched
                record(report, "precision_path", f"grad Parseval n={n} mode={mode} ({launched})", n,
                       float(np.abs(g.cpu().double().numpy() - want).max() / np.abs(want).max()),
                       PRECISION_BANDS[mode])
            print(f"  mode {mode}: launches {per}; plain calls {plain}")
            if plain:
                fail(f"phase 3h ran {plain} plain kernel versions on the card under {mode}")
    finally:
        config.PRECISION = "full"
        restore()

    # The bands, the gate and the order of the modes.
    for (op, b, n), e in errs.items():
        label = f"{op} ({b}, {n})"
        for mode, band in PRECISION_BANDS.items():
            record(report, "precision_path", f"{label} mode={mode} vs numpy f64 (rel)", n, e[mode],
                   min(band, gate(n)) if mode == "full" else band)
        ordered = e["full"] < e["high"] < e["fast"] and 1e-6 < e["high"] and 1e-4 < e["fast"]
        report.setdefault("precision_order", []).append(dict(case=label, **e, ok=ordered))
        if not ordered:
            fail(f"{label}: the modes are out of order or not engaged: {e}")
    print(f"  bands and order: {len(errs)} (op, shape) cases, full < high < fast in each, "
          f"1e-6 < high and 1e-4 < fast")

    # The counts by mode: "high" runs no kernel; "fast" runs each fp32
    # kernel's counterpart where "full" runs it and no fp32 kernel, but
    # for K1 / K2 outside K1F / K2F's band (B = 1, n <= 16,384), where it
    # runs the torch engines, and for K4, which has no "fast" form (the
    # torch stage B runs).
    for op, b, n in errs:
        label = f"{op} ({b}, {n})"
        full = launches["full"][label]
        if launches["high"][label]:
            fail(f"{label}: 'high' launched {launches['high'][label]}")
        fast_band = b <= P.WHOLE_FAST_BATCH_MAX and n <= P.WHOLE_FAST_N_MAX
        want = {FAST_KERNELS[k]: v for k, v in full.items() if k == "stage_a" or k in FAST_KERNELS and fast_band}
        if launches["fast"][label] != want or set(full) - {*FAST_KERNELS, "stage_b"}:
            fail(f"{label}: 'fast' launched {launches['fast'][label]} where 'full' launched {full}")
    for n in grad_sizes:
        want = {FAST_KERNELS[k]: v for k, v in grads["full", n].items() if k in FAST_KERNELS}
        if grads["high", n] or grads["fast", n] != want:
            fail(f"grad n={n}: 'high' launched {grads['high', n]}, 'fast' {grads['fast', n]} (want {want})")
    fast_launches = {k: sum(c.get(k, 0) for c in launches["fast"].values()) for k in FAST_KERNELS.values()}
    for name, count in fast_launches.items():
        if count < 1:
            fail(f"{name} was launched no time by the 'fast' main path")
    print(f"  launches under 'fast': {fast_launches}; Parseval grads: {grads}")

    # Each geometry against its plain version and against float64.
    print(f"  {len(seen)} K1F/K2F/K3F geometries launched in phase 3h, each vs its plain version (gate max|d| "
          f"<= {FAST_TOL} max|plain|) and float64 (kernel error <= {F64_RATIO} x the plain version's):")
    max_err = {k: 0.0 for k in FAST_KERNELS.values()}
    for (name, shape, real, *_), (gx, gy, args, kw) in seen.items():
        got = getattr(K, name)(gx, gy, *args, **kw)  # restored: the kernel itself
        want = getattr(K, name + "_plain")(gx, gy, *args, **kw)
        # float64: the fp32 kernel's plain version on float64 operands.
        if name == "stage_a_bf16":
            truth = K.stage_a_plain(f64(gx), f64(gy), *map(f64, args), **kw)
        elif name == "whole_transform_bf16":
            truth = K.whole_transform_plain(f64(gx), f64(gy), {k: f64(v) for k, v in args[0].items()
                                                               if k.startswith(("f1", "f2", "tw"))})
        else:
            truth = K.whole_transform_packed_plain(f64(gx), f64(gy), {"packed": f64(args[0]["packed"]),
                                                                      "n1": args[0]["n1"]})
        case = f"{shape} {'real' if real else 'complex'} {[a for a in args if not isinstance(a, dict)]} {kw or ''}"
        max_err[name] = max(max_err[name], hold_fast(report, name, f"phase 3h {case}", got, want, truth))
        del got, want, truth
    torch.cuda.synchronize()
    max_err.update(fast_whole_geometries(report, dev, rng, max_err))
    max_err.update(fast_stage_a_geometries(report, dev, rng, max_err))
    report["precision_launches"] = launches
    report["precision_errors"] = {f"{op} ({b}, {n})": e for (op, b, n), e in errs.items()}
    return {"launches": fast_launches, "max_err": max_err}


def fast_whole_geometries(report: dict, dev, rng, max_err: dict) -> dict:
    """Every K1F / K2F geometry of the launch rule (``whole_bf16_geometry``
    and ``whole_bf16_split``) at n = 1,024 ... 16,384, B = 1 and 3, real
    forward and complex inverse, against its plain version and float64
    (:func:`hold_fast`).  Returns the largest max|d| of each kernel, with
    ``max_err``'s."""
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K

    out = {k: max_err.get(k, 0.0) for k in ("whole_transform_bf16", "whole_transform_packed_bf16")}
    print(f"  every K1F / K2F geometry of the launch rule (B = 1 and 3, real and complex) vs its plain version "
          f"and float64:")
    for name in out:
        packed = "packed" in name
        make = P.get_whole_packed_plan if packed else P.get_whole_plan
        for n in (1024, 2048, 4096, 8192, 16384):
            n1 = n // 128
            for complex_ in (False, True):
                plan = P.on_device(make, n, 1 if complex_ else -1, 1.0 / n if complex_ else None, device=dev)
                for b in (1, 3):
                    xr = torch.from_numpy(rng.standard_normal((b, n)).astype("float32")).to(dev)
                    xi = torch.from_numpy(rng.standard_normal((b, n)).astype("float32")).to(dev) if complex_ else None
                    got = getattr(K, name)(xr, xi, plan)
                    want = getattr(K, name + "_plain")(xr, xi, plan)
                    if packed:
                        truth = K.whole_transform_packed_plain(f64(xr), f64(xi), {"packed": f64(plan["packed"]),
                                                                                  "n1": n1})
                    else:
                        truth = K.whole_transform_plain(f64(xr), f64(xi), {k: f64(v) for k, v in plan.items()
                                                                           if k.startswith(("f1", "f2", "tw"))})
                    geo = K.whole_bf16_geometry(b, n1, complex_, K.sm_count(dev), packed)
                    case = (f"B={b} n={n} {'complex' if complex_ else 'real'} geometry {geo} "
                            f"split {K.whole_bf16_split(n1, geo[0])}")
                    out[name] = max(out[name], hold_fast(report, name, case, got, want, truth))
    torch.cuda.synchronize()
    return out


def fast_stage_a_geometries(report: dict, dev, rng, max_err: dict) -> dict:
    """Every K3F geometry the launch rule (``stage_a_bf16_geometry``) picks at
    the main path's shapes: 2^17 ... 2^24 at B = 1, and at B = 3 up to 2^20
    (from 2^21 on a row has more column tiles than the card has SMs, so B =
    3 takes B = 1's geometry), each with real input and the real path's
    rows, complex input with all rows and the irfft fold's first
    ceil((n2/2 + 1) / ct) column tiles; and the 2-D panel's B = 512 x 2^17;
    each against its plain version and float64 (:func:`hold_fast`).
    Returns the largest max|d|, with ``max_err``'s."""
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K

    out = max_err.get("stage_a_bf16", 0.0)
    print("  every K3F geometry of the launch rule at the main path's shapes vs its plain version and float64:")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    # B = 3 where it changes the grid (fewer column tiles than SMs at B = 1).
    cases = [(1, n) for n in (1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24)]
    cases += [(3, n) for n in (1 << 17, 1 << 18, 1 << 19, 1 << 20)] + [PANEL]
    for b, n in cases:
        for kind in ("real", "complex", "irfft"):
            if b == PANEL[0] and kind == "irfft":
                continue
            plan = P.on_device(P.get_stage_a_plan, n, -1 if kind == "real" else 1,
                               None if kind == "irfft" else P.stage_a_ct_full_range(n), device=dev)
            n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
            rows = P.stage_a_real_rows(n1) if kind == "real" else None
            tiles = -(-(n2 // 2 + 1) // ct) if kind == "irfft" else None
            xr = torch.randn(b, n1, n2, generator=gen, device=dev)
            xi = None if kind == "real" else torch.randn(b, n1, n2, generator=gen, device=dev)
            r, ncols = K._stage_a_extent(n1, n2, plan, ct, tiles, rows)
            geo = K.stage_a_bf16_geometry(b, n1, n2, r, ncols, xi is not None, K.sm_count(dev))
            args = (n1, n2, plan, ct, tiles, rows)
            truth = K.stage_a_plain(f64(xr), f64(xi), *map(f64, args))
            case = f"B={b} n={n} {kind} rows={r} ncols={ncols} ct={ct} geometry {geo}"
            out = max(out, hold_fast(report, "stage_a_bf16", case, K.stage_a_bf16(xr, xi, *args),
                                     K.stage_a_bf16_plain(xr, xi, *args), truth))
            del xr, xi, truth
    torch.cuda.synchronize()
    return {"stage_a_bf16": out}


def fast_legacy_checks(report: dict, dev, randn) -> dict:
    """Phase 2's "fast" stage-A ablation kernels, each against its plain
    version and float64 (:func:`hold_fast`): K3LF at every ``ablate_large``
    shape (real input, all rows) and in its complex, rows and col_tiles
    forms (n1 = 256 on two row blocks, n1 = 512 complex with F streamed),
    S2F at n1 = 32, 128 and 256.  Returns the largest max|d| of each."""
    import torch

    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import ablation as A
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.scripts import ablate_large

    print(f"  K3LF and S2F vs their plain versions (gate max|d| <= {FAST_TOL} max|plain|) and float64 (kernel "
          f"error <= {F64_RATIO} x the plain version's):")
    max_err = dict.fromkeys(FAST_LEGACY_KERNELS.values(), 0.0)
    cases = [(n, n1, False, None, None) for n, n1s in ablate_large.SWEEPS.items() for n1 in n1s]
    cases += [(1 << 17, 16, True, None, None), (1 << 17, 128, False, None, 72), (1 << 17, 128, True, 1, None),
              (1 << 20, 128, True, None, None), (1 << 20, 128, False, None, 72), (1 << 22, 128, False, None, 72),
              (1 << 20, 256, True, 2, 136), (1 << 22, 512, True, None, None)]
    for n, n1, complex_, tiles, r in cases:
        plan = P.on_device(ablate_large.make_plan, n, n1, 1 if complex_ else -1, device=dev)
        n2 = plan["n2"]
        ct = P.stage_a_col_tile(n1, n2)
        xr = randn(1, n1, n2)
        xi = randn(1, n1, n2) if complex_ else None
        args = (n1, n2, plan, ct, tiles, r)
        got = K.stage_a_bf16(xr, xi, *args)
        truth = K.stage_a_plain(f64(xr), f64(xi), *map(f64, args))
        case = f"n={n} n1={n1} {'complex' if complex_ else 'real'} rows={r} col_tiles={tiles} ct={ct}"
        err = hold_fast(report, "stage_a_legacy_bf16", case, got, K.stage_a_bf16_plain(xr, xi, *args), truth)
        max_err["stage_a_legacy_bf16"] = max(max_err["stage_a_legacy_bf16"], err)
        del xr, xi, got, truth
    for n, n1 in ((1 << 17, 32), (1 << 20, 128), (1 << 20, 256)):
        plan = A.manual_tables(P.on_device(ablate_large.make_plan, n, n1, -1, device=dev))
        x = randn(n1, plan["n2"])
        case = f"n={n} n1={n1} real {A.manual_bf16_geometry(n1, plan['n2'])}"
        err = hold_fast(report, "stage_a_manual_bf16", case, A.stage_a_manual_bf16(x, plan),
                        A.stage_a_manual_bf16_plain(x, plan), A.stage_a_manual_plain(f64(x), f64(plan)))
        max_err["stage_a_manual_bf16"] = max(max_err["stage_a_manual_bf16"], err)
        del x
    torch.cuda.synchronize()
    return max_err


def fast_legacy_phase(report: dict, dev, out_dir: Path) -> dict:
    """Phase 5 under "fast": the three stage-A harnesses through K3LF and
    S2F (and K3F, in the levers harness), the mode set with
    ``config.PRECISION`` and set back to "full", counted from 0.  Fails unless K3LF and S2F ran, K3-legacy, S2 and every
    plain version did not, no row holds an error, every levers row is within
    its mode's parity limit and L3's (K3F against S2F, which share rounded
    operands) within FAST_TOL.  Then every K3LF and S2F geometry the
    harnesses launched is held against its plain version and float64 and
    against the fp32 kernel on the same input, from which it must be more
    than 1e-4 of max|.| away (the mode was engaged).  Returns the phase's
    launches and the largest kernel-vs-plain difference of each kernel."""
    import numpy as np
    import torch

    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch.kernels import ablation as A
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.scripts import ablate_2e20_levers, ablate_large, time_stage_a

    K.reset_counts()
    A.reset_counts()
    seen_k, restore_k = capture_launches(K, ("stage_a_bf16",))
    seen_s, restore_s = capture_launches(A, ("stage_a_manual_bf16",))
    timed = {"ms": {}, "max_abs_err": {}, "sweep": []}
    try:
        config.PRECISION = "fast"
        large_res = ablate_large.main(quick=True, out_dir=str(out_dir / "fast"))
        levers_res = ablate_2e20_levers.main(quick=True, out_dir=str(out_dir / "fast"))
        time_stage_a.time_legacy(timed, False, dev, torch.Generator(device=dev).manual_seed(0))
    finally:
        config.PRECISION = "full"
        restore_k()
        restore_s()
    counted = {**K.COUNTS, **A.COUNTS}
    launches = {k: c.launches for k, c in counted.items() if c.launches}
    plain = sum(c.plain_calls for c in counted.values())
    print(f"  launches in phase 5 under 'fast': {launches}; plain calls {plain}")
    report.update(launches_phase5_fast=launches, ablate_large_fast=large_res, ablate_2e20_levers_fast=levers_res,
                  time_stage_a_legacy_fast=timed)
    if plain:
        fail(f"phase 5 under 'fast' ran {plain} plain kernel versions on the card")
    for full, fast in FAST_LEGACY_KERNELS.items():
        if launches.get(full) or not launches.get(fast):
            fail(f"phase 5 under 'fast' launched {full} {launches.get(full, 0)} and {fast} {launches.get(fast, 0)} "
                 f"times")
    if large_res["mode"] != "fast" or levers_res["mode"] != "fast":
        fail("a harness did not run under 'fast'")
    bad = ablate_2e20_levers.unexpected_errors(levers_res)
    if bad:
        fail(f"ablate_2e20_levers rows failed under 'fast': {bad}")
    off = ablate_2e20_levers.parity_failures(levers_res)
    if off:
        fail(f"ablate_2e20_levers rows over parity {ablate_2e20_levers.parity_limit('fast'):.3e} under 'fast': {off}")
    l3 = levers_res["rows"]["L3_stageA_emit_pipeline"]["parity"]
    print(f"  L3 under 'fast': K3F against S2F parity {l3:.3e} (gate {FAST_TOL})")
    if not l3 <= FAST_TOL:
        fail(f"L3 under 'fast': K3F and S2F differ by {l3:.3e} of max|K3F|")
    times = [e["us"] for e in large_res["entries"]]
    times += [r["us"] for r in levers_res["rows"].values() if "us" in r]
    times += list(timed["ms"].values())
    if not all(np.isfinite(t) and t > 0 for t in times):
        fail(f"a harness time under 'fast' is not a positive number: {times}")

    legacy = {key: v for key, v in seen_k.items() if "two_r" not in v[2][2]}
    print(f"  {len(legacy)} K3LF and {len(seen_s)} S2F geometries the harnesses launched, each vs its plain "
          f"version, float64 and the fp32 kernel (more than 1e-4 of max|.| away):")
    max_err = dict.fromkeys(FAST_LEGACY_KERNELS.values(), 0.0)
    engaged = []
    for (name, shape, *_), (gx, gy, args, kw) in (*legacy.items(), *seen_s.items()):
        if name == "stage_a_bf16":
            name = "stage_a_legacy_bf16"
            got, want = K.stage_a_bf16(gx, gy, *args), K.stage_a_bf16_plain(gx, gy, *args)
            truth = K.stage_a_plain(f64(gx), f64(gy), *map(f64, args))
            fp32 = K.stage_a(gx, gy, *args)  # "full": K3-legacy
            case = f"{shape} {'real' if gy is None else 'complex'} {[a for a in args if not isinstance(a, dict)]}"
        else:
            tables = gy
            got, want = A.stage_a_manual_bf16(gx, tables), A.stage_a_manual_bf16_plain(gx, tables)
            truth = A.stage_a_manual_plain(f64(gx), f64(tables))
            fp32 = A.stage_a_manual(gx, tables)  # "full": S2
            case = f"{shape} real"
        max_err[name] = max(max_err[name], hold_fast(report, name, f"phase 5 fast {case}", got, want, truth))
        gap = max(float((g - w).abs().max()) for g, w in zip(got, fp32)) / max(float(w.abs().max()) for w in fp32)
        engaged.append(dict(kernel=name, case=case, gap_to_fp32=gap))
        print(f"      {name} {case}: {gap:.3e} of max|fp32 kernel| from the fp32 kernel")
        if not gap > 1e-4:
            fail(f"{name} {case}: within {gap:.3e} of the fp32 kernel; the mode was not engaged")
        del got, want, truth, fp32
    torch.cuda.synchronize()
    report["phase5_fast_engaged"] = engaged
    return {"launches": {k: launches.get(k, 0) for k in FAST_LEGACY_KERNELS.values()}, "max_err": max_err}


def gate_closed_phase(report: dict, dev, rng) -> dict:
    """Phase 3i: the gate-closed engines on the card, each gate opened only
    inside this phase by patching its threshold in ``plan``
    (``unittest.mock.patch.multiple``) and both checked closed afterwards.
    The packed real forward through ``fft_device`` (against numpy f64, a
    roundtrip, the half transform's launches), the axis-0 column pass through the four 2-D calls on the
    image and on the panel's column leg, the packed direct rfft / PSD, and
    the soak in-process.  Device times beside the closed routes and
    ``torch.fft``.  Returns the launches of the phase (counted from 0)."""
    import contextlib
    import io
    from unittest import mock

    import numpy as np
    import scipy.fft as sf
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels import fused_torch as F
    from gpu_fft_tpu_torch.kernels import large as L
    from gpu_fft_tpu_torch.scripts import soak

    shut = (P.RFFT_PACK_MIN, P.AXIS0_H_MIN)
    kernels = (*MAIN_PATH_KERNELS, *FAST_KERNELS.values())

    def snapshot():
        return {k: (K.COUNTS[k].launches, K.COUNTS[k].plain_calls) for k in kernels}

    def delta(before):
        after = snapshot()
        return ({k: after[k][0] - before[k][0] for k in kernels if after[k][0] - before[k][0]},
                sum(after[k][1] - before[k][1] for k in kernels))

    def counted(label, fn, want):
        """``fn()``, failing unless it launched exactly ``want`` and no plain version."""
        before = snapshot()
        out = fn()
        torch.cuda.synchronize()
        launched, plain = delta(before)
        if launched != want or plain:
            fail(f"{label}: launched {launched} and {plain} plain calls, want {want}")
        return out, launched

    def host(t):
        return t.detach().cpu().double().numpy()

    def cerr(re, im, ref):
        return max(float(np.abs(host(re) - ref.real).max()), float(np.abs(host(im) - ref.imag).max())) \
            / float(np.abs(ref).max())

    def dev_ms(fn, **opened):
        """``device_ms`` of ``fn`` with plan's ``opened`` thresholds patched
        while it runs (None where no profile recorded a kernel)."""
        with mock.patch.multiple(P, **opened) if opened else contextlib.nullcontext():
            return device_ms(fn, iters=10)[0]

    def keep(label, **ms):
        report.setdefault("gate_closed_times", []).append({"what": label, **ms})
        print(f"  {label:40s} device ms: " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in ms.items()))

    K.reset_counts()
    geometries, restore = capture_launches(L)
    axis0_calls = []
    axis0 = F.transform_axis0

    def logged_axis0(xr, xi, n, *args, **kw):
        axis0_calls.append((tuple(xr.shape), n))
        return axis0(xr, xi, n, *args, **kw)

    F.transform_axis0 = logged_axis0
    try:
        # ── The packed real forward: ONE n/2-point complex transform ────────
        print(f"  packed real forward, {PACK_OPEN} (gate 5*log2(n)*eps; fast {PRECISION_BANDS['fast']})")
        with mock.patch.multiple(P, **PACK_OPEN):
            for n in GATE_PACK_SIZES:
                for b in (1, 3):
                    x = rng.standard_normal((b, n)).astype(np.float32)
                    xt = torch.from_numpy(x).to(dev)
                    (yr, yi), launched = counted(f"packed fft ({b}, {n})", lambda: gt.fft_device(xt),
                                                 launches_of(b, n // 2, True))
                    ref = sf.fft(x.astype(np.float64), axis=-1, workers=-1)
                    record(report, "gate_closed_path", f"packed fft ({b}, {n}) {launched} vs numpy f64 (rel)", n,
                           cerr(yr, yi, ref), gate(n))
                    rr, _ = gt.ifft_device(yr, yi)
                    record(report, "gate_closed_path", f"packed fft ({b}, {n}) roundtrip", n,
                           float(np.abs(host(rr) - x).max()), gate(n))
                    del xt, yr, yi, rr, ref
            n = GATE_PACK_FAST
            x = rng.standard_normal((1, n)).astype(np.float32)
            xt = torch.from_numpy(x).to(dev)
            config.PRECISION = "fast"
            try:
                (yr, yi), launched = counted(f"packed fft (1, {n}) fast", lambda: gt.fft_device(xt),
                                             {"whole_transform_bf16": 1})
                rr, _ = gt.ifft_device(yr, yi)
                torch.cuda.synchronize()
            finally:
                config.PRECISION = "full"
            ref = np.fft.fft(x.astype(np.float64), axis=-1)
            record(report, "gate_closed_path", f"packed fft (1, {n}) fast {launched} vs numpy f64 (rel)", n,
                   cerr(yr, yi, ref), PRECISION_BANDS["fast"])
            record(report, "gate_closed_path", f"packed fft (1, {n}) fast roundtrip (rel)", n,
                   float(np.abs(host(rr) - x).max()) / float(np.abs(x).max()), PRECISION_BANDS["fast"])

        # ── The axis-0 column pass ──────────────────────────────────────────
        stamp("phase 3i axis-0")
        print(f"  axis-0 column pass, {AXIS0_OPEN} (phase 3e's gates)")
        img = rng.standard_normal((IMAGE, IMAGE)).astype(np.float32)
        img_t = torch.from_numpy(img).to(dev)
        iref = sf.fft2(img.astype(np.float64), workers=-1)
        nn = IMAGE * IMAGE
        h, w = PANEL
        panel = rng.standard_normal((h, w)).astype(np.float32)
        panel_t = torch.from_numpy(panel).to(dev)
        with mock.patch.multiple(P, **AXIS0_OPEN):
            if not (P.axis0_applies(IMAGE, IMAGE) and P.axis0_applies(IMAGE, IMAGE // 2 + 1)):
                fail("the axis-0 gate did not open for the image")
            # K1 on the rows (B = 4,096, or 2,049 half-spectrum columns'
            # rows), the axis-0 engine on the columns.
            k1 = {"whole_transform": 1}
            (yr, yi), _ = counted(f"fft2_device {IMAGE}^2 axis-0", lambda: gt.fft2_device(img_t), k1)
            record(report, "gate_closed_path", f"fft2_device {IMAGE}^2 axis-0 vs numpy f64 (rel)", nn,
                   cerr(yr, yi, iref), gate(nn))
            (br, bi), _ = counted(f"ifft2_device {IMAGE}^2 axis-0", lambda: gt.ifft2_device(yr, yi), k1)
            record(report, "gate_closed_path", f"ifft2_device {IMAGE}^2 axis-0 roundtrip (rel)", nn,
                   max(float(np.abs(host(br) - img).max()), float(bi.abs().max())) / float(np.abs(img).max()),
                   gate(nn))
            del yr, yi, br, bi
            (hr, hi), _ = counted(f"rfft2_device {IMAGE}^2 axis-0", lambda: gt.rfft2_device(img_t), k1)
            record(report, "gate_closed_path", f"rfft2_device {IMAGE}^2 axis-0 vs numpy f64 (rel)", nn,
                   cerr(hr, hi, iref[:, : IMAGE // 2 + 1]), gate(nn))
            back, _ = counted(f"irfft2_device {IMAGE}^2 axis-0", lambda: gt.irfft2_device(hr, hi), k1)
            record(report, "gate_closed_path", f"irfft2_device {IMAGE}^2 axis-0 roundtrip (rel)", nn,
                   float(np.abs(host(back) - img).max()) / float(np.abs(img).max()), gate(nn))
            del hr, hi, back, iref
            if [c[1] for c in axis0_calls] != [IMAGE] * 4:
                fail(f"the four 2-D calls on the image ran the axis-0 engine {axis0_calls}, want 4 at n = {IMAGE}")
            # The panel: H = 512 is not above W/2, so the predicate keeps the
            # transpose branch (K3 on its rows, as in phase 3e); its column
            # pass goes through the engine directly.
            if P.axis0_applies(h, w):
                fail(f"the axis-0 predicate took the {h} x {w} panel")
            counted(f"fft2_device {h} x {w} (transpose branch)", lambda: gt.fft2_device(panel_t), {"stage_a": 1})
            if len(axis0_calls) != 4:
                fail(f"fft2_device on the panel ran the axis-0 engine: {axis0_calls[4:]}")
            (cr, ci), _ = counted(f"transform_axis0 {h} x {w}", lambda: F.transform_axis0(panel_t, None, h, -1), {})
            # Every column against the transpose route on the card, the
            # first 4,096 against numpy (the contraction is per column).
            tr, ti = (t.t() for t in L.transform_any(panel_t.t().contiguous(), None, h, -1))
            record(report, "gate_closed_path", f"transform_axis0 {h} x {w} vs the transpose route (rel)", h * w,
                   max(float((cr - tr).abs().max()), float((ci - ti).abs().max()))
                   / max(float(tr.abs().max()), float(ti.abs().max())), gate(h * w))
            cref = sf.fft(panel[:, :4096].astype(np.float64), axis=0, workers=-1)
            record(report, "gate_closed_path", f"transform_axis0 {h} x {w}, 4,096 columns, vs numpy f64 (rel)",
                   h * w, cerr(cr[:, :4096], ci[:, :4096], cref), gate(h * w))
            del cr, ci, tr, ti, cref

        # ── The packed direct rfft and PSD ──────────────────────────────────
        stamp("phase 3i direct")
        print("  packed direct rfft / PSD (gate 5*log2(n)*eps; PSD twice it)")
        for b, n in GATE_DIRECT:
            x = rng.standard_normal((b, n)).astype(np.float32)
            xt = torch.from_numpy(x).to(dev)
            dplan = P.on_device(P.get_rfft_direct_packed_plan, n, None, device=dev)
            (_, fr, fi), _ = counted(f"rfft_direct_packed ({b}, {n})", lambda: F.rfft_direct_packed(xt, dplan), {})
            ref = np.fft.rfft(x.astype(np.float64), axis=-1)
            record(report, "gate_closed_path", f"rfft_direct_packed ({b}, {n}) vs numpy f64 (rel)", n,
                   cerr(fr, fi, ref), gate(n))
            psd, _ = counted(f"rfft_packed_psd ({b}, {n})", lambda: F.rfft_packed_psd(xt, dplan), {})
            pref = np.abs(ref) ** 2
            record(report, "gate_closed_path", f"rfft_packed_psd ({b}, {n}) vs numpy f64 (rel)", n,
                   float(np.abs(host(psd) - pref).max()) / float(pref.max()), 2 * gate(n))

        # ── The soak, in-process ────────────────────────────────────────────
        stamp("phase 3i soak")
        print(f"  soak {SOAK}")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            ran, failures = soak.run(device="cuda", **SOAK)
        lines = log.getvalue().splitlines()
        for line in lines:
            if "FAIL" in line or "EXCEPTION" in line or "not gated" in line or line.startswith("soak:"):
                print(f"    {line}")
        report["soak"] = dict(args=SOAK, ran=ran, failures=failures, log=lines)
        if failures or ran != SOAK["iters"] + SOAK["analysis_iters"]:
            fail(f"soak: {failures} of {ran} checks failed")
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in K.COUNTS.items() if k in kernels}

        # ── Times: each opened engine beside its closed route and torch.fft ─
        stamp("phase 3i times")
        print(f"  times, gate opened beside closed ({report['card']})")
        for n in GATE_PACK_SIZES:
            xt = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev)
            keep(f"fft_device (1, {n})", packed=dev_ms(lambda: gt.fft_device(xt), **PACK_OPEN),
                 closed=dev_ms(lambda: gt.fft_device(xt)), torch_fft=dev_ms(lambda: torch.fft.fft(xt)))
        xt = torch.from_numpy(rng.standard_normal((1, GATE_PACK_FAST)).astype(np.float32)).to(dev)
        config.PRECISION = "fast"
        try:
            packed, shipped = dev_ms(lambda: gt.fft_device(xt), **PACK_OPEN), dev_ms(lambda: gt.fft_device(xt))
        finally:
            config.PRECISION = "full"
        keep(f"fft_device (1, {GATE_PACK_FAST}) fast", packed=packed, closed=shipped,
             torch_fft=dev_ms(lambda: torch.fft.fft(xt)))
        yr, yi = gt.fft2_device(img_t)
        hr, hi = gt.rfft2_device(img_t)
        z, zh = torch.complex(yr, yi), torch.complex(hr, hi)
        calls = {"fft2_device": (lambda: gt.fft2_device(img_t), lambda: torch.fft.fft2(img_t)),
                 "ifft2_device": (lambda: gt.ifft2_device(yr, yi), lambda: torch.fft.ifft2(z)),
                 "rfft2_device": (lambda: gt.rfft2_device(img_t), lambda: torch.fft.rfft2(img_t)),
                 "irfft2_device": (lambda: gt.irfft2_device(hr, hi), lambda: torch.fft.irfft2(zh))}
        for name, (call, lib) in calls.items():
            keep(f"{name} {IMAGE}^2", axis0=dev_ms(call, **AXIS0_OPEN), transpose=dev_ms(call),
                 torch_fft=dev_ms(lib))
        del yr, yi, hr, hi, z, zh

        def transpose_leg():
            sr, si = L.transform_any(panel_t.t().contiguous(), None, h, -1)
            return sr.t().contiguous(), si.t().contiguous()

        keep(f"panel column pass {h} x {w}", axis0=dev_ms(lambda: F.transform_axis0(panel_t, None, h, -1)),
             transpose=dev_ms(transpose_leg), torch_fft=dev_ms(lambda: torch.fft.fft(panel_t, dim=0)))
        for b, n in GATE_DIRECT:
            xt = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
            dplan = P.on_device(P.get_rfft_direct_packed_plan, n, None, device=dev)

            def psd_closed():
                fr, fi = gt.rfft_device(xt)
                return fr * fr + fi * fi

            keep(f"rfft ({b}, {n})", packed=dev_ms(lambda: F.rfft_direct_packed(xt, dplan)),
                 rfft_device=dev_ms(lambda: gt.rfft_device(xt)), torch_fft=dev_ms(lambda: torch.fft.rfft(xt)))
            keep(f"psd ({b}, {n})", packed=dev_ms(lambda: F.rfft_packed_psd(xt, dplan)), rfft_device=dev_ms(psd_closed),
                 torch_fft=dev_ms(lambda: torch.fft.rfft(xt).abs().square()))
    finally:
        F.transform_axis0 = axis0
        restore()
        config.PRECISION = "full"
    del img_t, panel_t
    if (P.RFFT_PACK_MIN, P.AXIS0_H_MIN) != shut or P.rfft_pack_applies(1, 1 << 22) \
            or P.axis0_applies(IMAGE, IMAGE):
        fail(f"the gates were not closed again: {(P.RFFT_PACK_MIN, P.AXIS0_H_MIN)}, want {shut}")
    print(f"  both gates closed again (RFFT_PACK_MIN, AXIS0_H_MIN = {shut})")
    print(f"  launches in phase 3i: {launched}")
    report["gate_closed_launches"] = launched
    stamp("phase 3i geometries")
    check_geometries(report, geometries, "phase 3i")
    torch.cuda.empty_cache()  # the soak's and the panel's blocks
    return launched


def precision_times(report: dict, dev, time_pair, randn, shapes=PRECISION_SHAPES) -> None:
    """Phase 4's rows for phase 3h: K2F / K1F / K3F against their plain
    versions and bounds (K2F / K1F beside torch.fft on complex32), then
    fft_device in each mode beside torch.fft.fft in fp32 and on complex32."""
    import torch

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.kernels import fused as K

    def half(fn, t):
        """torch.fft on complex32 (cuFFT's half precision), or None with the
        refusal's text where cuFFT refuses the size."""
        z = t.to(torch.complex32)
        try:
            fn(z)
        except RuntimeError as e:
            report.setdefault("complex32_refused", {})[str(tuple(t.shape))] = str(e)[:200]
            return None
        return lambda: fn(z)

    for name, n in (("whole_transform_packed_bf16", 1024), ("whole_transform_bf16", 4096),
                    ("whole_transform_bf16", 16384)):
        make = P.get_whole_packed_plan if "packed" in name else P.get_whole_plan
        fwd = P.on_device(make, n, -1, None, device=dev)
        inv = P.on_device(make, n, 1, 1.0 / n, device=dev)
        x, xi = randn(1, n), randn(1, n)
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        for label, args, z, lib, cplx in (("real fwd", (x, None, fwd), torch.complex(x, torch.zeros_like(x)),
                                           torch.fft.fft, False),
                                          ("complex inv 1/n", (x, xi, inv), torch.complex(x, xi),
                                           torch.fft.ifft, True)):
            ms, wall, lat = fast_whole_bound(n, cplx)
            rec = time_pair(f"{name} B=1 n={n} {label}", name, lambda a=args: kern(*a), lambda a=args: plain(*a),
                            (ms, wall), half(lib, z), profiles=5)
            rec.update(latency_wall_ms=lat, library="torch.fft on complex32")
    def k3f_pair(label, x, xi, n1, n2, plan, ct, tiles=None, rows=None):
        """K3F against its plain version and bound, with L2 flushed too (K3
        at the same shapes: this phase's stage_a rows)."""
        r, ncols = K._stage_a_extent(n1, n2, plan, ct, tiles, rows)
        rec = time_pair(label, "stage_a_bf16", lambda: K.stage_a_bf16(x, xi, n1, n2, plan, ct, tiles, rows),
                        lambda: K.stage_a_bf16_plain(x, xi, n1, n2, plan, ct, tiles, rows),
                        fast_stage_a_bound(n1, n2, r, xi is not None, ct, ncols=ncols, batch=x.shape[0]),
                        cold="stage_a")
        rec.update(geometry=K.stage_a_bf16_geometry(x.shape[0], n1, n2, r, ncols, xi is not None, K.sm_count(dev)))
        print(f"    geometry {rec['geometry']}")

    for n in (1 << 20, 1 << 22):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        x, xi = randn(1, n1, n2), randn(1, n1, n2)
        k3f_pair(f"stage_a_bf16 n={n} real rows={rows}", x, None, n1, n2, plan, ct, rows=rows)
        inv = P.on_device(P.get_stage_a_plan, n, 1, ct, device=dev)
        k3f_pair(f"stage_a_bf16 n={n} complex inv", x, xi, n1, n2, inv, ct)
        fold = P.on_device(P.get_stage_a_plan, n, 1, None, device=dev)
        tiles = -(-(n2 // 2 + 1) // fold["ct"])
        k3f_pair(f"stage_a_bf16 n={n} inv col_tiles={tiles}/{n2 // fold['ct']} ct={fold['ct']}", x, xi, n1, n2,
                 fold, fold["ct"], tiles)
        del x, xi

    rows = []
    try:
        for b, n in shapes:
            x = randn(b, n)
            lib32 = cuda_ms(lambda: torch.fft.fft(x))
            lib32_dev = device_ms(lambda: torch.fft.fft(x))[0]
            h = half(torch.fft.fft, torch.complex(x, torch.zeros_like(x)))
            lib16, lib16_dev = (cuda_ms(h), device_ms(h)[0]) if h else (None, None)
            for mode in PRECISION_BANDS:
                config.PRECISION = mode
                ms = cuda_ms(lambda: gt.fft_device(x))
                dev_ms, top = device_ms(lambda: gt.fft_device(x))
                rows.append(dict(what=f"fft_device B={b} n={n} mode={mode}", ms=ms, device_ms=dev_ms,
                                 torch_fft_ms=lib32, torch_fft_device_ms=lib32_dev, torch_fft_complex32_ms=lib16,
                                 torch_fft_complex32_device_ms=lib16_dev, top_kernels=top))
                print(f"  fft_device B={b:<3d} n={n:<8d} {mode:4s} events {ms:.4f} ms device "
                      f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} | torch.fft fp32 {lib32:.4f} "
                      f"(device {lib32_dev if lib32_dev is None else round(lib32_dev, 4)}) complex32 "
                      f"{'refused' if lib16 is None else f'{lib16:.4f}'} (device "
                      f"{lib16_dev if lib16_dev is None else round(lib16_dev, 4)}) ms")
            del x
    finally:
        config.PRECISION = "full"
    report["precision_times"] = rows


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
    from gpu_fft_tpu_torch.kernels import matched as Mk
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
        time_matched,
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
    max_err = {name: 0.0 for name in (*K.COUNTS, *A.COUNTS, *E.COUNTS, *Pr.COUNTS, *Mk.COUNTS)}

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

    # K4 at the shapes the staged path gives it: B = 1 at 2^17, 2^20, 2^22
    # and 2^24 (n1 = 256), and the matched filter's (64, 128, 8,192); the
    # forward unscaled, the inverse with 1/n in its store.
    for b, n in STAGE_B_CASES:
        for sign in (-1, 1):
            plan = P.on_device(P.get_stage_a_plan, n, sign, P.stage_a_ct_full_range(n), device=dev)
            n1, n2 = plan["n1"], plan["n2"]
            args = (n1, n2, plan["stage_b"], P.on_device(P.get_stage_b_twiddle, n2, sign, device=dev),
                    1.0 / n if sign > 0 else None)
            yr, yi = randn(b, n1, n2), randn(b, n1, n2)
            compare("stage_b", f"({b}, {n1}, {n2}) sign {sign:+d}{' 1/n' if sign > 0 else ''} "
                    f"{K.stage_b_geometry(n1, n2 // 128)}", K.stage_b_kernel(yr, yi, *args),
                    K.stage_b_kernel_plain(yr, yi, *args))
            del yr, yi
        torch.cuda.synchronize()

    # The matched filter's kernels: the correlation (q and the norm's sum),
    # then the SNR epilogue on the inverse (rho, the peak; the peak's index
    # the first maximum of the outputs' |rho|^2) over the cell's window and
    # over one whose edges are no multiple of 4 (the 4-byte path), strided
    # template rows as the benchmark passes them; then one whole call, its
    # launches pinned and added into the kernels line's.
    matched_launches = dict.fromkeys(MATCHED_LAUNCHES, 0)
    for t, n in MATCHED_CASES:
        x = time_matched.make_input(t, n, dev, t * n)
        kmin, start, stop = time_matched.layout(n)
        args = (x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0], kmin)
        got, want = Mk.matched_correlate(*args), Mk.matched_correlate_plain(*args)
        compare("matched_correlate", f"({t}, {n}) kmin={kmin} q", got[:2], want[:2])
        compare("matched_correlate", f"({t}, {n}) norm's sum", (got[2].double().sum(-1),),
                (want[2].double().sum(-1),))
        yr, yi = gt.ifft_device(*got[:2])
        for lo, hi in ((start, stop), (start + 1, stop - 2)):
            sr, si, peak, at = Mk.matched_snr(yr, yi, got[2], 0.5, lo, hi)
            wr, wi, wpeak, _ = Mk.matched_snr_plain(yr, yi, want[2], 0.5, lo, hi)
            compare("matched_snr", f"({t}, {n}) [{lo}, {hi}) rho, peak", (sr, si, peak), (wr, wi, wpeak))
            mag = torch.addcmul(sr * sr, si, si)
            if not torch.equal(at, mag.argmax(dim=-1) + lo) or not torch.equal(peak, mag.max(dim=-1).values.sqrt()):
                fail(f"matched_snr ({t}, {n}) [{lo}, {hi}): the peak is not the first largest |rho| of the outputs")
        K.reset_counts()
        Mk.reset_counts()
        gt.matched_filter_device(*args[:5], delta_f=0.5, kmin=kmin, valid=(start, stop))
        torch.cuda.synchronize()
        launched = {**{k: c.launches for k, c in Mk.COUNTS.items()},
                    **{k: c.launches for k, c in K.COUNTS.items() if c.launches}}
        print(f"  matched_filter_device ({t}, {n}): launches {launched}")
        if launched != {**MATCHED_LAUNCHES, "stage_a": 1, "stage_b": 1} or any(
                c.plain_calls for c in (*Mk.COUNTS.values(), *K.COUNTS.values())):
            fail(f"matched_filter_device ({t}, {n}) launched {launched}")
        for k in matched_launches:
            matched_launches[k] += launched[k]
        del x, got, want, yr, yi, sr, si, wr, wi, mag
        torch.cuda.synchronize()
    K.reset_counts()
    Mk.reset_counts()

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

    # K3LF and S2F, the "fast" forms of K3-legacy and S2 (phase 5 runs them).
    fast_legacy_err = fast_legacy_checks(report, dev, randn)

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
    for n in (1 << 20, 1 << 22):  # K4: the complex inverse's stage B, the real forward's is torch
        if per_size[n]["stage_b"] != 1:
            fail(f"stage_b was launched {per_size[n]['stage_b']} times by the main path at n={n}, expected 1")
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

    # ── Phase 3e: the 2-D / N-D path, NATIVE and the examples ───────────────
    stamp("phase 3e")
    print("phase 3e: the 2-D / N-D path, NATIVE and the examples on device='cuda' against numpy / scipy "
          "in float64")
    twod_launches = twod_phase(report, dev, rng)

    # ── Phase 3f: the scipy.fft / scipy.signal namespaces and the FNO ───────
    stamp("phase 3f")
    print("phase 3f: the scipy.fft / scipy.signal namespaces and the FNO on device='cuda' against scipy in "
          "float64 and the float64 twin")
    namespace_launches = namespace_phase(report, dev, rng)
    fno_launches = fno_phase(report, dev)

    # ── Phase 3g: the parallel layer, the mesh steps, serving and the CLI ───
    stamp("phase 3g")
    print("phase 3g: the parallel layer at world size 1 over NCCL, the mesh train steps, serving artifacts, "
          "and the CLI on device='cuda'")
    parallel_launches = parallel_phase(report, dev, rng)

    # ── Phase 3h: the precision modes ───────────────────────────────────────
    stamp("phase 3h")
    print("phase 3h: the precision modes full / high / fast on device='cuda' against numpy in float64")
    precision = precision_phase(report, dev, rng)

    # ── Phase 3i: the gate-closed engines ───────────────────────────────────
    stamp("phase 3i")
    print("phase 3i: the gate-closed engines, each gate opened inside the phase only, against numpy in float64")
    gate_launches = gate_closed_phase(report, dev, rng)

    # ── Phase 4: warm median times (CUDA events) ────────────────────────────
    stamp("phase 4")
    print(f"phase 4: warm medians, CUDA events ({smi})")
    kernel_ms = {}

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    flush_buf = torch.ones(64 << 20, device=dev)  # 256 MiB, five times the H100's L2

    def time_pair(label, name, kern_fn, plain_fn, bnd, lib_fn=None, dense=None, cold=None, profiles=1):
        """Kernel, plain version and (where one exists) the library call:
        event and profiler times, and the kernel's share of its bound (and
        of ``dense``, the dense products' bound, where given).  With
        ``cold`` (a part of the kernel's profiled name) the kernel's device
        time is also taken with L2 flushed before each call (a read of
        ``flush_buf``), and the shares read that time.  With ``profiles`` >
        1 the kernel's device time is the median of that many profiles,
        its min and max recorded beside."""
        k_ms, p_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        spread = {}

        def dev_time(fn, key):
            samples = [t for t in (device_ms(fn)[0] for _ in range(profiles)) if t is not None]
            if profiles > 1:
                spread[key] = dict(median=statistics.median(samples) if samples else None,
                                   min=min(samples, default=None), max=max(samples, default=None),
                                   profiles=len(samples))
            return statistics.median(samples) if samples else None

        k_dev, p_dev = dev_time(kern_fn, "device_ms_spread"), device_ms(plain_fn)[0]
        lib_ms, lib_dev = (cuda_ms(lib_fn), device_ms(lib_fn)[0]) if lib_fn else (None, None)
        cold_dev = device_ms(lambda: (flush_buf.sum(), kern_fn()), match=cold)[0] if cold else None
        shared = cold_dev if cold else k_dev
        share = None if shared is None else bnd[0] / shared
        rec = dict(what=label, kernel=name, ms=k_ms, plain_ms=p_ms, device_ms=k_dev,
                   plain_device_ms=p_dev, bound_ms=bnd[0], bound_by=bnd[1], share_of_bound=share,
                   library_ms=lib_ms, library_device_ms=lib_dev)
        if cold:
            rec.update(cold_device_ms=cold_dev)
        rec.update(spread)
        if dense:
            rec.update(dense_bound_ms=dense[0], dense_bound_by=dense[1],
                       share_of_dense_bound=None if shared is None else dense[0] / shared)
        report["times"].append(rec)
        print(f"  {label:44s} events: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms"
              + (f" library {lib_ms:.4f} ms" if lib_fn else "")
              + f" | device: kernel {fmt(k_dev)} plain {fmt(p_dev)}"
              + ("" if "device_ms_spread" not in spread else
                 f" (median of {spread['device_ms_spread']['profiles']}, {fmt(spread['device_ms_spread']['min'])}"
                 f" - {fmt(spread['device_ms_spread']['max'])})")
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
    # K4 as the inverse runs it (1/n in its store): first the matched
    # filter's (64, 128, 8,192), the kernels line's row, then B = 1 at 2^17
    # and 2^22.  No one PyTorch call computes stage B (library: none).
    for b, n in STAGE_B_TIMED:
        plan = P.on_device(P.get_stage_a_plan, n, 1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2 = plan["n1"], plan["n2"]
        args = (n1, n2, plan["stage_b"], P.on_device(P.get_stage_b_twiddle, n2, 1, device=dev), 1.0 / n)
        yr, yi = randn(b, n1, n2), randn(b, n1, n2)
        rec = time_pair(f"stage_b ({b}, {n1}, {n2}) inv 1/n", "stage_b",
                        lambda: K.stage_b_kernel(yr, yi, *args), lambda: K.stage_b_kernel_plain(yr, yi, *args),
                        stage_b_bound(b, n1, n2))
        rec.update(geometry=K.stage_b_geometry(n1, n2 // 128))
        del yr, yi
    # The matched filter's kernels at the cell's shape; no one PyTorch call
    # computes either (library: none).
    t, n = MATCHED_CASES[-1]
    x = time_matched.make_input(t, n, dev, t * n)
    kmin, start, stop = time_matched.layout(n)
    args = (x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0], kmin)
    corr_bound, snr_bound = (bound(0, "fp32", b) for b in time_matched.bytes_moved(t, n))
    time_pair(f"matched_correlate ({t}, {n}) kmin={kmin}", "matched_correlate",
              lambda: Mk.matched_correlate(*args), lambda: Mk.matched_correlate_plain(*args), corr_bound)
    qr, qi, parts = Mk.matched_correlate(*args)
    pparts = Mk.matched_correlate_plain(*args)[2]
    yr, yi = gt.ifft_device(qr, qi)
    del qr, qi
    time_pair(f"matched_snr ({t}, {n}) [{start}, {stop}) + peak", "matched_snr",
              lambda: Mk.matched_snr(yr, yi, parts, 0.5, start, stop),
              lambda: Mk.matched_snr_plain(yr, yi, pparts, 0.5, start, stop), snr_bound)
    del x, yr, yi
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
            # K3LF beside K3-legacy (above) and K3F (phase 3h's rows), back
            # to back and with L2 flushed; S2F beside S2 and S3 bf16_x1.
            time_pair(f"stage_a_legacy_bf16 n={n} real all rows", "stage_a_legacy_bf16",
                      lambda: K.stage_a_bf16(x, None, n1, n2, legacy, lct),
                      lambda: K.stage_a_bf16_plain(x, None, n1, n2, legacy, lct),
                      fast_stage_a_bound(n1, n2, n1, False, None), cold="stage_a_bf16")
            inv_legacy = P.on_device(ablate_large.make_plan, n, n1, 1, device=dev)
            xi = randn(1, n1, n2)
            time_pair(f"stage_a_legacy_bf16 n={n} complex all rows", "stage_a_legacy_bf16",
                      lambda: K.stage_a_bf16(x, xi, n1, n2, inv_legacy, lct),
                      lambda: K.stage_a_bf16_plain(x, xi, n1, n2, inv_legacy, lct),
                      fast_stage_a_bound(n1, n2, n1, True, None), cold="stage_a_bf16")
            del xi
            time_pair(f"stage_a_manual_bf16 n={n} n1={n1} real", "stage_a_manual_bf16",
                      lambda: A.stage_a_manual_bf16(x2, legacy), lambda: A.stage_a_manual_bf16_plain(x2, legacy),
                      fast_stage_a_bound(n1, n2, n1, False, None))
            wide = A.manual_tables(P.on_device(ablate_large.make_plan, n, 256, -1, device=dev))
            x256 = randn(256, n // 256)
            time_pair(f"stage_a_manual n={n} n1=256 real", "stage_a_manual",
                      lambda: A.stage_a_manual(x256, wide), lambda: A.stage_a_manual_plain(x256, wide),
                      dense_stage_a_bound(256, n // 256, 256))
            time_pair(f"stage_a_manual_bf16 n={n} n1=256 real", "stage_a_manual_bf16",
                      lambda: A.stage_a_manual_bf16(x256, wide), lambda: A.stage_a_manual_bf16_plain(x256, wide),
                      fast_stage_a_bound(256, n // 256, 256, False, None))
            del x256, wide
        time_pair(f"stage_a_legacy n={n} real rows={rows}", "stage_a_legacy",
                  lambda: K.stage_a(x, None, n1, n2, legacy, lct, rows=rows),
                  lambda: K.stage_a_plain(x, None, n1, n2, legacy, lct, rows=rows),
                  stage_a_bound(n1, n2, rows, False, None), dense=dense_stage_a_bound(n1, n2, rows),
                  cold="stage_a_radix")
        if n == 1 << 22:
            time_pair(f"stage_a_legacy_bf16 n={n} real rows={rows}", "stage_a_legacy_bf16",
                      lambda: K.stage_a_bf16(x, None, n1, n2, legacy, lct, rows=rows),
                      lambda: K.stage_a_bf16_plain(x, None, n1, n2, legacy, lct, rows=rows),
                      fast_stage_a_bound(n1, n2, rows, False, None), cold="stage_a_bf16")
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
    # K3 at the panel's geometry: the row pass of fft2 / ifft2 at B = 512.
    b, n = PANEL
    plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
    inv = P.on_device(P.get_stage_a_plan, n, 1, P.stage_a_ct_full_range(n), device=dev)
    n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
    rows = P.stage_a_real_rows(n1)
    xr, xi = randn(b, n1, n2), randn(b, n1, n2)
    time_pair(f"stage_a B={b} n={n} real rows={rows}", "stage_a",
              lambda: K.stage_a(xr, None, n1, n2, plan, ct, rows=rows),
              lambda: K.stage_a_plain(xr, None, n1, n2, plan, ct, rows=rows),
              stage_a_bound(n1, n2, rows, False, ct, batch=b))
    time_pair(f"stage_a B={b} n={n} complex inv", "stage_a",
              lambda: K.stage_a(xr, xi, n1, n2, inv, ct),
              lambda: K.stage_a_plain(xr, xi, n1, n2, inv, ct),
              stage_a_bound(n1, n2, n1, True, ct, batch=b))
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
    twod_times(report, dev)
    namespace_fno_times(report, dev)
    parallel_times(report, dev)
    precision_times(report, dev, time_pair, randn)

    # ── Phase 5: the second path, the stage-A ablation harnesses ────────────
    stamp("phase 5")
    print("phase 5: stage-A ablation harnesses, quick setting (device times from CUDA graphs)")
    K.reset_counts()
    A.reset_counts()
    large_res = ablate_large.main(quick=True, out_dir=str(out_dir))
    levers_res = ablate_2e20_levers.main(quick=True, out_dir=str(out_dir))
    x6_res = ablate_mosaic_x6.main(quick=True, out_dir=str(out_dir))
    second_launches = {k: c.launches for k, c in {**K.COUNTS, **A.COUNTS}.items()
                       if k not in (*MAIN_PATH_KERNELS, *FAST_KERNELS.values(), *FAST_LEGACY_KERNELS.values())}
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

    # ── Phase 5 under "fast": the same path through K3LF and S2F ────────────
    stamp("phase 5 fast")
    print("phase 5, GPU_FFT_TPU_PRECISION=fast: ablate_large, ablate_2e20_levers (quick) and time_stage_a's "
          "legacy rows through K3LF and S2F")
    fast_legacy = fast_legacy_phase(report, dev, out_dir)

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
        "stage_b": ("gpu_fft_tpu_torch/csrc/stage_b.cu",
                    "none: stage B is XLA einsums, gpu_fft_tpu/kernels/fused_jnp.py:142 stage_b_jnp"),
        "whole_transform_packed_bf16": ("gpu_fft_tpu_torch/csrc/whole_bf16.cu", "gpu_fft_tpu/kernels/fused.py:383"),
        "whole_transform_bf16": ("gpu_fft_tpu_torch/csrc/whole_bf16.cu", "gpu_fft_tpu/kernels/fused.py:424"),
        "stage_a_bf16": ("gpu_fft_tpu_torch/csrc/stage_a_bf16.cu", "gpu_fft_tpu/kernels/fused.py:188"),
        "stage_a_manual": ("gpu_fft_tpu_torch/csrc/dense_f32.cuh", "scripts/ablate_2e20_levers.py:188"),
        "stage_a_legacy_bf16": ("gpu_fft_tpu_torch/csrc/stage_a_bf16.cu", "gpu_fft_tpu/kernels/fused.py:153"),
        "stage_a_manual_bf16": ("gpu_fft_tpu_torch/csrc/stage_a_manual_bf16.cu", "scripts/ablate_2e20_levers.py:188"),
        **{f"stage_a_dot_{v}": ("gpu_fft_tpu_torch/csrc/stage_a_dot.cu", "scripts/ablate_mosaic_x6.py:105")
           for v in A.VARIANTS},
        "fused_fft_lm": ("gpu_fft_tpu_torch/csrc/fused_lm.cu", "scripts/ablate_engines.py:111"),
        "operand_probe": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/ablate_whole_packed.py:66"),
        "copy_min": ("gpu_fft_tpu_torch/csrc/probes.cu", "scripts/calibrate_latency.py:79"),
        **dict.fromkeys(MATCHED_LAUNCHES, ("gpu_fft_tpu_torch/csrc/matched.cu",
                                           "none: the JAX package has no matched filter")),
    }
    # The main path's launches: fft/ifft and the real-output path together.
    # Phase 3i's stand apart (gate_closed_path_launches): no tuning row
    # takes the gate-closed routes.
    all_launches = {**{k: main_launches[k] + irfft_launches[k] + grad_launches[k] + analysis_launches[k]
                          + filter_launches[k] + twod_launches[k] + namespace_launches[k] + fno_launches[k]
                          + parallel_launches[k]
                       for k in MAIN_PATH_KERNELS},
                    **second_launches, **{k: third_launches[k] for k in CALIBRATION_KERNELS},
                    **precision["launches"],
                    **fast_legacy["launches"],
                    **matched_launches}
    max_err.update(precision["max_err"])
    for name, err in fast_legacy["max_err"].items():
        max_err[name] = max(fast_legacy_err[name], err)
    kernels = []
    for name, (src, rep) in sources.items():
        t = kernel_ms[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=all_launches[name],
            irfft_path_launches=irfft_launches.get(name, 0), grad_path_launches=grad_launches.get(name, 0),
            analysis_path_launches=analysis_launches.get(name, 0),
            filter_path_launches=filter_launches.get(name, 0), twod_path_launches=twod_launches.get(name, 0),
            namespace_path_launches=namespace_launches.get(name, 0), fno_path_launches=fno_launches.get(name, 0),
            parallel_path_launches=parallel_launches.get(name, 0),
            gate_closed_path_launches=gate_launches.get(name, 0),
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
