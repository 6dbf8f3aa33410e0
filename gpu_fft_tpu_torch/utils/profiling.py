"""Timing and tracing on a CUDA card — the port's observability layer.

Counterpart of ``gpu_fft_tpu/utils/profiling.py``.  The JAX package chains
``x = step(x)`` inside ``lax.fori_loop`` for two trip counts and differences
the wall times, which cancels dispatch and readback.  Here the chain is a
**CUDA graph**: ``x = step(x)`` is captured k1 times and k1 + span times
(``torch.cuda.CUDAGraph``), each graph is replayed between two CUDA events,
and the difference over ``span`` is the steady per-step device time with the
host's launch cost cancelled (one graph launch per sample, whatever its
length).  The adaptive span, the paired differencing and the suspect flag
are the JAX package's.

Measuring needs the card: :func:`chained_step_stats` raises for a tensor
that is not on a CUDA device; nothing falls back to the CPU.  The steps
(``fft_forward_step`` …) are plain callables and run anywhere.

A step is captured, so it must be capturable: no host synchronisation and
no first-time table upload inside it (one eager warm-up call runs before
capture for that).  Kernel wrappers count a launch when it is captured.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "BenchResult",
    "TimingStats",
    "benchmark",
    "chained_step_stats",
    "chained_step_time",
    "conv2d_step",
    "dct_roundtrip_step",
    "fft_forward_step",
    "fft_inverse_step",
    "fft_roundtrip_step",
    "fft_sequential_step",
    "firstream_step",
    "hilbert_step",
    "ifft_sequential_step",
    "irfft_step",
    "lfilter_step",
    "oaconvolve_step",
    "resample_step",
    "roundtrip_sequential_step",
    "stft_roundtrip_step",
    "torch_fft_forward_step",
    "torch_fft_inverse_step",
    "torch_fft_roundtrip_step",
    "trace",
    "welch_step",
]


@dataclass(frozen=True)
class TimingStats:
    """Median with IQR and min/max over ``reps`` paired differences."""

    median_s: float
    iqr_s: float
    min_s: float
    max_s: float
    reps: int
    span: int  # chain-length difference (k2 - k1) actually used
    suspect: bool  # non-positive samples seen, or dispersion > median

    @property
    def rel_iqr(self) -> float:
        return self.iqr_s / self.median_s if self.median_s > 0 else float("inf")


class _Chain:
    """``x = step(x)`` captured ``k`` times in one CUDA graph, from ``x0``."""

    def __init__(self, step, x0: torch.Tensor, k: int):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            x = x0
            for _ in range(k):
                x = step(x)

    def seconds(self) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def chained_step_stats(
    step,
    x0,
    k1: int = 50,
    k2: int = 1050,
    reps: int = 5,
    min_span_s: float = 0.08,
    max_span: int = 1 << 14,
    retries: int = 0,
) -> TimingStats:
    """Steady-state per-``step(x)`` device time with dispersion statistics.

    ``step`` must be shape-preserving (its output feeds the next iteration).
    Each sample replays the k1-step graph and the (k1 + span)-step graph
    back to back and takes (t(k1 + span) - t(k1)) / span.

    * **Adaptive span**: a pilot grows ``span`` (at most 8x per probe, up to
      ``max_span``; each probe captures a new graph) until the differenced
      signal is at least ``min_span_s`` of device time.
    * **Paired differencing**: each rep times its own pair, so drift cancels
      per sample.
    * **Positive clamp + suspect flag**: non-positive samples are dropped
      and flagged; an all-bad run doubles the span once, and failing that
      returns the measurement floor with ``suspect=True``.

    The default ``max_span`` is smaller than the JAX package's (2^19): a
    graph holds every captured launch, so a span costs host time and memory
    to capture.
    """
    if not isinstance(x0, torch.Tensor) or x0.device.type != "cuda":
        where = x0.device if isinstance(x0, torch.Tensor) else type(x0).__name__
        raise ValueError(f"chained_step_stats measures on a CUDA card; x0 is on {where}")
    if k2 <= k1:
        raise ValueError(f"k2 ({k2}) must exceed k1 ({k1})")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")

    x0 = x0.clone()
    # Warm-up on a side stream (plans upload, kernels build) before capture.
    side = torch.cuda.Stream(device=x0.device)
    side.wait_stream(torch.cuda.current_stream(x0.device))
    with torch.cuda.stream(side):
        step(step(x0))
    torch.cuda.current_stream(x0.device).wait_stream(side)
    torch.cuda.synchronize(x0.device)

    base_chain = _Chain(step, x0, k1)
    chains: dict[int, _Chain] = {}

    def chain(span_: int) -> _Chain:
        if span_ not in chains:
            chains.clear()  # one long graph alive at a time
            chains[span_] = _Chain(step, x0, k1 + span_)
        return chains[span_]

    def sample(span_: int) -> float:
        long = chain(span_)
        ta = base_chain.seconds()
        tb = long.seconds()
        return (tb - ta) / span_

    base_chain.seconds()  # first replay uploads the graph
    base = base_chain.seconds()
    span = k2 - k1
    while span < max_span:
        long = chain(span)
        long.seconds()
        signal = long.seconds() - base
        if signal >= min_span_s:
            break
        factor = min(8, max(2, int(np.ceil(min_span_s / max(signal, 1e-6)))))
        span = int(min(max_span, span * factor))

    good: list = []
    samples: list = []
    for _attempt in range(3):
        samples = [sample(span) for _ in range(reps)]
        good = [s for s in samples if s > 0]
        if not good:
            span = min(max_span, span * 2)
            continue
        med = float(np.median(good))
        if med * span >= 0.5 * min_span_s or span >= max_span:
            break
        want = np.ceil(min_span_s / max(med, 1e-9))
        span = int(min(max_span, span * 8, max(span * 2, want)))
    suspect = len(good) < len(samples)
    if not good:
        floor = min_span_s / span
        return TimingStats(floor, 0.0, floor, floor, reps, span, True)

    arr = np.asarray(good, dtype=np.float64)
    q1, med, q3 = (float(np.percentile(arr, q)) for q in (25, 50, 75))
    iqr = q3 - q1
    st = TimingStats(
        median_s=med,
        iqr_s=iqr,
        min_s=float(arr.min()),
        max_s=float(arr.max()),
        reps=reps,
        span=span,
        suspect=suspect or iqr > med,
    )
    if st.suspect and retries > 0:
        st2 = chained_step_stats(
            step, x0, k1=k1, k2=k2, reps=reps,
            min_span_s=min_span_s, max_span=max_span, retries=retries - 1,
        )
        if not st2.suspect or st2.iqr_s < st.iqr_s:
            return st2
    return st


def chained_step_time(step, x0, k1: int = 50, k2: int = 1050, reps: int = 5) -> float:
    """Median steady-state seconds per ``step(x)`` on the card."""
    return chained_step_stats(step, x0, k1=k1, k2=k2, reps=reps).median_s


@dataclass(frozen=True)
class BenchResult:
    seconds: float
    elements: int

    @property
    def melem_per_s(self) -> float:
        return self.elements / self.seconds / 1e6

    @property
    def microseconds(self) -> float:
        return self.seconds * 1e6


def benchmark(step, x0, elements: int | None = None, **kwargs) -> BenchResult:
    """Time ``step`` with :func:`chained_step_time`; throughput if sized."""
    sec = chained_step_time(step, x0, **kwargs)
    n = elements if elements is not None else int(np.prod(tuple(x0.shape)))
    return BenchResult(seconds=sec, elements=n)


# ── Shared step builders ─────────────────────────────────────────────────────
# Shape-preserving steps for chained timing; each rescales its output so the
# chained values stay finite.


def fft_forward_step(n: int):
    """x -> re(FFT(x)) / sqrt(n) through the library transform."""
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / np.sqrt(n)))

    def step(x):
        yr, _ = transform_any(x, None, n, -1)
        return yr * s

    return step


def fft_inverse_step(n: int):
    """x -> re(IFFT(x + jx)) / sqrt(n), unnormalized, through the library
    transform; the imaginary part aliases the input, as in the JAX step."""
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / np.sqrt(n)))

    def step(x):
        yr, _ = transform_any(x, x, n, +1)
        return yr * s

    return step


def irfft_step(n: int):
    """x -> inverse_real(x + jx) * sqrt(n/2): the real-output inverse path
    (``kernels/large.py:inverse_real``, 1/n in its tables).  The imaginary
    part aliases the input, as in :func:`fft_inverse_step`; the time is the
    shape's, so a non-Hermitian operand runs the program callers run."""
    from ..kernels.large import inverse_real

    s = float(np.float32(np.sqrt(n / 2.0)))

    def step(x):
        return inverse_real(x, x, n, scale=1.0 / n) * s

    return step


def fft_roundtrip_step(n: int):
    """x -> re(IFFT(FFT(x))) with the 1/n inverse normalization."""
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / n))

    def step(x):
        yr, yi = transform_any(x, None, n, -1)
        rr, _ = transform_any(yr, yi, n, +1)
        return rr * s

    return step


def _sequential_over_rows(row_fn):
    """B one-signal transforms in order (a Python loop over rows, so each row
    is its own sequence of launches): the counterpart of the JAX package's
    ``lax.scan`` over rows."""

    def step(x):  # x: (B, n); returns (B, n)
        return torch.stack([row_fn(x[i]) for i in range(x.shape[0])])

    return step


def fft_sequential_step(n: int):
    """(B, n) -> B sequential scalar forward transforms."""
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / np.sqrt(n)))

    def row(r):
        yr, _ = transform_any(r[None], None, n, -1)
        return yr[0] * s

    return _sequential_over_rows(row)


def ifft_sequential_step(n: int):
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / np.sqrt(n)))

    def row(r):
        yr, _ = transform_any(r[None], r[None], n, +1)
        return yr[0] * s

    return _sequential_over_rows(row)


def roundtrip_sequential_step(n: int):
    from ..kernels.large import transform_any

    s = float(np.float32(1.0 / n))

    def row(r):
        yr, yi = transform_any(r[None], None, n, -1)
        rr, _ = transform_any(yr, yi, n, +1)
        return rr[0] * s

    return _sequential_over_rows(row)


def torch_fft_forward_step(n: int):
    """The vendor-FFT (``torch.fft``, cuFFT on the card) counterpart of
    :func:`fft_forward_step`."""
    s = float(np.float32(1.0 / np.sqrt(n)))

    def step(x):
        return torch.fft.fft(x.to(torch.complex64)).real * s

    return step


def torch_fft_inverse_step(n: int):
    s = float(np.float32(np.sqrt(n)))

    def step(x):
        return torch.fft.ifft(x.to(torch.complex64)).real * s

    return step


def torch_fft_roundtrip_step(n: int):
    def step(x):
        return torch.fft.ifft(torch.fft.fft(x.to(torch.complex64))).real

    return step


# ── Analysis-op steps ────────────────────────────────────────────────────────


def stft_roundtrip_step(frame: int, hop: int):
    """(1, L) -> istft(stft(x)): the whole analysis and synthesis pipeline.
    WOLA reconstruction is idempotent on the covered samples, so chained
    values stay bounded without rescaling."""
    from ..ops.stft import istft_device, stft_device

    def step(x):
        sr, si = stft_device(x[0], frame, hop)
        return istft_device(sr, si, hop, length=x.shape[1])[None]

    return step


def welch_step(nperseg: int):
    """(1, L) -> x + 1e-6 * the Welch PSD tiled to L: the estimate feeds the
    chained value (far below the signal), so every step computes it."""
    from ..ops.spectral import welch_device

    def step(x):
        _, p = welch_device(x[0], nperseg=nperseg)
        length = x.shape[1]
        tiled = p.repeat(-(-length // p.shape[0]))[:length]
        return x + tiled[None] * 1e-6

    return step


# ── Filtering-op steps ───────────────────────────────────────────────────────


def dct_roundtrip_step():
    """(B, n) -> idct(dct(x)), orthonormal (magnitude-stable)."""
    from ..ops.dct import dct_device, idct_device

    def step(x):
        return idct_device(dct_device(x, norm="ortho"), norm="ortho")

    return step


def hilbert_step():
    """(B, n) -> the Hilbert transform of x (the analytic signal's imaginary
    part).  H(H(x)) = -x for zero-mean signals: magnitude-stable."""
    from ..ops.dsp import hilbert_device

    def step(x):
        return hilbert_device(x)[1]

    return step


def oaconvolve_step(n: int, taps, device=None):
    """(B, n) -> x + 1e-6 * the causal FIR filtering of x through the
    overlap-add block path: the filtered signal feeds back far below the
    signal, so every step runs the whole block pipeline.  The taps go to
    ``device`` (default ``"cuda"``) once, here."""
    from ..config import resolve_device
    from ..ops.filter import oaconvolve_device

    h = torch.as_tensor(np.asarray(taps, dtype=np.float32), device=resolve_device(device))

    def step(x):
        return x + oaconvolve_device(x, h)[:, :n] * 1e-6

    return step


def firstream_step(chunk: int, taps: int, batch: int = 1, device=None):
    """(batch, taps - 1 + chunk) [carry | chunk] -> the next [carry |
    filtered]: one ``FIRStream.step`` (a forward and an inverse transform
    at the padded chunk length).  The filtered chunk feeds back; a
    unity-DC-gain lowpass keeps the chain magnitude-stable."""
    from ..ops.filter import FIRStream, firwin

    stream = FIRStream(firwin(taps, 0.3).astype(np.float32), chunk=chunk, batch=batch, device=device)
    t = taps - 1

    def step(c):
        st, y = stream.step(c[:, :t], c[:, t:])
        return torch.cat([st, y], dim=1)

    return step


def conv2d_step(kern, device=None):
    """(B, H, W) -> x + 1e-6 * the full 2-D convolution with ``kern``
    cropped to (H, W): the one-sided 2-D forward of both operands, the
    product and the real-output 2-D inverse every step.  The kernel goes to
    ``device`` (default ``"cuda"``) once, here."""
    from ..config import resolve_device
    from ..ops.filter import fft_convolve2d_device

    k = torch.as_tensor(np.asarray(kern, dtype=np.float32), device=resolve_device(device))

    def step(x):
        return x + fft_convolve2d_device(x, k)[:, : x.shape[1], : x.shape[2]] * 1e-6

    return step


def resample_step(n: int, mid: int):
    """(B, n) -> resample(resample(x, mid), n), down then back up.  After
    the first step the signal is band-limited to the mid rate: a fixed
    point."""
    from ..ops.dsp import resample_device

    def step(x):
        return resample_device(resample_device(x, mid), n)

    return step


def lfilter_step(b, a):
    """(B, n) -> lfilter(b, a, x) through the block-state engine.  A stable
    lowpass contracts the chained value toward zero; it stays finite."""
    from ..ops.iir import lfilter_device

    bb = tuple(float(v) for v in b)
    aa = tuple(float(v) for v in a)

    def step(x):
        return lfilter_device(bb, aa, x)

    return step


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU and CUDA
    activity) and write ``log_dir/trace.json`` (Chrome trace format).

    Usage::

        with profiling.trace("chiprun_out/fft-trace"):
            gt.fft_device(x)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
