"""Power spectral density, the fused fft -> PSD pipeline and the
spectral estimators (``gpu_fft_tpu/ops/spectral.py``).

``welch``, ``csd``, ``coherence`` and ``spectrogram`` segment the signal
(``ops/stft.py:frame_signal``, an unfold view), detrend, window, and run ONE
batched one-sided transform over every segment; ``periodogram`` runs one
exact transform of the whole signal (``ops/exact.py``: any n).  scipy.signal
semantics; every ``*_device`` form stays on the tensor's device and is
differentiable, the host forms take numpy and return numpy.  Which engine a
segment transform takes is the dispatch's (``kernels/large.py``): B > 1 rows
go to the torch four-steps, B = 1 in the band to K1/K2, staged n to K3.
``lombscargle`` is host float64 numpy, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .stft import frame_signal, window_on, window_table
from .transform import _as_tensor, fft_device, rfft_device

__all__ = [
    "coherence",
    "coherence_device",
    "csd",
    "csd_device",
    "lombscargle",
    "one_sided_bins",
    "periodogram",
    "periodogram_device",
    "power_spectrum_device",
    "psd",
    "psd_device",
    "spectrogram",
    "spectrogram_device",
    "spectrogram_scipy",
    "welch",
    "welch_device",
]


def psd(real, imag):
    """Power Spectral Density: (real^2 + imag^2) / n per bin (host, numpy).

    >>> psd([3.0, 0.0, 4.0, 0.0], [4.0, 0.0, 3.0, 0.0]).tolist()
    [6.25, 0.0, 6.25, 0.0]
    """
    r = np.asarray(real, dtype=np.float32)
    i = np.asarray(imag, dtype=np.float32)
    if r.shape != i.shape:
        raise ValueError(f"psd: real and imag must have the same shape, got {r.shape} vs {i.shape}")
    n = np.float32(r.shape[-1])
    return (r * r + i * i) / n


def psd_device(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """PSD over the last axis of tensors, on their device."""
    if real.shape != imag.shape:
        raise ValueError(
            f"psd_device: real and imag must have the same shape, got {real.shape} vs {imag.shape}"
        )
    return (real * real + imag * imag) * (1.0 / real.shape[-1])


def one_sided_bins(n: int) -> int:
    """Number of unique bins of a real-signal spectrum: n // 2 + 1."""
    return n // 2 + 1


def power_spectrum_device(x, backend=None, one_sided: bool = True, device=None):
    """fft -> PSD of (n,) or (B, n) real rows on the device, optionally only
    the n // 2 + 1 one-sided bins."""
    yr, yi = fft_device(x, backend=backend, device=device)
    p = psd_device(yr, yi)
    if one_sided:
        p = p[..., : one_sided_bins(p.shape[-1])]
    return p


def spectrogram_device(x, frame_size: int, hop: int | None = None, one_sided: bool = True,
                       window: str | None = None, device=None):
    """STFT-magnitude spectrogram: the signal framed into overlapping
    windows and ONE batched transform over all frames.

    ``x``: (n_samples,) real f32; ``frame_size``: a power of two; ``hop``
    defaults to frame_size (no overlap); ``window``: None (rectangular) or
    any window :func:`.stft.window_table` takes.  Returns the (num_frames,
    bins) PSD; frames that would run past the end of the signal are dropped.
    """
    if frame_size < 2 or frame_size & (frame_size - 1):
        raise ValueError(f"frame_size must be a power of two >= 2, got {frame_size}")
    hop = frame_size if hop is None else hop
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    x = _as_tensor(x, device)
    if x.dim() != 1:
        raise ValueError(f"spectrogram expects a 1-D signal, got shape {tuple(x.shape)}")
    n = x.shape[0]
    num_frames = (n - frame_size) // hop + 1
    if num_frames < 1:
        raise ValueError(f"signal of {n} samples is shorter than one {frame_size} frame")
    frames = frame_signal(x, frame_size, hop, num_frames)
    if window is not None:
        frames = frames * window_on(window, frame_size, x.device)
    return power_spectrum_device(frames, one_sided=one_sided)


def spectrogram(x, frame_size: int, hop: int | None = None, one_sided: bool = True,
                window: str | None = None, device=None):
    """Host-convenience spectrogram; see :func:`spectrogram_device`."""
    p = spectrogram_device(np.asarray(x, dtype=np.float32), frame_size, hop, one_sided, window,
                           device=device)
    return p.cpu().numpy()


def spectrogram_scipy(
    x,
    fs: float = 1.0,
    window=("tukey", 0.25),
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend: bool | str = "constant",
    scaling: str = "density",
    mode: str = "psd",
    device=None,
):
    """Drop-in ``scipy.signal.spectrogram``: returns ``(f, t, Sxx)``.

    The per-segment counterpart of :func:`welch` (same segmentation,
    windowing, detrend and scaling; welch is this averaged over ``t``), with
    scipy's defaults: tukey(0.25) window, ``noverlap`` nperseg // 8, segment
    times at the window centres.  ``mode``: "psd" (Sxx (bins, num_seg)),
    "magnitude" (|STFT| scaled by the square root of the PSD scale, no
    one-sided doubling) or "complex" (split-complex ``(Sr, Si)``).  Sxx is
    numpy.
    """
    if mode not in ("psd", "magnitude", "complex"):
        raise ValueError(f"mode must be psd|magnitude|complex, got {mode!r}")
    noverlap = nperseg // 8 if noverlap is None else noverlap
    xv = np.asarray(x, dtype=np.float32)
    yr, yi = _segment_spectra(xv, nperseg, noverlap, window, detrend, fs, scaling, "spectrogram",
                              nfft, device=device)
    nbins = nperseg if nfft is None else nfft
    hop = nperseg - noverlap
    num_seg = yr.shape[-2]
    freqs = np.arange(nbins // 2 + 1, dtype=np.float64) * (fs / nbins)
    times = (nperseg / 2.0 + hop * np.arange(num_seg)) / fs
    yr, yi = yr.cpu().numpy(), yi.cpu().numpy()
    if mode == "psd":
        sxx = (yr * yr + yi * yi) * _welch_scale_mult(window, nperseg, fs, scaling, nfft)
        return freqs, times, np.moveaxis(sxx, -2, -1)  # (..., bins, num_seg)
    w64 = window_table(window, nperseg).astype(np.float64)
    if scaling == "density":
        s = np.float32(np.sqrt(1.0 / (fs * np.sum(w64 * w64))))
    else:
        s = np.float32(1.0 / np.sum(w64))
    if mode == "magnitude":
        return freqs, times, np.moveaxis(np.hypot(yr, yi) * s, -2, -1)
    return freqs, times, (np.moveaxis(yr * s, -2, -1), np.moveaxis(yi * s, -2, -1))


@functools.lru_cache(maxsize=64)
def _centred_time(n: int, device: torch.device):
    """(arange(n) - (n - 1)/2) as f32 on ``device`` and sum of its squares."""
    tc = np.arange(n) - (n - 1) / 2.0
    return torch.from_numpy(tc.astype(np.float32)).to(device), float(np.float32(np.sum(tc * tc)))


def _detrend_rows(rows, mode):
    """Per-row detrend over the last axis: False/None off; True/'constant'
    removes the mean; 'linear' removes the least-squares line
    (``scipy.signal.detrend``)."""
    if mode is False or mode is None:
        return rows
    if mode is True or mode == "constant":
        return rows - rows.mean(dim=-1, keepdim=True)
    if mode == "linear":
        t, denom = _centred_time(rows.shape[-1], rows.device)
        mean = rows.mean(dim=-1, keepdim=True)
        slope = (rows * t).sum(dim=-1, keepdim=True) / denom
        return rows - mean - slope * t
    raise ValueError(f"detrend must be False, 'constant', or 'linear', got {mode!r}")


def _welch_scale_mult(window, nperseg: int, fs: float, scaling: str,
                      nfft: int | None = None) -> np.ndarray:
    """One-sided per-bin scale of the Welch-family estimators (scipy
    semantics): the window normalization times the interior-bin doubling.
    ``nfft`` >= nperseg pads the segments (finer bin grid); the window sums
    are unchanged."""
    nfft = nperseg if nfft is None else nfft
    w64 = window_table(window, nperseg).astype(np.float64)
    if scaling == "density":
        scale = 1.0 / (fs * float(np.sum(w64 * w64)))
    else:
        scale = 1.0 / float(np.sum(w64)) ** 2
    h = nfft // 2 + 1
    mult = np.full(h, 2.0 * scale, dtype=np.float32)
    mult[0] = scale
    if nfft % 2 == 0:
        mult[-1] = scale
    return mult


@functools.lru_cache(maxsize=64)
def _scale_mult_on(window, nperseg: int, fs: float, scaling: str, nfft, device: torch.device):
    """:func:`_welch_scale_mult` as a tensor on ``device``, made once."""
    return torch.from_numpy(_welch_scale_mult(window, nperseg, fs, scaling, nfft)).to(device)


def _segment_spectra(x, nperseg: int, noverlap: int | None, window, detrend, fs: float,
                     scaling: str, name: str, nfft: int | None = None, device=None):
    """The Welch family's front end: validate, segment, detrend, window and
    run ONE batched one-sided transform.  Returns split-complex (num_seg,
    bins) tensors, (channels, num_seg, bins) for a 2-D input."""
    if scaling not in ("density", "spectrum"):
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    nfft = nperseg if nfft is None else nfft
    if nfft < nperseg or nfft & (nfft - 1):
        raise ValueError(f"nfft must be a power of two >= nperseg, got {nfft}")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    if fs <= 0:
        raise ValueError(f"fs must be positive, got {fs}")
    hop = nperseg - noverlap
    x = _as_tensor(x, device)
    if x.dim() not in (1, 2):
        raise ValueError(f"{name} expects a 1-D signal or (channels, n), got shape {tuple(x.shape)}")
    n = x.shape[-1]
    num_seg = (n - nperseg) // hop + 1
    if num_seg < 1:
        raise ValueError(f"signal of {n} samples is shorter than one {nperseg} segment")
    segs = _detrend_rows(frame_signal(x, nperseg, hop, num_seg), detrend)
    segs = segs * window_on(window, nperseg, x.device)
    if nfft > nperseg:  # finer bin grid: zero-pad the windowed segments
        segs = F.pad(segs, (0, nfft - nperseg))
    yr, yi = rfft_device(segs.reshape(-1, nfft))
    shape = (*x.shape[:-1], num_seg, nfft // 2 + 1)
    return yr.reshape(shape), yi.reshape(shape)


def _median_bias(n: int) -> float:
    """Bias of the median of ``n`` iid exponential periodogram values
    relative to their mean (the scipy.signal correction factor)."""
    ii2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii2 + 1.0) - 1.0 / ii2))


def _median_over_segments(p):
    """numpy's median over axis -2: the middle value, or the mean of the two
    middle values for an even count."""
    s = torch.sort(p, dim=-2).values
    m = s.shape[-2]
    if m % 2:
        return s[..., m // 2, :]
    return (s[..., m // 2 - 1, :] + s[..., m // 2, :]) * 0.5


def welch_device(
    x,
    fs: float = 1.0,
    window: str | None = "hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: bool | str = True,
    scaling: str = "density",
    average: str = "mean",
    nfft: int | None = None,
    device=None,
):
    """Welch averaged-periodogram PSD estimate, on the tensor's device.

    Splits ``x`` into overlapping ``nperseg``-sample segments (a power of
    two; ``noverlap`` defaults to nperseg // 2), removes each segment's mean
    (``detrend``), windows them, runs ONE batched one-sided transform over
    all segments and averages the per-bin power; interior bins are doubled.
    ``scaling``: "density" (V**2/Hz) or "spectrum" (V**2); ``average``:
    "mean" or "median" (bias-corrected) — ``scipy.signal.welch`` semantics.

    Returns ``(freqs, psd)``: freqs a numpy array of the nfft // 2 + 1 bin
    frequencies, psd a tensor; a (channels, n) input gives (channels, bins).
    """
    with span("gft.entry.welch"):
        if average not in ("mean", "median"):
            raise ValueError(f"average must be 'mean' or 'median', got {average!r}")
        yr, yi = _segment_spectra(x, nperseg, noverlap, window, detrend, fs, scaling, "welch", nfft,
                                  device=device)
        nbins = nperseg if nfft is None else nfft
        seg_power = yr * yr + yi * yi  # (..., num_seg, bins)
        if average == "median":
            power = _median_over_segments(seg_power) / float(
                np.float32(_median_bias(seg_power.shape[-2]))
            )
        else:
            power = seg_power.mean(dim=-2)
        freqs = np.arange(nbins // 2 + 1, dtype=np.float64) * (fs / nbins)
        return freqs, power * _scale_mult_on(window, nperseg, fs, scaling, nfft, power.device)


def welch(x, fs: float = 1.0, window: str | None = "hann", nperseg: int = 256,
          noverlap: int | None = None, detrend: bool | str = True, scaling: str = "density",
          average: str = "mean", nfft: int | None = None, device=None):
    """Host-convenience Welch PSD; see :func:`welch_device`.  Returns
    ``(freqs, psd)`` as numpy arrays."""
    freqs, p = welch_device(np.asarray(x, dtype=np.float32), fs, window, nperseg, noverlap,
                            detrend, scaling, average, nfft, device=device)
    return freqs, p.cpu().numpy()


def _pair(x, y, name: str, device):
    x = _as_tensor(x, device)
    y = _as_tensor(y, x.device if device is None else device)
    if x.shape != y.shape:
        raise ValueError(f"{name}: signals must share one shape, got {tuple(x.shape)} vs {tuple(y.shape)}")
    return x, y


def csd_device(
    x,
    y,
    fs: float = 1.0,
    window: str | None = "hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: bool | str = True,
    scaling: str = "density",
    nfft: int | None = None,
    device=None,
):
    """Cross spectral density Pxy by Welch's method, on the tensors' device.

    ``scipy.signal.csd`` semantics: Pxy = mean over segments of conj(X) * Y
    with :func:`welch_device`'s windowing and scaling (csd(x, x) ==
    welch(x)).  Returns ``(freqs, (pxy_re, pxy_im))``.
    """
    x, y = _pair(x, y, "csd", device)
    xr, xi = _segment_spectra(x, nperseg, noverlap, window, detrend, fs, scaling, "csd", nfft)
    yr, yi = _segment_spectra(y, nperseg, noverlap, window, detrend, fs, scaling, "csd", nfft)
    nbins = nperseg if nfft is None else nfft
    pr = (xr * yr + xi * yi).mean(dim=-2)  # conj(X) * Y
    pi = (xr * yi - xi * yr).mean(dim=-2)
    mult = _scale_mult_on(window, nperseg, fs, scaling, nfft, pr.device)
    freqs = np.arange(nbins // 2 + 1, dtype=np.float64) * (fs / nbins)
    return freqs, (pr * mult, pi * mult)


def csd(x, y, fs: float = 1.0, window: str | None = "hann", nperseg: int = 256,
        noverlap: int | None = None, detrend: bool | str = True, scaling: str = "density",
        nfft: int | None = None, device=None):
    """Host-convenience cross spectral density; see :func:`csd_device`."""
    freqs, (pr, pi) = csd_device(np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
                                 fs, window, nperseg, noverlap, detrend, scaling, nfft, device=device)
    return freqs, (pr.cpu().numpy(), pi.cpu().numpy())


def coherence_device(x, y, fs: float = 1.0, window: str | None = "hann", nperseg: int = 256,
                     noverlap: int | None = None, device=None):
    """Magnitude-squared coherence Cxy = |Pxy|**2 / (Pxx * Pyy), on the
    tensors' device (``scipy.signal.coherence`` semantics).  One
    segmentation pass per signal feeds all three Welch estimates; their
    scaling cancels, so none is applied."""
    x, y = _pair(x, y, "coherence", device)
    xr, xi = _segment_spectra(x, nperseg, noverlap, window, True, fs, "density", "coherence")
    yr, yi = _segment_spectra(y, nperseg, noverlap, window, True, fs, "density", "coherence")
    pxx = (xr * xr + xi * xi).mean(dim=-2)
    pyy = (yr * yr + yi * yi).mean(dim=-2)
    pr = (xr * yr + xi * yi).mean(dim=-2)
    pi = (xr * yi - xi * yr).mean(dim=-2)
    den = pxx * pyy
    pos = den > 0
    cxy = torch.where(pos, (pr * pr + pi * pi) / torch.where(pos, den, torch.ones_like(den)),
                      torch.zeros_like(den))
    freqs = np.arange(nperseg // 2 + 1, dtype=np.float64) * (fs / nperseg)
    return freqs, cxy


def coherence(x, y, fs: float = 1.0, window: str | None = "hann", nperseg: int = 256,
              noverlap: int | None = None, device=None):
    """Host-convenience magnitude-squared coherence; see :func:`coherence_device`."""
    freqs, c = coherence_device(np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
                                fs, window, nperseg, noverlap, device=device)
    return freqs, c.cpu().numpy()


def periodogram_device(x, fs: float = 1.0, window: str | None = None, detrend: bool | str = True,
                       scaling: str = "density", device=None):
    """Single-segment one-sided periodogram of the WHOLE signal, on the
    tensor's device (``scipy.signal.periodogram`` semantics: boxcar window
    and constant detrend by default): one exact length-n transform
    (``ops/exact.py``, any n), then per-bin power with
    :func:`welch_device`'s one-sided scaling.  Returns ``(freqs, psd)``."""
    from .exact import fft_exact_device

    if scaling not in ("density", "spectrum"):
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    if fs <= 0:
        raise ValueError(f"fs must be positive, got {fs}")
    x = _as_tensor(x, device)
    if x.dim() != 1 or x.shape[0] < 2:
        raise ValueError(f"periodogram expects a 1-D signal of >= 2 samples, got {tuple(x.shape)}")
    n = x.shape[0]
    x = _detrend_rows(x, detrend)
    yr, yi = fft_exact_device(x * window_on(window, n, x.device))
    h = n // 2 + 1
    power = yr[:h] ** 2 + yi[:h] ** 2
    freqs = np.arange(h, dtype=np.float64) * (fs / n)
    return freqs, power * _scale_mult_on(window, n, fs, scaling, None, power.device)


def periodogram(x, fs: float = 1.0, window: str | None = None, detrend: bool | str = True,
                scaling: str = "density", device=None):
    """Host-convenience periodogram; see :func:`periodogram_device`."""
    freqs, p = periodogram_device(np.asarray(x, dtype=np.float32), fs, window, detrend, scaling,
                                  device=device)
    return freqs, p.cpu().numpy()


def lombscargle(x, y, freqs, precenter: bool = False, normalize: bool = False):
    """Lomb-Scargle periodogram of UNEVENLY sampled data
    (``scipy.signal.lombscargle`` semantics, the classic bool interface).

    ``x``: sample times, ``y``: values, ``freqs``: angular frequencies.  The
    Townsend tau-rotated form (scipy's), float64 on the host, chunked over
    frequencies to bound the (M, N) working set.  Host-side by design, as in
    the JAX package: the trig arguments are the raw products ``w*t``, and
    reducing them mod 2*pi in fp32 would cost ~|w*t| * 2^-24 radians of
    phase.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    freqs = np.asarray(freqs, dtype=np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"x and y must have the same length, got {x.shape} vs {y.shape}")
    if x.size == 0 or freqs.size == 0:
        raise ValueError("lombscargle expects non-empty x and freqs")
    if np.any(freqs == 0.0):
        raise ZeroDivisionError("freqs must be nonzero")
    if precenter:
        y = y - y.mean()
    p = np.empty(freqs.shape[0], dtype=np.float64)
    # ~32 MB working set per chunk at f64.
    chunk = max(1, int(4e6 // max(x.size, 1)))
    for s in range(0, freqs.shape[0], chunk):
        w = freqs[s : s + chunk][:, None]
        wt = w * x[None, :]
        c, sn = np.cos(wt), np.sin(wt)
        xc = c @ y
        xs = sn @ y
        cc = np.einsum("ij,ij->i", c, c)
        ss = x.size - cc
        cs = np.einsum("ij,ij->i", c, sn)
        tau = 0.5 * np.arctan2(2.0 * cs, cc - ss)
        ct, st = np.cos(tau), np.sin(tau)
        ycos = xc * ct + xs * st
        ysin = xs * ct - xc * st
        cc_t = cc * ct * ct + 2.0 * cs * st * ct + ss * st * st
        ss_t = ss * ct * ct - 2.0 * cs * st * ct + cc * st * st
        p[s : s + chunk] = 0.5 * (ycos * ycos / cc_t + ysin * ysin / ss_t)
    if normalize:
        p *= 2.0 / np.dot(y, y)
    return p
