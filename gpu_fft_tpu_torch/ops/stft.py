"""Invertible short-time Fourier transform (STFT / ISTFT) on torch devices.

Port of ``gpu_fft_tpu/ops/stft.py``.  ``stft`` returns the complex one-sided
frame spectra; ``istft`` rebuilds the signal by windowed overlap-add divided
by the per-sample window power (WOLA), which is exact (to fp32 rounding) at
every sample the frames cover with nonzero window power, whatever the hop.

Every frame rides one batched device transform: framing is a
``Tensor.unfold`` view, then one ``rfft_device`` over all frames; synthesis
is one ``irfft_device`` over all frames, then ``torch.nn.functional.fold``
(a deterministic overlap-add).  The JAX package builds frames from static
strided slices and places them with dilated pads instead: workarounds for a
TPU, where gathers and scatters run on the scalar core.  Window tables and
the WOLA denominator are made on the host in float64 and cached on the
device per (window, size, device), so a step captured in a CUDA graph
uploads nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .transform import _as_tensor, irfft_device, rfft_device

__all__ = [
    "check_COLA",
    "check_NOLA",
    "closest_STFT_dual_window",
    "frame_signal",
    "istft",
    "istft_device",
    "istft_scipy",
    "overlap_add",
    "stft",
    "stft_device",
    "stft_scipy",
    "window_table",
]


def _symmetric_table(window, m: int) -> np.ndarray:
    """Symmetric window of ``m`` samples, f64 (scipy fftbins=False form) —
    any name/tuple/float :func:`gpu_fft_tpu_torch.ops.windows.get_window`
    accepts."""
    if m <= 1:
        return np.ones(max(m, 0))
    if window == "rect":  # library-local alias kept for the reference API
        return np.ones(m)
    from .windows import get_window

    return np.asarray(get_window(window, m, fftbins=False), dtype=np.float64)


def window_table(window, frame_size: int) -> np.ndarray:
    """Periodic (DFT-even) window of ``frame_size`` samples as f32.

    ``window``: None/"rect", any ``scipy.signal.windows`` family name,
    ``(name, *params)`` tuple, or bare float (kaiser beta) — see
    :mod:`gpu_fft_tpu_torch.ops.windows`.  Accepted by every windowed
    estimator (stft/welch/csd/coherence/periodogram/spectrogram).  The
    periodic form (the symmetric window of frame_size + 1 samples with the
    last dropped — scipy's fftbins=True) is the one for spectral analysis
    and overlap-add.

    >>> window_table("hann", 4).tolist()
    [0.0, 0.5, 1.0, 0.5]
    >>> window_table(None, 3).tolist()
    [1.0, 1.0, 1.0]
    """
    if window is None or window == "rect":
        return np.ones(frame_size, dtype=np.float32)
    if frame_size <= 1:  # degenerate: scipy returns ones
        return np.ones(max(frame_size, 0), dtype=np.float32)
    return _symmetric_table(window, frame_size + 1)[:frame_size].astype(np.float32)


@functools.lru_cache(maxsize=256)
def window_on(window, frame_size: int, device: torch.device) -> torch.Tensor:
    """:func:`window_table` as a tensor on ``device``, made once per
    (window, size, device)."""
    return torch.from_numpy(window_table(window, frame_size)).to(device)


def frame_signal(x, frame_size: int, hop: int, num_frames: int):
    """(..., num_frames, frame_size) overlapping windows of the last axis of
    ``x``: frame m is ``x[..., m*hop : m*hop + frame_size]``.  A view
    (``Tensor.unfold``); nothing is copied until it is windowed."""
    total = (num_frames - 1) * hop + frame_size
    return x[..., :total].unfold(-1, frame_size, hop)


def overlap_add(frames, hop: int, total: int):
    """Sum (..., num_frames, frame_size) rows into length-``total`` signals
    at ``hop`` spacing: out[..., m*hop + t] += frames[..., m, t]; the tail
    past the last frame is zero-padded or trimmed to ``total``."""
    num_frames, frame_size = frames.shape[-2:]
    lead = frames.shape[:-2]
    span = (num_frames - 1) * hop + frame_size
    cols = frames.reshape(-1, num_frames, frame_size).transpose(1, 2)  # (N, frame, num)
    out = F.fold(cols, output_size=(1, span), kernel_size=(1, frame_size), stride=(1, hop))
    out = out.reshape(*lead, span)
    if total <= span:
        return out[..., :total]
    return F.pad(out, (0, total - span))


def _check_framing(frame_size: int, hop: int | None) -> int:
    if frame_size < 2 or frame_size & (frame_size - 1):
        raise ValueError(f"frame_size must be a power of two >= 2, got {frame_size}")
    hop = frame_size // 2 if hop is None else hop
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    return hop


def stft_device(x, frame_size: int, hop: int | None = None, window: str | None = "hann",
                device=None):
    """Complex one-sided STFT on the tensor's device.

    ``x``: (n_samples,) real f32, or (channels, n_samples); ``frame_size``:
    a power of two; ``hop`` defaults to frame_size // 2 (50% overlap).
    Returns split-complex ``(real, imag)`` of shape (num_frames,
    frame_size // 2 + 1), with a leading channel axis for 2-D input; all
    channels ride one batched transform.  Frames that would run past the end
    of the signal are dropped.  Differentiable (the transform's autograd
    seams, ``kernels/large.py``).
    """
    hop = _check_framing(frame_size, hop)
    x = _as_tensor(x, device)
    if x.dim() not in (1, 2):
        raise ValueError(f"stft expects a 1-D signal or (channels, n), got shape {tuple(x.shape)}")
    n = x.shape[-1]
    num_frames = (n - frame_size) // hop + 1
    if num_frames < 1:
        raise ValueError(f"signal of {n} samples is shorter than one {frame_size} frame")
    frames = frame_signal(x, frame_size, hop, num_frames) * window_on(window, frame_size, x.device)
    fr, fi = rfft_device(frames.reshape(-1, frame_size))
    shape = (*x.shape[:-1], num_frames, frame_size // 2 + 1)
    return fr.reshape(shape), fi.reshape(shape)


def istft_device(real, imag, hop: int | None = None, window: str | None = "hann",
                 length: int | None = None, device=None):
    """Inverse STFT by windowed overlap-add, on the tensors' device.

    ``real, imag``: (num_frames, frame_size // 2 + 1) split-complex frame
    spectra, or (channels, num_frames, bins): the output of
    :func:`stft_device` with the same ``hop`` and ``window``.  Each frame is
    weighted by the synthesis window (= the analysis window) and the sum is
    divided by the per-sample window power, so ``istft(stft(x)) == x`` to
    fp32 rounding at every covered sample.  ``length`` trims or zero-pads
    the tail (pass the original signal length).
    """
    real = _as_tensor(real, device)
    imag = _as_tensor(imag, real.device if device is None else device)
    if real.shape != imag.shape or real.dim() not in (2, 3):
        raise ValueError(
            f"istft expects matching (num_frames, bins) or (channels, num_frames, bins) "
            f"arrays, got {tuple(real.shape)} vs {tuple(imag.shape)}"
        )
    h = real.shape[-1]
    frame_size = 2 * (h - 1)
    if h < 2 or frame_size & (frame_size - 1):
        raise ValueError(f"istft: expected frame_size//2 + 1 bins of a power of two, got {h}")
    hop = _check_framing(frame_size, hop)
    frames = irfft_device(real.reshape(-1, h), imag.reshape(-1, h))
    return _wola_frames(frames.reshape(*real.shape[:-1], frame_size), hop, window, length)


@functools.lru_cache(maxsize=64)
def _wola_denominator(window, frame_size: int, hop: int, num_frames: int,
                      device: torch.device) -> torch.Tensor:
    """The accumulated window power of ``num_frames`` frames at ``hop``
    (values under 1e-10 replaced by 1), f64 on the host, f32 on ``device``."""
    w64 = window_table(window, frame_size).astype(np.float64)
    total = (num_frames - 1) * hop + frame_size
    wsq = np.zeros(total, dtype=np.float64)
    for f in range(num_frames):
        wsq[f * hop : f * hop + frame_size] += w64 * w64
    return torch.from_numpy(np.where(wsq > 1e-10, wsq, 1.0).astype(np.float32)).to(device)


def _wola_frames(frames, hop: int, window, length: int | None):
    """Window-weighted overlap-add of (..., num_frames, frame_size)
    TIME-DOMAIN frames with per-sample window-power normalization: the
    synthesis half shared by :func:`istft_device` and :func:`istft_scipy`."""
    num_frames, frame_size = frames.shape[-2:]
    dev = frames.device
    total = (num_frames - 1) * hop + frame_size
    acc = overlap_add(frames * window_on(window, frame_size, dev), hop, total)
    y = acc / _wola_denominator(window, frame_size, hop, num_frames, dev)
    if length is not None:
        y = y[..., :length] if length <= total else F.pad(y, (0, length - total))
    return y


def stft(x, frame_size: int, hop: int | None = None, window: str | None = "hann", device=None):
    """Host-convenience STFT (numpy in and out, run on ``device``); see
    :func:`stft_device`."""
    r, i = stft_device(np.asarray(x, dtype=np.float32), frame_size, hop, window, device=device)
    return r.cpu().numpy(), i.cpu().numpy()


def istft(real, imag, hop: int | None = None, window: str | None = "hann",
          length: int | None = None, device=None):
    """Host-convenience inverse STFT; see :func:`istft_device`."""
    y = istft_device(np.asarray(real, dtype=np.float32), np.asarray(imag, dtype=np.float32),
                     hop, window, length, device=device)
    return y.cpu().numpy()


def stft_scipy(
    x,
    fs: float = 1.0,
    window="hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
    boundary: str | None = "zeros",
    padded: bool = True,
    device=None,
):
    """Drop-in ``scipy.signal.stft``: returns ``(f, t, (Zr, Zi))``.

    scipy conventions: hann window, ``noverlap`` defaults to nperseg // 2,
    the signal is extended by nperseg // 2 zeros on both ends
    (``boundary="zeros"``; None disables) and zero-padded to a whole number
    of frames (``padded``), the frame spectra are scaled by 1 / sum(window)
    ('spectrum' scaling), and ``Zxx`` is oriented (bins, num_frames) like
    scipy's.  ``nfft`` >= nperseg zero-pads each windowed frame for a finer
    bin grid.  One divergence: a signal shorter than ``nperseg`` raises
    (scipy warns and shrinks nperseg, which would break the power-of-two
    contract here).  Inverse: :func:`istft_scipy`.  Split-complex numpy out.
    """
    xv = np.asarray(x, dtype=np.float32)
    if xv.ndim != 1:
        raise ValueError(f"stft_scipy expects a 1-D signal, got shape {xv.shape}")
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    nfft = nperseg if nfft is None else nfft
    if nfft < nperseg or nfft & (nfft - 1):
        raise ValueError(f"nfft must be a power of two >= nperseg, got {nfft}")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    if boundary not in (None, "zeros"):
        raise ValueError(f"boundary must be 'zeros' or None, got {boundary!r}")
    hop = nperseg - noverlap
    half = nperseg // 2
    if xv.shape[0] < nperseg:
        raise ValueError(f"signal of {xv.shape[0]} samples is shorter than one {nperseg} segment")
    ext = np.pad(xv, (half, half)) if boundary == "zeros" else xv
    if padded:
        num = -(-(ext.shape[0] - nperseg) // hop) + 1
        ext = np.pad(ext, (0, (num - 1) * hop + nperseg - ext.shape[0]))
    else:
        num = (ext.shape[0] - nperseg) // hop + 1
    w = window_table(window, nperseg)
    xt = _as_tensor(ext, device)
    frames = frame_signal(xt, nperseg, hop, num) * window_on(window, nperseg, xt.device)
    if nfft > nperseg:
        frames = F.pad(frames, (0, nfft - nperseg))
    zr, zi = rfft_device(frames)
    s = np.float32(1.0 / w.sum())
    freqs = np.arange(nfft // 2 + 1, dtype=np.float64) * (fs / nfft)
    t0 = 0.0 if boundary == "zeros" else half
    times = (t0 + hop * np.arange(num)) / fs
    return freqs, times, (zr.cpu().numpy().T * s, zi.cpu().numpy().T * s)


def istft_scipy(
    zr,
    zi,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    boundary: bool = True,
    device=None,
):
    """Inverse of :func:`stft_scipy` (``scipy.signal.istft`` semantics).

    ``zr, zi``: (bins, num_frames) split-complex spectra (scipy's Zxx
    orientation — the output of :func:`stft_scipy`).  Returns ``(t, x)``.
    Undoes the 1/sum(window) scaling, synthesizes by the WOLA overlap-add
    (window-weighted sum divided by the per-sample window power — scipy's
    formula), and trims the nperseg // 2 boundary extension when
    ``boundary`` is True.
    """
    zr = np.asarray(zr, dtype=np.float32).T  # scipy (bins, frames) -> rows
    zi = np.asarray(zi, dtype=np.float32).T
    if zr.shape != zi.shape or zr.ndim != 2:
        raise ValueError(
            f"istft_scipy expects matching (bins, num_frames) arrays, got {zr.T.shape} vs {zi.T.shape}"
        )
    bins = zr.shape[1]
    nfft = 2 * (bins - 1)
    nperseg = nfft if nperseg is None else nperseg
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    if nperseg > nfft:
        raise ValueError(f"nperseg ({nperseg}) exceeds the {bins}-bin spectra's nfft ({nfft})")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    hop = nperseg - noverlap
    s = np.float32(window_table(window, nperseg).sum())
    num = zr.shape[0]
    full = (num - 1) * hop + nperseg
    if nfft > nperseg:
        # Finer-grid spectra: the nperseg-sample frames are the inverse at
        # nfft, truncated (the forward only zero-padded).
        frames = irfft_device(_as_tensor(zr * s, device), _as_tensor(zi * s, device))[:, :nperseg]
        y = _wola_frames(frames, hop, window, full)
    else:
        y = istft_device(zr * s, zi * s, hop=hop, window=window, length=full, device=device)
    y = y.cpu().numpy()
    half = nperseg // 2
    if boundary:
        y = y[half : full - half]
    times = np.arange(y.shape[0], dtype=np.float64) / fs
    return times, y


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-overlap-add check (``scipy.signal.check_COLA``): the
    hop-shifted window copies must sum to a constant for perfect
    weighted-overlap-add ISTFT reconstruction."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be in [0, nperseg)")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    binsums = sum(win[i * step:(i + 1) * step] for i in range(nperseg // step))
    if nperseg % step != 0:
        binsums[:nperseg % step] += win[-(nperseg % step):]
    return bool(np.max(np.abs(binsums - binsums[0])) < tol)


def _check_window_f64(window, nperseg: int) -> np.ndarray:
    """Full-precision periodic window for the COLA/NOLA gates (the f32
    window_table would alias its own rounding into the tolerance)."""
    if isinstance(window, (str, tuple)) or window is None:
        if window is None or window == "rect":
            return np.ones(nperseg)
        return _symmetric_table(window, nperseg + 1)[:nperseg]
    win = np.asarray(window, dtype=np.float64)
    if win.shape != (nperseg,):
        raise ValueError("window must have length nperseg")
    return win


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add check (``scipy.signal.check_NOLA``): the sum of
    SQUARED shifted windows must be bounded away from zero everywhere —
    the weaker invertibility condition the ISTFT normalization needs."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be in [0, nperseg)")
    win = _check_window_f64(window, nperseg)
    step = nperseg - noverlap
    w2 = win * win
    binsums = sum(w2[i * step:(i + 1) * step] for i in range(nperseg // step))
    if nperseg % step != 0:
        binsums[:nperseg % step] += w2[-(nperseg % step):]
    return bool(np.min(binsums) > tol * np.max(w2))


def _dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical WOLA dual: win / (per-position sum of |win|^2 over all
    hop-shifted copies); raises when the frame is not invertible."""
    w2 = win.real ** 2 + win.imag ** 2
    dd = w2.copy()
    for k in range(hop, win.size, hop):
        dd[k:] += w2[:-k]
        dd[:-k] += w2[k:]
    if not np.all(dd >= np.finfo(np.float64).resolution * dd.max()):
        raise ValueError("short-time Fourier transform not invertible for this "
                         "window/hop (zero frame-overlap energy somewhere)")
    return win / dd


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *, scaled: bool = True):
    """Dual STFT window closest to a desired one
    (``scipy.signal.closest_STFT_dual_window``): the canonical dual plus
    the component of (desired − projection) in the dual space; with
    ``scaled`` the optimal scale factor alpha is solved for and returned."""
    win = np.asarray(win)
    desired_dual = np.ones_like(win) if desired_dual is None else np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired_dual.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D arrays")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired_dual))):
        raise ValueError("win and desired_dual must be finite")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= win.size):
        raise ValueError(f"hop must be an integer in [1, {win.size}], got {hop!r}")
    w_d = _dual_canonical_window(win.astype(np.result_type(win.dtype, np.float64)), hop)
    wdd = np.conj(win) * desired_dual
    q_d = wdd.copy()
    for k in range(hop, win.size, hop):
        q_d[k:] += wdd[:-k]
        q_d[:-k] += wdd[k:]
    q_d = w_d * q_d
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numerator = np.conj(q_d) @ w_d
    denominator = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(numerator) > 0 and denominator > np.finfo(np.float64).resolution):
        raise ValueError("scaled dual window numerically unstable; use scaled=False")
    alpha = numerator / denominator
    return w_d + alpha * (desired_dual - q_d), alpha
