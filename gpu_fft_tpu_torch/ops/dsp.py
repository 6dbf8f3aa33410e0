"""DSP ops built on the transforms: convolution, correlation, the analytic
signal, Fourier resampling, shifts and the small host helpers.

Port of ``gpu_fft_tpu/ops/dsp.py``.  Every transform here is the library's
own: ``kernels/large.py:transform_any`` / ``inverse_real`` for power-of-two
lengths (on ``plan.route``'s engine) and the exact transforms of
``ops/exact.py`` for any other length.  The host API takes numpy and returns
numpy and runs on ``device`` (default ``"cuda"``);
``*_device`` functions take and return tensors on the tensor's device.

``hilbert2`` and ``envelope_scipy`` are numpy host code on the complex
``compat`` namespace, run on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MAX_N, resolve_device
from ..utils.signal import fftfreq, rfftfreq
from .transform import _as_tensor, _upload, fft, next_power_of_two

__all__ = [
    "correlation_lags",
    "deconvolve",
    "detrend",
    "envelope",
    "envelope_device",
    "envelope_scipy",
    "fft_convolve",
    "fft_convolve_device",
    "fft_correlate",
    "fftfreq",
    "fftshift",
    "gauss_spline",
    "hfft",
    "hilbert",
    "hilbert2",
    "hilbert_device",
    "ifftshift",
    "ihfft",
    "next_fast_len",
    "prev_fast_len",
    "resample",
    "resample_device",
    "rfftfreq",
    "vectorstrength",
]


def _conv_length(lfull: int, name: str) -> int:
    """The power-of-two transform length of a full linear convolution."""
    m = max(2, next_power_of_two(lfull))
    if m > MAX_N:
        raise ValueError(
            f"{name}: combined length {lfull} needs a {m}-point transform, "
            f"beyond the supported maximum {MAX_N}"
        )
    return m


def _pair_rows(a, b, name: str):
    """(Ba, la), (Bb, lb) rows from 1-D or 2-D operands whose batches are
    equal or one of them 1 (that row then serves the whole batch: its
    spectrum is computed once and broadcast)."""
    if a.dim() == 1:
        a = a[None]
    if b.dim() == 1:
        b = b[None]
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name} expects 1-D or (B, l) inputs, got {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] and 1 not in (a.shape[0], b.shape[0]):
        raise ValueError(f"{name}: batch sizes differ: {a.shape[0]} vs {b.shape[0]}")
    if a.shape[1] == 0 or b.shape[1] == 0:
        raise ValueError(f"{name} expects non-empty signals")
    return a, b


def _spectral_product(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def fft_convolve_device(a, b, device=None):
    """Full linear convolution of batched real rows, on the tensors' device.

    ``a``: (B, la) and ``b``: (B, lb) f32; a 1-D (or one-row) operand is
    broadcast across the other's batch.  Returns the (B, la + lb - 1) full
    convolution, 1-D when BOTH inputs were 1-D.  Two forward transforms at
    the padded length m = next_pow2(la + lb - 1), a broadcast operand's at
    B = 1, and the real-output inverse (1/m in its tables).
    """
    from ..kernels.large import inverse_real, transform_any

    a = _as_tensor(a, device)
    b = _as_tensor(b, a.device)
    squeeze = a.dim() == 1 and b.dim() == 1
    a, b = _pair_rows(a, b, "fft_convolve_device")
    la, lb = a.shape[1], b.shape[1]
    lfull = la + lb - 1
    m = _conv_length(lfull, "fft_convolve_device")
    ar, ai = transform_any(F.pad(a, (0, m - la)), None, m, -1)
    br, bi = transform_any(F.pad(b, (0, m - lb)), None, m, -1)
    yr = inverse_real(*_spectral_product(ar, ai, br, bi), m, scale=1.0 / m)
    out = yr[:, :lfull]
    return out[0] if squeeze else out


def fft_convolve(a, b, mode: str = "full", device=None):
    """Linear convolution of two real 1-D signals via the pow2 FFT path.

    ``mode``: "full" (len la+lb-1, default), "same" (len max(la, lb),
    centered) or "valid" (len la-lb+1; requires la >= lb): ``numpy.convolve``
    up to f32 rounding.  Both signals ride ONE batched forward transform.

    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], device="cpu").round(5).tolist()
    [1.0, 3.0, 5.0, 3.0]
    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], mode="same", device="cpu").round(5).tolist()
    [1.0, 3.0, 5.0]
    >>> fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], mode="valid", device="cpu").round(5).tolist()
    [3.0, 5.0]
    """
    from ..kernels.large import inverse_real, transform_any

    av = np.asarray(a, dtype=np.float32)
    bv = np.asarray(b, dtype=np.float32)
    if av.ndim != 1 or bv.ndim != 1 or av.size == 0 or bv.size == 0:
        raise ValueError("fft_convolve expects two non-empty 1-D signals")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    la, lb = av.shape[0], bv.shape[0]
    if mode == "valid" and la < lb:
        raise ValueError("valid mode requires len(a) >= len(b)")
    lfull = la + lb - 1
    m = _conv_length(lfull, "fft_convolve")
    pair = np.zeros((2, m), dtype=np.float32)
    pair[0, :la] = av
    pair[1, :lb] = bv
    fr, fi = transform_any(_upload(pair, resolve_device(device)), None, m, -1)
    cr, ci = _spectral_product(fr[0:1], fi[0:1], fr[1:2], fi[1:2])
    full = inverse_real(cr, ci, m, scale=1.0 / m)[0, :lfull].cpu().numpy()
    if mode == "full":
        return full
    if mode == "same":
        # numpy.convolve 'same': length max(la, lb), centered on 'full'.
        start = (min(la, lb) - 1) // 2
        return full[start : start + max(la, lb)].copy()
    return full[lb - 1 : la].copy()


def fft_correlate(a, b, mode: str = "full", device=None):
    """Cross-correlation of two real 1-D signals via the FFT path.

    ``numpy.correlate(a, b, mode)`` up to f32 rounding: convolution with the
    reversed ``b``, through :func:`fft_convolve`.

    >>> fft_correlate([1.0, 2.0, 3.0], [0.0, 1.0, 0.5], device="cpu").round(5).tolist()
    [0.5, 2.0, 3.5, 3.0, 0.0]
    >>> fft_correlate([1.0, 2.0, 3.0], [1.0, 2.0, 3.0], mode="valid", device="cpu").round(4).tolist()
    [14.0]
    """
    bv = np.asarray(b, dtype=np.float32)
    if bv.ndim != 1 or bv.size == 0:
        raise ValueError("fft_correlate expects two non-empty 1-D signals")
    if mode == "valid":
        # numpy.correlate 'valid' allows either operand to be the longer one.
        av = np.asarray(a, dtype=np.float32)
        if av.ndim != 1 or av.size == 0:
            raise ValueError("fft_correlate expects two non-empty 1-D signals")
        if av.shape[0] < bv.shape[0]:
            # correlate(a, b, 'valid') == correlate(b, a, 'valid')[::-1]
            return fft_correlate(bv, av, "valid", device=device)[::-1].copy()
    return fft_convolve(a, bv[::-1].copy(), mode=mode, device=device)


def _rows(x, device, name: str):
    """(B, n) f32 rows of a non-empty 1-D or 2-D input, and whether it was 1-D."""
    x = _as_tensor(x, device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or x.shape[-1] < 1:
        raise ValueError(f"{name} expects non-empty 1-D or (B, n) input, got {tuple(x.shape)}")
    return x, squeeze


def _analytic_gain(n: int) -> np.ndarray:
    """Analytic-signal spectrum gain: 1 at DC (and Nyquist for even n), 2 on
    positive frequencies, 0 on negative frequencies."""
    h = np.zeros(n, dtype=np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    return h


def hilbert_device(x, device=None):
    """Analytic signal of real rows via the exact FFT, on the tensor's device.

    ``x``: (n,) or (B, n) real f32, ANY length n >= 1.  Returns split-complex
    ``(real, imag)``: real == x (up to rounding), imag the Hilbert transform
    (``scipy.signal.hilbert`` semantics).
    """
    from ..plan import on_device
    from .exact import fft_exact_device, ifft_exact_device

    x, squeeze = _rows(x, device, "hilbert")
    n = x.shape[-1]
    yr, yi = fft_exact_device(x)
    h = on_device(_analytic_gain, n, device=x.device)
    ar, ai = ifft_exact_device(yr * h, yi * h)
    return (ar[0], ai[0]) if squeeze else (ar, ai)


def hilbert(x, device=None):
    """Host-convenience analytic signal; see :func:`hilbert_device`.
    Returns ``(real, imag)`` numpy arrays, imag the Hilbert transform."""
    ar, ai = hilbert_device(np.asarray(x, dtype=np.float32), device=device)
    return ar.cpu().numpy(), ai.cpu().numpy()


def envelope(x, device=None):
    """Instantaneous amplitude |analytic signal| of a real signal: for
    ``x(t) = a(t) cos(w t)`` with a slowly varying amplitude, ``a(t)``."""
    ar, ai = hilbert(x, device=device)
    return np.sqrt(ar * ar + ai * ai)


def envelope_device(x, device=None):
    """Amplitude envelope on the tensor's device; see :func:`envelope`."""
    ar, ai = hilbert_device(x, device=device)
    return torch.hypot(ar, ai)


def resample_device(x, num: int, device=None):
    """Fourier-domain resampling of real rows to ``num`` samples.

    ``x``: (n,) or (B, n) real f32, any length.  The exact length-n spectrum
    is truncated (down) or zero-padded (up) symmetrically, with the Nyquist
    bin split or merged, and inverted at length num:
    ``scipy.signal.resample`` semantics for real input (a periodic signal).
    A power-of-two ``num`` takes the real-output inverse
    (``inverse_real``, scale 1/n); any other the exact inverse (1/num)
    times num/n.
    """
    from .exact import fft_exact_device, ifft_exact_device

    x, squeeze = _rows(x, device, "resample")
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    n = x.shape[-1]
    yr, yi = fft_exact_device(x)
    b = yr.shape[0]
    m = min(n, num)
    nyq = m // 2 + 1  # non-negative frequencies that survive
    neg = m - nyq  # negative bins that survive
    head_r, head_i = yr[:, :nyq], yi[:, :nyq]
    if m % 2 == 0:
        sh = m // 2  # the shared Nyquist bin = the last head column
        if num < n:
            # Down: the old +num/2 and -num/2 bins alias onto the new Nyquist bin.
            head_r = torch.cat([head_r[:, :sh], (head_r[:, sh] + yr[:, n - sh])[:, None]], dim=1)
            head_i = torch.cat([head_i[:, :sh], (head_i[:, sh] + yi[:, n - sh])[:, None]], dim=1)
        elif num > n:
            # Up: the old Nyquist splits across two half-bins (the mirror
            # half-bin lands at the end of the zero gap below).
            head_r = torch.cat([head_r[:, :sh], head_r[:, sh:] * 0.5], dim=1)
            head_i = torch.cat([head_i[:, :sh], head_i[:, sh:] * 0.5], dim=1)
    parts_r, parts_i = [head_r], [head_i]
    gap = num - nyq - neg
    if gap > 0:
        split = num > n and m % 2 == 0
        zeros = yr.new_zeros(b, gap - (1 if split else 0))
        parts_r.append(zeros)
        parts_i.append(zeros)
        if split:
            sh = m // 2
            parts_r.append((yr[:, sh] * 0.5)[:, None])
            parts_i.append((yi[:, sh] * 0.5)[:, None])
    if neg > 0:
        parts_r.append(yr[:, n - neg :])
        parts_i.append(yi[:, n - neg :])
    zr = torch.cat(parts_r, dim=1)
    zi = torch.cat(parts_i, dim=1)
    if num >= 2 and num & (num - 1) == 0:
        from ..kernels.large import inverse_real

        out = inverse_real(zr, zi, num, scale=1.0 / n)
        return out[0] if squeeze else out
    rr, _ = ifft_exact_device(zr, zi)
    out = rr * float(np.float32(num / n))
    return out[0] if squeeze else out


def resample(x, num: int, device=None):
    """Host-convenience Fourier resampling; see :func:`resample_device`."""
    return resample_device(np.asarray(x, dtype=np.float32), num, device=device).cpu().numpy()


def _shift_dims(x, axes):
    if axes is None:
        return tuple(range(x.dim()))
    return (axes,) if isinstance(axes, int) else tuple(axes)


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the center (``numpy.fft.fftshift``).
    A tensor stays on its device (a roll); anything else goes through numpy.

    >>> fftshift(np.array([0.0, 1.0, 2.0, 3.0])).tolist()
    [2.0, 3.0, 0.0, 1.0]
    """
    if isinstance(x, torch.Tensor):
        dims = _shift_dims(x, axes)
        return torch.roll(x, [x.shape[d] // 2 for d in dims], dims)
    return np.fft.fftshift(np.asarray(x), axes=axes)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift`.

    >>> ifftshift(fftshift(np.array([0.0, 1.0, 2.0, 3.0, 4.0]))).tolist()
    [0.0, 1.0, 2.0, 3.0, 4.0]
    """
    if isinstance(x, torch.Tensor):
        dims = _shift_dims(x, axes)
        return torch.roll(x, [-(x.shape[d] // 2) for d in dims], dims)
    return np.fft.ifftshift(np.asarray(x), axes=axes)


def next_fast_len(target: int, real: bool = False):
    """Smallest transform length >= target on the library's fast path: the
    next power of two (every transform here pads to one), unlike
    ``scipy.fft.next_fast_len``'s 5-smooth rule.  ``real`` is accepted for
    scipy signature compatibility.

    >>> next_fast_len(1000)
    1024
    >>> next_fast_len(1024)
    1024
    """
    if target < 1:
        raise ValueError(f"next_fast_len requires target >= 1, got {target}")
    return max(2, next_power_of_two(target))


def prev_fast_len(target: int, real: bool = False):
    """Largest power of two <= target (``scipy.fft.prev_fast_len``'s
    signature, the dual of :func:`next_fast_len`).

    >>> prev_fast_len(1000)
    512
    >>> prev_fast_len(1024)
    1024
    """
    if target < 2:
        raise ValueError(f"prev_fast_len requires target >= 2, got {target}")
    return 1 << (int(target).bit_length() - 1)


def hfft(input_real, input_imag, device=None):
    """FFT of a signal with Hermitian symmetry, a real spectrum
    (``numpy.fft.hfft`` with n = 2*(len(input) - 1)): hfft(a) ==
    irfft(conj(a)) * n, through the real-output inverse unnormalized."""
    from ..kernels.large import inverse_real

    xr = np.asarray(input_real, dtype=np.float32)
    xi = np.asarray(input_imag, dtype=np.float32)
    if xr.shape != xi.shape or xr.ndim != 1:
        raise ValueError(f"hfft: real and imag must be equal-length 1-D arrays, got {xr.shape} vs {xi.shape}")
    h = xr.shape[0]
    n = 2 * (h - 1)
    if h < 2 or n & (n - 1):
        raise ValueError(f"hfft: expected n//2 + 1 samples of a power-of-two n, got {h}")
    full_r = np.concatenate([xr, xr[1:-1][::-1]])
    full_i = np.concatenate([-xi, xi[1:-1][::-1]])  # conj, Hermitian-extended
    full_i[0] = 0.0
    full_i[h - 1] = 0.0
    dev = resolve_device(device)
    return inverse_real(_upload(full_r[None], dev), _upload(full_i[None], dev), n)[0].cpu().numpy()


def ihfft(input, device=None):
    """Inverse of :func:`hfft`: a real spectrum to the h = n//2 + 1 unique
    samples of the Hermitian time signal (``numpy.fft.ihfft``: the conjugate
    of the forward rfft over n)."""
    x = np.asarray(input, dtype=np.float32)
    if x.ndim != 1 or x.size < 2:
        raise ValueError(f"ihfft expects a 1-D real spectrum of length >= 2, got {x.shape}")
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"ihfft: length {n} is not a power of two")
    re, im = fft(x, device=device)
    h = n // 2 + 1
    s = np.float32(1.0 / n)
    return re[:h] * s, -im[:h] * s


def detrend(data, axis: int = -1, type: str = "linear", bp=0, overwrite_data: bool = False):
    """Remove a constant or piecewise-linear trend (``scipy.signal.detrend``);
    ``bp`` gives breakpoints of independently fit linear segments.  Host
    numpy: a data-preparation step."""
    data = np.asarray(data)
    if type not in ("linear", "l", "constant", "c"):
        raise ValueError("type must be 'linear' or 'constant'")
    res_dtype = np.float64 if data.dtype.kind in "iub" else data.dtype
    if type in ("constant", "c"):
        return data - np.mean(data, axis, keepdims=True)
    x = np.moveaxis(data.astype(res_dtype, copy=not overwrite_data), axis, 0)
    n = x.shape[0]
    bp = np.sort(np.unique(np.concatenate([[0], np.atleast_1d(bp), [n]])))
    if np.any(bp > n):
        raise ValueError("breakpoints must not exceed the axis length")
    flat = x.reshape(n, -1)
    for lo, hi in zip(bp[:-1], bp[1:]):
        m = int(hi - lo)
        if m == 0:
            continue
        t = np.arange(m, dtype=res_dtype)
        basis = np.stack([t / max(m, 1), np.ones(m, dtype=res_dtype)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, flat[lo:hi], rcond=None)
        flat[lo:hi] -= basis @ coef
    return np.moveaxis(flat.reshape(x.shape), 0, axis)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full") -> np.ndarray:
    """Lag indices matching ``fft_correlate(in1, in2, mode)``
    (``scipy.signal.correlation_lags``)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        lo = lags.size // 2 - in1_len // 2
        return lags[lo:lo + in1_len]
    if mode == "valid":
        if in1_len >= in2_len:
            return np.arange(in1_len - in2_len + 1)
        return np.arange(in1_len - in2_len, 1)
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")


def vectorstrength(events, period):
    """Phase-locking strength of events to a period
    (``scipy.signal.vectorstrength``): resultant length and angle of the
    unit phasors exp(j 2 pi event / period)."""
    events = np.asarray(events, dtype=np.float64)
    period = np.asarray(period, dtype=np.float64)
    scalar = period.ndim == 0
    period = np.atleast_1d(period)
    if events.ndim != 1:
        raise ValueError("events must be 1-D")
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    ang = 2.0 * np.pi * events[:, None] / period[None, :]
    vec = np.exp(1j * ang).mean(axis=0)
    strength, phase = np.abs(vec), np.angle(vec)
    return (float(strength[0]), float(phase[0])) if scalar else (strength, phase)


def deconvolve(signal, divisor):
    """Polynomial deconvolution (``scipy.signal.deconvolve``): quotient and
    remainder with ``signal = convolve(divisor, quotient) + remainder``."""
    num = np.atleast_1d(np.asarray(signal, dtype=np.float64))
    den = np.atleast_1d(np.asarray(divisor, dtype=np.float64))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("signal and divisor must be 1-D")
    if den[0] == 0:
        raise ValueError("divisor must have a nonzero leading coefficient")
    n = num.size - den.size + 1
    if n <= 0:
        return np.zeros(1), num.copy()
    quot = np.empty(n, dtype=np.float64)
    rem = num.copy()
    for i in range(n):  # long division; n is a filter order
        q = rem[i] / den[0]
        quot[i] = q
        rem[i:i + den.size] -= q * den
    return quot, rem


def hilbert2(x, N=None, axes=(-2, -1), device=None):
    """2-D analytic signal (``scipy.signal.hilbert2``): single-orthant
    spectrum — per axis, keep bin 0, double bins 1..(n+1)//2-1, zero the
    rest (scipy >= 1.17 semantics: even-n Nyquist is zeroed) — the
    separable product of two 1-D analytic-signal steps on ``compat.fft2``,
    run on ``device``."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        raise ValueError("hilbert2 needs a real input")
    if x.ndim < 2:
        raise ValueError("hilbert2 needs an at-least-2-D input")
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError("axes must be two distinct axes")
    x = np.moveaxis(x.astype(np.float64), axes, (-2, -1))
    if N is None:
        N = x.shape[-2:]
    elif np.isscalar(N):
        N = (int(N), int(N))
    if len(N) != 2 or any(n <= 0 for n in N):
        raise ValueError("N must be two positive lengths")
    from .. import compat

    Xf = compat.fft2(x, s=tuple(N), device=device)
    h = []
    for n in N:
        h1 = np.zeros(n)
        h1[0] = 1.0
        h1[1:(n + 1) // 2] = 2.0
        h.append(h1)
    out = compat.ifft2(Xf * np.outer(h[0], h[1]), device=device)
    return np.moveaxis(out, (-2, -1), axes)


def gauss_spline(x, n: int):
    """Gaussian approximation of the order-n B-spline
    (``scipy.signal.gauss_spline``): variance (n+1)/12."""
    x = np.asarray(x, dtype=np.float64)
    sig2 = (n + 1) / 12.0
    return np.exp(-x * x / (2.0 * sig2)) / np.sqrt(2.0 * np.pi * sig2)


def envelope_scipy(z, bp_in=(1, None), *, n_out=None, squared=False,
                   residual="lowpass", axis=-1, device=None):
    """Band-limited envelope + residual (``scipy.signal.envelope``,
    scipy >= 1.16): the envelope is |baseband| of the bp_in-band analytic
    signal; the residual is the out-of-band remainder ('lowpass' keeps
    only the below-band part, 'all' keeps everything outside the band).
    Rides the ``compat`` transforms on the last axis, on ``device``."""
    from .. import compat

    z = np.asarray(z)
    if not -z.ndim <= axis < z.ndim:
        raise ValueError(f"invalid axis {axis} for shape {z.shape}")
    if z.shape[axis] == 0:
        raise ValueError("z must be non-empty along axis")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, (int, np.integer))
                                  for b in bp_in):
        raise ValueError("bp_in must be a 2-tuple of int | None")
    if n_out is not None and (not isinstance(n_out, (int, np.integer)) or n_out <= 0):
        raise ValueError("n_out must be a positive int or None")
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all' or None")
    n = z.shape[axis]
    n_out = n if n_out is None else int(n_out)
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not -(n // 2) <= lo < hi <= (n + 1) // 2:
        raise ValueError(f"bp_in {bp_in} out of range for n={n}")
    z = np.moveaxis(z, axis, -1)
    complex_in = np.iscomplexobj(z)
    if complex_in:
        Z = compat.fft(z, device=device)  # a fresh array — masked in place below
    else:
        Z = np.zeros(z.shape, dtype=complex)
        Z[..., : n // 2 + 1] = compat.rfft(z, device=device)
        if lo > 0:  # analytic within the band
            Z[..., lo:hi] *= 2
        elif hi > 0:
            Z[..., 1:hi] *= 2
    if not lo <= 0 < hi:
        z_bb = compat.ifft(Z[..., lo:hi], n=n_out, device=device) * fak
    else:
        Zs = np.fft.fftshift(Z, axes=-1)
        z_bb = compat.ifft(Zs[..., lo + n // 2 : hi + n // 2], n=n_out, device=device) * fak
    env = np.abs(z_bb) if not squared else z_bb.real ** 2 + z_bb.imag ** 2
    env = np.moveaxis(env, -1, axis)
    if residual is None:
        return env
    if not lo <= 0 < hi:
        Z[..., lo:hi] = 0
    else:
        Z[..., :hi] = 0
        Z[..., lo:] = 0
    if residual == "lowpass":
        if hi > 0:
            Z[..., hi : (n + 1) // 2] = 0
        else:
            Z[..., lo:] = 0
            Z[..., : (n + 1) // 2] = 0
    if complex_in:
        if n_out == n:
            z_res = compat.ifft(Z, device=device)
        else:
            # spectral resampling: move bins to the new grid, halving /
            # doubling the unpaired Nyquist-like bin as scipy's
            # resample(domain='freq') does
            m = min(n, n_out)
            Zr = np.zeros(z.shape[:-1] + (n_out,), dtype=complex)
            up = m // 2 + 1
            Zr[..., :up] = Z[..., :up]
            Zr[..., -(m - up):] = Z[..., -(m - up):] if m > up else 0
            if m % 2 == 0:
                if n_out < n:
                    Zr[..., m // 2] += Z[..., -(m // 2)]
                else:
                    Zr[..., m // 2] *= 0.5
                    Zr[..., -(m // 2)] = Zr[..., m // 2]
            z_res = compat.ifft(Zr, device=device) * fak
    else:
        if n_out != n and (m := min(n, n_out)) % 2 == 0:
            Z[..., m // 2] *= 2 if n_out < n else 0.5
        z_res = fak * compat.irfft(Z[..., : n // 2 + 1], n=n_out, device=device)
    return np.stack((env, np.moveaxis(z_res, -1, axis)), axis=0)
