"""scipy.signal-flavored namespace: complex outputs, scipy names.

Port of ``gpu_fft_tpu/signal/__init__.py``.  The native API returns
split-complex ``(re, im)`` pairs and uses a few library-local names
(``fft_convolve``, ``stft_scipy``).  This module maps the same
implementations onto the ``scipy.signal`` surface — scipy's function NAMES
and complex-valued returns — so signal-processing code moves over with one
import change::

    import gpu_fft_tpu_torch.signal as signal   # instead of scipy.signal
    f, Pxy = signal.csd(x, y, fs=1e3)           # complex Pxy, like scipy
    analytic = signal.hilbert(x)                # complex analytic signal

Host convenience layer: numpy in, numpy out (complex where scipy returns
complex), computed on ``device`` (default ``"cuda"``, or
``GPU_FFT_TPU_TORCH_DEVICE``).  For device-resident split-complex pipelines
use the native ops (``gpu_fft_tpu_torch.welch_device`` etc.).  The complex
wrappers take a keyword ``device`` after scipy's arguments.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.czt import czt as _czt_split, zoom_fft as _zoom_split
from ..ops.dsp import fft_convolve as fftconvolve, fft_correlate, hilbert as _hilbert_split, resample
from ..ops.filter import (
    FIRStream,
    filtfilt_fir,
    firwin,
    firwin2,
    kaiser_atten,
    kaiser_beta,
    kaiserord,
    minimum_phase,
    oaconvolve,
    savgol_coeffs,
    savgol_filter,
)
from ..ops.design import (
    bessel,
    besselap,
    bilinear_zpk,
    buttap,
    cheb1ap,
    cheb2ap,
    ellipap,
    findfreqs,
    freqs,
    freqs_zpk,
    iirdesign,
    lp2bp,
    lp2bp_zpk,
    lp2bs,
    lp2bs_zpk,
    lp2hp,
    lp2hp_zpk,
    lp2lp,
    lp2lp_zpk,
    bilinear,
    butter,
    buttord,
    cheb1ord,
    cheb2ord,
    cheby1,
    cheby2,
    ellip,
    ellipord,
    iircomb,
    iirfilter,
    iirnotch,
    iirpeak,
    normalize,
    sos2tf,
    sos2zpk,
    tf2sos,
    tf2zpk,
    zpk2sos,
    zpk2tf,
)
from ..ops.czt import czt_points
from ..ops.filter import group_delay
from ..ops.iir import filtfilt, lfilter, lfiltic, lfilter_zi, sosfilt, sosfilt_zi, sosfiltfilt
from ..ops.multirate import decimate, resample_poly, upfirdn
from ..ops.lti import (
    lti,
    dlti,
    TransferFunction,
    ZerosPolesGain,
    StateSpace,
    lsim,
    impulse,
    step,
    freqresp,
    bode,
    dlsim,
    dimpulse,
    dstep,
    dfreqresp,
    dbode,
    cont2discrete,
    tf2ss,
    ss2tf,
    zpk2ss,
    ss2zpk,
    abcd_normalize,
    place_poles,
    residue,
    residuez,
    invres,
    invresz,
    unique_roots,
)
from ..ops.peaks import (
    argrelextrema,
    argrelmax,
    argrelmin,
    find_peaks,
    find_peaks_cwt,
    peak_prominences,
    peak_widths,
)
from ..ops.spectral import (
    coherence,
    csd as _csd_split,
    lombscargle,
    periodogram,
    spectrogram_scipy as spectrogram,
    welch,
)
from ..ops.dsp import (
    correlation_lags,
    deconvolve,
    detrend,
    envelope_scipy as envelope,
    gauss_spline,
    hilbert2,
    vectorstrength,
)
from ..ops.fir_optimal import firls, gammatone, remez
from ..ops.rank import medfilt, medfilt2d, order_filter, wiener
from ..ops.filter import choose_conv_method, convolve2d, correlate2d, firwin_2d
from ..ops.design import BadCoefficients, band_stop_obj
from ..ops.splines import (
    cspline1d,
    cspline1d_eval,
    cspline2d,
    qspline1d,
    qspline1d_eval,
    qspline2d,
    sepfir2d,
    spline_filter,
    symiirorder1,
    symiirorder2,
)
from ..ops.czt import CZT, ZoomFFT
from ..ops.stft import check_COLA, check_NOLA, closest_STFT_dual_window
from ..utils.signal import chirp, gausspulse, max_len_seq, sawtooth, square, sweep_poly, unit_impulse
from ..ops.short_time_fft import ShortTimeFFT
from ..ops.stft import istft_scipy as _istft_split, stft_scipy as _stft_split, window_table
from . import windows

__all__ = [
    "fftconvolve", "oaconvolve", "correlate", "convolve",
    "hilbert", "resample", "resample_poly", "upfirdn", "decimate",
    "welch", "csd", "coherence", "periodogram", "spectrogram",
    "stft", "istft", "czt", "zoom_fft", "ShortTimeFFT",
    "firwin", "firwin2", "kaiserord", "kaiser_beta", "kaiser_atten",
    "minimum_phase", "filtfilt_fir", "FIRStream", "get_window",
    "find_peaks", "peak_prominences", "peak_widths", "chirp",
    "argrelextrema", "argrelmax", "argrelmin",
    "detrend", "correlation_lags", "vectorstrength", "deconvolve", "lfiltic",
    "square", "sawtooth", "gausspulse", "sweep_poly", "unit_impulse", "max_len_seq",
    "convolve2d", "correlate2d", "choose_conv_method", "medfilt", "medfilt2d", "order_filter", "wiener", "hilbert2", "gauss_spline", "check_COLA", "check_NOLA", "CZT", "ZoomFFT", "firls", "remez", "gammatone",
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace", "lsim", "impulse", "step", "freqresp", "bode", "dlsim", "dimpulse", "dstep", "dfreqresp", "dbode", "cont2discrete", "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize", "place_poles", "residue", "residuez", "invres", "invresz", "unique_roots",
    "savgol_coeffs", "savgol_filter", "freqz", "lombscargle",
    "lfilter", "lfilter_zi", "filtfilt", "sosfilt", "sosfilt_zi", "sosfiltfilt",
    "butter", "cheby1", "cheby2", "iirfilter", "iirnotch", "iirpeak",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "bilinear", "zpk2tf", "zpk2sos",
    "ellip", "bessel", "iircomb",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap", "lp2lp", "lp2hp", "lp2bp", "lp2bs", "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk", "bilinear_zpk", "findfreqs", "freqs", "freqs_zpk", "iirdesign",
    "tf2zpk", "tf2sos", "sos2tf", "sos2zpk", "normalize",
    "group_delay", "sosfreqz", "freqz_sos", "freqz_zpk", "czt_points",
    "find_peaks_cwt", "envelope", "firwin_2d", "band_stop_obj",
    "BadCoefficients", "closest_STFT_dual_window", "windows",
    "cspline1d", "cspline1d_eval", "cspline2d", "qspline1d", "qspline1d_eval",
    "qspline2d", "sepfir2d", "spline_filter", "symiirorder1", "symiirorder2",
]


def _pack(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _complex_arg(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_complex()
    return isinstance(v, (np.ndarray, list, tuple)) and np.iscomplexobj(v)


def _real_only(name: str, fn):
    """``fn`` (``signal.<name>``) raising TypeError for a complex numpy array or tensor among its
    arguments, before any work: the port computes these on real signals
    (float32) and would otherwise drop the imaginary part with no more than
    numpy's ComplexWarning.  A recorded divergence: the JAX package returns
    the real part's answer (ROADMAP.md, section 3)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if any(_complex_arg(v) for v in (*args, *kwargs.values())):
            raise TypeError(f"signal.{name}: complex input is not supported; the port computes it on real "
                            f"signals only")
        return fn(*args, **kwargs)

    return wrapper


#: The functions that take a real signal and lost a complex one's imaginary
#: part; each raises TypeError for complex input now.
_REAL_ONLY = ("lfilter", "sosfilt", "filtfilt", "fftconvolve", "oaconvolve", "correlate", "upfirdn", "resample",
             "resample_poly", "decimate", "welch", "csd", "periodogram", "spectrogram", "stft")


def convolve(in1, in2, mode: str = "full", method: str = "auto", device=None):
    """``scipy.signal.convolve`` with the FFT method (the only one here —
    this is an FFT library); ``method`` must be 'auto' or 'fft'."""
    if method not in ("auto", "fft"):
        raise ValueError(f"convolve supports method='auto'|'fft', got {method!r}")
    return fftconvolve(in1, in2, mode=mode, device=device)


def correlate(in1, in2, mode: str = "full", method: str = "auto", device=None):
    """``scipy.signal.correlate`` (FFT method) for real inputs."""
    if method not in ("auto", "fft"):
        raise ValueError(f"correlate supports method='auto'|'fft', got {method!r}")
    return fft_correlate(in1, in2, mode=mode, device=device)


def hilbert(x, N: int | None = None, device=None):
    """Complex analytic signal — ``scipy.signal.hilbert`` (N pads/crops)."""
    x = np.asarray(x, dtype=np.float32)
    if N is not None:
        if N < 1:
            raise ValueError("N must be positive")
        if N <= x.shape[-1]:
            x = x[..., :N]
        else:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, N - x.shape[-1])]
            x = np.pad(x, pad)
    return _pack(*_hilbert_split(x, device=device))


def csd(x, y, **kwargs):
    """Cross spectral density — ``scipy.signal.csd``, complex Pxy
    (``device`` among the keywords)."""
    f, (cr, ci) = _csd_split(x, y, **kwargs)
    return f, _pack(cr, ci)


def stft(x, fs: float = 1.0, window="hann", nperseg: int = 256, noverlap=None,
         nfft=None, boundary: str | None = "zeros", padded: bool = True, device=None):
    """Short-time Fourier transform — ``scipy.signal.stft``, complex Zxx
    oriented (bins, frames)."""
    f, t, (zr, zi) = _stft_split(
        x, fs=fs, window=window, nperseg=nperseg, noverlap=noverlap,
        nfft=nfft, boundary=boundary, padded=padded, device=device,
    )
    return f, t, _pack(zr, zi)


def istft(Zxx, fs: float = 1.0, window="hann", nperseg=None, noverlap=None,
          boundary: bool = True, device=None):
    """Inverse STFT — ``scipy.signal.istft``: complex Zxx in, ``(t, x)`` out."""
    Zxx = np.asarray(Zxx)
    return _istft_split(
        np.ascontiguousarray(Zxx.real), np.ascontiguousarray(Zxx.imag),
        fs=fs, window=window, nperseg=nperseg, noverlap=noverlap,
        boundary=boundary, device=device,
    )


def czt(x, m: int | None = None, w: complex | None = None, a: complex = 1 + 0j, device=None):
    """Chirp-z transform — ``scipy.signal.czt``, complex output."""
    return _pack(*_czt_split(x, m, w, a, device=device))


def zoom_fft(x, fn, m: int | None = None, fs: float = 2.0, device=None):
    """Band-zoomed spectrum — ``scipy.signal.zoom_fft``, complex output."""
    return _pack(*_zoom_split(x, fn, m, fs, device=device))


def freqz(b, a=1.0, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi, device=None):
    """Rational frequency response — ``scipy.signal.freqz``, complex ``h``."""
    from ..ops.filter import freqz as _freqz_split

    w, hr, hi = _freqz_split(b, a, worN=worN, whole=whole, fs=fs, device=device)
    return w, _pack(hr, hi)


def sosfreqz(sos, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi, device=None):
    """Cascade frequency response — ``scipy.signal.sosfreqz``, complex ``h``."""
    from ..ops.filter import sosfreqz as _sosfreqz_split

    w, hr, hi = _sosfreqz_split(sos, worN=worN, whole=whole, fs=fs, device=device)
    return w, _pack(hr, hi)


#: scipy >= 1.12 name for :func:`sosfreqz` (``scipy.signal.freqz_sos``).
freqz_sos = sosfreqz


def freqz_zpk(z, p, k, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi):
    """Factored-form frequency response — ``scipy.signal.freqz_zpk``, complex
    ``h`` (host float64)."""
    from ..ops.design import freqz_zpk as _freqz_zpk_split

    w, hr, hi = _freqz_zpk_split(z, p, k, worN=worN, whole=whole, fs=fs)
    return w, _pack(hr, hi)


def get_window(window, Nx: int, fftbins: bool = True):
    """``scipy.signal.get_window``: every scipy window family, symmetric or
    periodic form, in f64 (see :mod:`gpu_fft_tpu_torch.signal.windows`)."""
    return windows.get_window(window, Nx, fftbins=fftbins)


for _name in _REAL_ONLY:
    globals()[_name] = _real_only(_name, globals()[_name])
del _name
