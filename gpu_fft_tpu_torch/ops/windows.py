"""Window functions: the full ``scipy.signal.windows`` surface in float64.

A copy of the JAX package's ``gpu_fft_tpu/ops/windows.py`` (numpy only; the
port keeps its own so that it imports nothing of that package); every window
is bit-identical to it (``tests/test_torch_windows.py``).  Windows are
one-time f64 design constants made on the host; the estimators
(:mod:`.stft`, :mod:`.spectral`) round them to fp32 and cache them on the
device.  scipy's conventions throughout: ``sym=True`` gives the symmetric
(filter-design) form, ``sym=False`` the periodic (DFT-even) form, computed as
the M + 1 symmetric window with the last sample dropped; ``M in (0, 1)``
gives ones; a negative or non-integral M raises.

Definitions: Harris 1978 for the cosine-sum family, Percival & Walden 1993
for DPSS, the Dolph-Chebyshev DFT construction for chebwin.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

__all__ = [
    "boxcar", "triang", "parzen", "bohman", "blackman", "nuttall",
    "blackmanharris", "flattop", "bartlett", "barthann", "hamming",
    "kaiser", "kaiser_bessel_derived", "gaussian", "general_cosine",
    "general_gaussian", "general_hamming", "chebwin", "cosine", "hann",
    "exponential", "tukey", "taylor", "get_window", "dpss", "lanczos",
]


def _guard(M) -> bool:
    """Validate M; True when the caller should return ones(M) directly."""
    if int(M) != M or M < 0:
        raise ValueError("Window length M must be a non-negative integer")
    return M <= 1


def _extend(M: int, sym: bool) -> tuple[int, bool]:
    return (M, False) if sym else (M + 1, True)


def _trunc(w: np.ndarray, needs: bool) -> np.ndarray:
    return w[:-1] if needs else w


# ------------------------------------------------------- cosine-sum family
def general_cosine(M, a, sym: bool = True):
    """Generic weighted cosine-sum window: w[n] = sum_k a[k] cos(k*fac[n])
    with fac = linspace(-pi, pi, M)."""
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    fac = np.linspace(-np.pi, np.pi, M)
    w = np.zeros(M)
    for k, ak in enumerate(np.asarray(a, dtype=np.float64)):
        w += ak * np.cos(k * fac)
    return _trunc(w, needs)


def general_hamming(M, alpha, sym: bool = True):
    """Generalized Hamming: alpha - (1-alpha) cos-term."""
    return general_cosine(M, [alpha, 1.0 - alpha], sym)


def hamming(M, sym: bool = True):
    return general_hamming(M, 0.54, sym)


def hann(M, sym: bool = True):
    return general_hamming(M, 0.5, sym)


def blackman(M, sym: bool = True):
    return general_cosine(M, [0.42, 0.50, 0.08], sym)


def nuttall(M, sym: bool = True):
    return general_cosine(M, [0.3635819, 0.4891775, 0.1365995, 0.0106411], sym)


def blackmanharris(M, sym: bool = True):
    return general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def flattop(M, sym: bool = True):
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(M, a, sym)


# ----------------------------------------------------------- simple shapes
def boxcar(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    return np.ones(M)


def triang(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(1, (M + 1) // 2 + 1, dtype=np.float64)
    if M % 2 == 0:
        half = (2 * n - 1.0) / M
        w = np.concatenate([half, half[::-1]])
    else:
        half = 2 * n / (M + 1.0)
        w = np.concatenate([half, half[-2::-1]])
    return _trunc(w, needs)


def bartlett(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(M, dtype=np.float64)
    w = np.where(n <= (M - 1) / 2.0, 2.0 * n / (M - 1), 2.0 - 2.0 * n / (M - 1))
    return _trunc(w, needs)


def barthann(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    fac = np.abs(np.arange(M, dtype=np.float64) / (M - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _trunc(w, needs)


def parzen(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(-(M - 1) / 2.0, (M - 1) / 2.0 + 0.5, 1.0)
    na = np.abs(n) / (M / 2.0)
    w = np.where(np.abs(n) <= (M - 1) / 4.0,
                 1.0 - 6.0 * na ** 2 + 6.0 * na ** 3,
                 2.0 * (1.0 - na) ** 3)
    return _trunc(w, needs)


def bohman(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    fac = np.abs(np.linspace(-1.0, 1.0, M)[1:-1])
    core = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w = np.concatenate([[0.0], core, [0.0]])
    return _trunc(w, needs)


def cosine(M, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    w = np.sin(np.pi / M * (np.arange(M) + 0.5))
    return _trunc(w, needs)


def lanczos(M, *, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    # build from the right half + mirror so the result is exactly symmetric
    if M % 2 == 0:
        right = np.sinc(2.0 * np.arange(M / 2, M) / (M - 1) - 1.0)
        w = np.concatenate([right[::-1], right])
    else:
        right = np.sinc(2.0 * np.arange((M + 1) / 2, M) / (M - 1) - 1.0)
        w = np.concatenate([right[::-1], [1.0], right])
    return _trunc(w, needs)


# -------------------------------------------------------- parametric shapes
def gaussian(M, std, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(M, dtype=np.float64) - (M - 1) / 2.0
    return _trunc(np.exp(-(n ** 2) / (2.0 * std * std)), needs)


def general_gaussian(M, p, sig, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(M, dtype=np.float64) - (M - 1) / 2.0
    return _trunc(np.exp(-0.5 * np.abs(n / sig) ** (2 * p)), needs)


def kaiser(M, beta, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    n = np.arange(M, dtype=np.float64)
    alpha = (M - 1) / 2.0
    w = np.i0(beta * np.sqrt(1.0 - ((n - alpha) / alpha) ** 2)) / np.i0(float(beta))
    return _trunc(w, needs)


def kaiser_bessel_derived(M, beta, *, sym: bool = True):
    """KBD window (MDCT analysis): sqrt of the normalized running sum of a
    half-length-plus-one Kaiser window, mirrored.  Even M, symmetric only."""
    if not sym:
        raise ValueError(
            "Kaiser-Bessel Derived windows are only defined for symmetric shapes")
    if M < 1:
        return np.array([])
    if M % 2:
        raise ValueError(
            "Kaiser-Bessel Derived windows are only defined for even number of points")
    csum = np.cumsum(kaiser(M // 2 + 1, beta))
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])


def exponential(M, center=None, tau: float = 1.0, sym: bool = True):
    if sym and center is not None:
        raise ValueError("If sym==True, center must be None.")
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    if center is None:
        center = (M - 1) / 2.0
    w = np.exp(-np.abs(np.arange(M, dtype=np.float64) - center) / tau)
    return _trunc(w, needs)


def tukey(M, alpha: float = 0.5, sym: bool = True):
    if _guard(M):
        return np.ones(M)
    if alpha <= 0:
        return np.ones(M)
    if alpha >= 1.0:
        return hann(M, sym=sym)
    M, needs = _extend(M, sym)
    n = np.arange(M, dtype=np.float64)
    width = int(math.floor(alpha * (M - 1) / 2.0))
    n1, n3 = n[: width + 1], n[M - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (M - 1))))
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / (M - 1))))
    w = np.concatenate([w1, np.ones(max(M - 2 * width - 2, 0)), w3])
    return _trunc(w, needs)


def chebwin(M, at, sym: bool = True):
    """Dolph-Chebyshev: minimum mainlobe width for ``at`` dB of equiripple
    sidelobe attenuation, via the analytic Chebyshev-polynomial DFT."""
    if np.abs(at) < 45:
        warnings.warn("This window is not suitable for spectral analysis "
                      "for attenuation values lower than about 45dB because "
                      "the equivalent noise bandwidth of a Chebyshev window "
                      "does not grow monotonically with increasing sidelobe "
                      "attenuation when the attenuation is smaller than "
                      "about 45 dB.", stacklevel=2)
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    order = M - 1.0
    beta = np.cosh(np.arccosh(10.0 ** (np.abs(at) / 20.0)) / order)
    x = beta * np.cos(np.pi * np.arange(M) / M)
    # T_order(x) by region (trig/hyperbolic forms — exact, no polynomial
    # expansion error)
    p = np.empty_like(x)
    over, under = x > 1, x < -1
    mid = ~(over | under)
    p[over] = np.cosh(order * np.arccosh(x[over]))
    p[under] = (2 * (M % 2) - 1) * np.cosh(order * np.arccosh(-x[under]))
    p[mid] = np.cos(order * np.arccos(x[mid]))
    # inverse DFT of the real spectrum (host f64 one-time table — the f32
    # device engine would cost table accuracy here, same policy as
    # minimum_phase, filter.py:789)
    if M % 2:
        w = np.real(np.fft.fft(p))
        n = (M + 1) // 2
        w = np.concatenate([w[n - 1:0:-1], w[:n]])
    else:
        w = np.real(np.fft.fft(p * np.exp(1j * np.pi / M * np.arange(M))))
        n = M // 2 + 1
        w = np.concatenate([w[n - 1:0:-1], w[1:n]])
    return _trunc(w / np.max(w), needs)


def taylor(M, nbar: int = 4, sll: float = 30, norm: bool = True, sym: bool = True):
    """Taylor window: near-Chebyshev sidelobe control with the first
    ``nbar`` sidelobes held at ``-sll`` dB (standard radar taper)."""
    if _guard(M):
        return np.ones(M)
    M, needs = _extend(M, sym)
    B = 10.0 ** (sll / 20.0)
    A = np.arccosh(B) / np.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)
    m2 = ma * ma
    Fm = np.empty(nbar - 1)
    signs = np.where(np.arange(nbar - 1) % 2 == 0, 1.0, -1.0)
    for i in range(nbar - 1):
        numer = signs[i] * np.prod(1 - m2[i] / s2 / (A ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod(1 - m2[i] / m2[:i]) * np.prod(1 - m2[i] / m2[i + 1:])
        Fm[i] = numer / denom

    def _w(n):
        return 1 + 2 * (Fm @ np.cos(2 * np.pi * ma[:, None] * (n - M / 2.0 + 0.5) / M))

    w = _w(np.arange(M, dtype=np.float64))
    if norm:
        w = w / _w(np.array([(M - 1) / 2.0]))[0]
    return _trunc(w, needs)


def dpss(M, NW, Kmax=None, sym: bool = True, norm=None, return_ratios: bool = False):
    """Discrete prolate spheroidal (Slepian) sequences: the ``Kmax``
    tapers maximizing energy concentration in [-NW/M, NW/M], from the
    Percival-Walden symmetric tridiagonal eigenproblem."""
    if norm is None:
        norm = "approximate" if Kmax is None else 2
    if norm not in (2, "approximate", "subsample"):
        raise ValueError(f"norm must be one of (2, 'approximate', 'subsample'), "
                         f"got {norm}")
    singleton = Kmax is None
    Kmax = 1 if singleton else int(Kmax)
    if _guard(M):
        ones = np.ones(M)
        if not return_ratios:
            return ones
        return (ones, 1.0) if singleton else (ones, np.ones(1))
    if not 0 < Kmax <= M:
        raise ValueError("Kmax must be greater than 0 and less than M")
    if NW >= M / 2.0:
        raise ValueError("NW must be less than M/2.")
    if NW <= 0:
        raise ValueError("NW must be positive")
    M, needs = _extend(M, sym)
    W = float(NW) / M
    nidx = np.arange(M, dtype=np.float64)
    # Symmetric tridiagonal whose eigenvectors are the Slepian tapers
    # (Percival & Walden 1993, eq. 378): diag d, off-diagonal e.
    d = ((M - 1 - 2 * nidx) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    e = nidx[1:] * (M - nidx[1:]) / 2.0
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    evals, evecs = np.linalg.eigh(T)  # ascending
    windows_ = evecs[:, -1: -Kmax - 1: -1].T  # top-Kmax, descending eigenvalue
    # sign conventions: symmetric tapers have positive mean; antisymmetric
    # tapers start with a positive first above-noise lobe
    for i in range(0, Kmax, 2):
        if windows_[i].sum() < 0:
            windows_[i] *= -1
    thresh = max(1e-7, 1.0 / M)
    for i in range(1, Kmax, 2):
        wi = windows_[i]
        if wi[wi * wi > thresh][0] < 0:
            windows_[i] *= -1
    if return_ratios:
        # concentration ratios from the taper autocorrelation against the
        # bandpass kernel (Percival & Walden 1993 pg 390)
        n_fft = 1 << int(np.ceil(np.log2(2 * M - 1)))
        spec = np.abs(np.fft.rfft(windows_, n_fft)) ** 2
        rxx = np.fft.irfft(spec, n_fft)[:, :M]
        r = 4 * W * np.sinc(2 * W * nidx)
        r[0] = 2 * W
        ratios = rxx @ r
        if singleton:
            ratios = ratios[0]
    if norm != 2:
        windows_ = windows_ / windows_.max()
        if M % 2 == 0:
            if norm == "approximate":
                correction = M ** 2 / float(M ** 2 + NW)
            else:
                s = np.fft.rfft(windows_[0])
                shift = -(1 - 1.0 / M) * np.arange(1, M // 2 + 1, dtype=np.float64)
                s[1:] *= 2 * np.exp(-1j * np.pi * shift)
                correction = M / s.real.sum()
            windows_ = windows_ * correction
    if needs:
        windows_ = windows_[:, :-1]
    if singleton:
        windows_ = windows_[0]
    return (windows_, ratios) if return_ratios else windows_


# ------------------------------------------------------------- get_window
_NO_ARGS = dict.fromkeys(
    ["barthann", "brthan", "bth"], barthann) | dict.fromkeys(
    ["bartlett", "bart", "brt"], bartlett) | dict.fromkeys(
    ["blackman", "black", "blk"], blackman) | dict.fromkeys(
    ["blackmanharris", "blackharr", "bkh"], blackmanharris) | dict.fromkeys(
    ["bohman", "bman", "bmn"], bohman) | dict.fromkeys(
    ["boxcar", "box", "ones", "rect", "rectangular"], boxcar) | dict.fromkeys(
    ["cosine", "halfcosine"], cosine) | dict.fromkeys(
    ["flattop", "flat", "flt"], flattop) | dict.fromkeys(
    ["hamming", "hamm", "ham"], hamming) | dict.fromkeys(
    ["hann", "han"], hann) | dict.fromkeys(
    ["lanczos", "sinc"], lanczos) | dict.fromkeys(
    ["nuttall", "nutl", "nut"], nuttall) | dict.fromkeys(
    ["parzen", "parz", "par"], parzen) | dict.fromkeys(
    ["triangle", "triang", "tri"], triang)

_NEEDS_ARGS = dict.fromkeys(
    ["chebwin", "cheb"], chebwin) | dict.fromkeys(
    ["dpss"], dpss) | dict.fromkeys(
    ["gaussian", "gauss", "gss"], gaussian) | dict.fromkeys(
    ["general cosine", "general_cosine"], general_cosine) | dict.fromkeys(
    ["general gaussian", "general_gaussian", "general gauss", "general_gauss",
     "ggs"], general_gaussian) | dict.fromkeys(
    ["general hamming", "general_hamming"], general_hamming) | dict.fromkeys(
    ["kaiser", "ksr"], kaiser) | dict.fromkeys(
    ["kaiser bessel derived", "kaiser_bessel_derived", "kbd"],
    kaiser_bessel_derived)

_OPTIONAL_ARGS = dict.fromkeys(
    ["exponential", "poisson"], exponential) | dict.fromkeys(
    ["taylor", "taylorwin"], taylor) | dict.fromkeys(
    ["tukey", "tuk"], tukey)


def get_window(window, Nx: int, fftbins: bool = True):
    """``scipy.signal.get_window``: name / (name, *params) tuple / bare
    float (kaiser beta) to a window of ``Nx`` samples; ``fftbins=True``
    gives the periodic (DFT-even) form.  ``'<name>_symmetric'`` /
    ``'<name>_periodic'`` suffixes override ``fftbins``.

    >>> get_window('hann', 4).tolist()
    [0.0, 0.5, 1.0, 0.5]
    >>> get_window(('kaiser', 0.0), 3).tolist()
    [1.0, 1.0, 1.0]
    """
    if not (isinstance(Nx, (int, np.integer)) and Nx > 0):
        raise ValueError(f"Parameter Nx={Nx!r} is not a positive integer")
    if not isinstance(fftbins, bool):
        raise ValueError(f"Parameter fftbins={fftbins!r} is not of type bool!")
    if not isinstance(window, (str, tuple)):
        try:
            beta = float(window)
        except Exception as exc:
            raise ValueError(f"Parameter window={window!r} must be a tuple, "
                             "a string or a float!") from exc
        return kaiser(Nx, beta, not fftbins)
    if isinstance(window, tuple) and not isinstance(window[0], str):
        raise ValueError(f"First tuple entry of parameter window={window!r} "
                         "is not a str!")
    sym = not fftbins
    name = window if isinstance(window, str) else window[0]
    if name.endswith("_symmetric"):
        sym, name = True, name[:-10]
    elif name.endswith("_periodic"):
        sym, name = False, name[:-9]
    args = window[1:] if isinstance(window, tuple) else ()
    if name in _NO_ARGS:
        if args:
            raise ValueError(f"'{name}' does not allow parameters, but "
                             f"window={window!r}!")
        return _NO_ARGS[name](Nx, sym=sym)
    if name in _NEEDS_ARGS:
        func = _NEEDS_ARGS[name]
        if not args:
            raise ValueError(f"'{name}' must have parameters, but window={window!r}!")
        if func is dpss:
            if len(args) != 1:
                raise ValueError(f"Window {name} must have one parameter but "
                                 f"window={window!r}")
            return dpss(Nx, args[0], Kmax=None, sym=sym)
        if func is kaiser_bessel_derived:
            return func(Nx, *args, sym=sym)
        return func(Nx, *args, sym=sym)
    if name in _OPTIONAL_ARGS:
        return _OPTIONAL_ARGS[name](Nx, *args, sym=sym)
    raise ValueError(f"Invalid window name '{name}' in parameter window={window!r}!")
