"""Chirp-z transform and zoom FFT over the library's pow2 path.

Port of ``gpu_fft_tpu/ops/czt.py``.  The two L-point transforms are
``kernels/large.py:transform_any``'s (K1/K2 at B = 1 in the whole band, K3
staged); the f64 host tables are the JAX package's, cached on the device.

The CZT evaluates the z-transform on a logarithmic spiral
``z_k = a * w**(-k)``, k = 0..m-1:

    X_k = sum_j x_j * a**(-j) * w**(j*k)

generalizing the DFT (``a = 1, w = exp(-2j*pi/n), m = n``) to arbitrary
point counts, start phase, and spacing — the classic use is ``zoom_fft``:
high-resolution analysis of a narrow frequency band without transforming
(or even having) a longer signal.  Same Bluestein identity as
``ops/exact.py`` (``jk = (j**2 + k**2 - (k-j)**2) / 2``) realized as one
circular convolution through the measured pow2 transform path, but with
independent input/output lengths and a general chirp.

Conventions match ``scipy.signal.czt`` / ``scipy.signal.zoom_fft``
(verified element-wise in the test suite).  Chirp tables are built on the
host in f64.  When ``w`` is known as an exact root of unity — the default
DFT spacing ``exp(-2j*pi/m)``, and ``zoom_fft``'s rational band step — the
chirp phase ``pi * num * j^2 / den`` is reduced with an exact integer
``mod 2*den`` before cos/sin, so the tables stay accurate at any supported
size.  For an arbitrary user-supplied complex ``w`` the phase is reduced in
f64, where rounding of the ~j^2-magnitude product can reach ~1e-4 rad at
strongly asymmetric n >> m; pass the exact spacing through ``zoom_fft`` (or
the default ``w``) when that matters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch.nn.functional as F

from ..config import MAX_N
from .transform import _as_tensor

__all__ = ["CZT", "ZoomFFT", "czt", "czt_device", "czt_points", "zoom_fft", "zoom_fft_device"]


def _phase_halfturns_exact(e: np.ndarray, num: int, den: int) -> np.ndarray:
    """``(e * num / den) mod 2`` in half-turns, via exact integer arithmetic.

    ``e`` is int64 (j^2, exact through MAX_N^2 < 2^48); ``num/den`` is the
    chirp's phase in units of pi per unit e.  The mod-2*den reduction happens
    on integers, so the only rounding is the final division — the phase error
    stays ~2^-53 half-turns at ANY j, vs ~j^2 * 2^-53 for the f64 product.
    """
    num, den = int(num), int(den)
    if abs(num).bit_length() + 48 < 63 and (2 * den).bit_length() < 63:
        r = (e * np.int64(num)) % np.int64(2 * den)  # int64-exact
        return r.astype(np.float64) / den
    # Wide fraction (e.g. an exact-float band step): Python bigints.
    r = (e.astype(object) * num) % (2 * den)
    return np.asarray([float(v) / den for v in r], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _czt_plan(n: int, m: int, w: complex, a: complex, w_frac: tuple | None = None) -> dict:
    """Host-built f64 tables: premultiplier u_j = a^(-j) w^(j^2/2), kernel
    spectrum K = FFT_L(wrapped w^(-j^2/2)), and postmultiplier p_k = w^(k^2/2).

    ``w_frac = (num, den)`` declares the chirp ``w^(e/2) = exp(1j*pi*e*num/den)``
    exactly (i.e. ``w = exp(2j*pi*num/den)``), and routes the chirp phase
    through the exact integer-mod reduction."""
    L = 1
    while L < n + m - 1:
        L *= 2
    jmax = max(n, m)
    j = np.arange(jmax, dtype=np.int64)
    e = j * j  # exact in int64 through MAX_N
    if w_frac is not None:
        num, den = w_frac
        ph = np.pi * _phase_halfturns_exact(e, num, den)
        mag = np.ones_like(ph)
    else:
        logw = np.log(complex(w))  # principal branch
        # w^(e/2) = exp((e/2) * logw); reduce the phase mod 2*pi.  The f64
        # product e * theta rounds before the mod, so very asymmetric n >> m
        # can see ~1e-4 rad of table phase error here — the exact path above
        # covers every w the library constructs itself.
        ph = np.remainder(e.astype(np.float64) * (logw.imag * 0.5), 2.0 * np.pi)
        mag = np.exp(e.astype(np.float64) * (logw.real * 0.5))
    chirp = mag * (np.cos(ph) + 1j * np.sin(ph))  # w^(j^2/2)
    ichirp = 1.0 / chirp  # w^(-j^2/2)

    ja = np.arange(n, dtype=np.float64)
    la = np.log(complex(a))
    apow = np.exp(-ja * la.real) * np.exp(-1j * np.remainder(ja * la.imag, 2.0 * np.pi))
    u = apow * chirp[:n]  # a^(-j) * w^(j^2/2)

    kern = np.zeros(L, dtype=np.complex128)
    kern[:m] = ichirp[:m]
    if n > 1:
        kern[L - n + 1 :] = ichirp[1:n][::-1]
    kspec = np.fft.fft(kern)
    return {
        "L": L,
        "ur": u.real.astype(np.float32), "ui": u.imag.astype(np.float32),
        "kr": kspec.real.astype(np.float32), "ki": kspec.imag.astype(np.float32),
        "pr": chirp[:m].real.astype(np.float32), "pi": chirp[:m].imag.astype(np.float32),
    }


def czt_device(
    x,
    m: int | None = None,
    w: complex | None = None,
    a: complex = 1 + 0j,
    imag=None,
    _w_frac: tuple | None = None,
    device=None,
):
    """Chirp-z transform of real (or split-complex) rows, on the tensor's
    device.

    ``x``: (n,) or (B, n) f32; ``m`` output points (default n); ``w`` the
    ratio between points (default ``exp(-2j*pi/m)``, the DFT spacing); ``a``
    the starting point.  Returns split-complex tensors of length m
    (``scipy.signal.czt`` semantics).
    """
    from ..kernels.large import transform_any
    from ..plan import on_device

    x = _as_tensor(x, device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or x.shape[-1] < 1:
        raise ValueError(f"czt expects non-empty 1-D or (B, n) input, got {tuple(x.shape)}")
    n = x.shape[-1]
    m = n if m is None else m
    if m < 1:
        raise ValueError(f"czt needs m >= 1 output points, got {m}")
    if w is None:
        # The DFT spacing is a known root of unity, w^(e/2) = exp(-j*pi*e/m):
        # declare it so the chirp phase reduces with the exact integer mod.
        w = complex(np.exp(-2j * np.pi / m))
        _w_frac = (-1, m)
    else:
        w = complex(w)
    if w == 0 or complex(a) == 0:
        raise ValueError("czt requires nonzero w and a")
    L = 1
    while L < n + m - 1:
        L *= 2
    if L > MAX_N:
        raise ValueError(
            f"czt with n={n}, m={m} needs a {L}-point convolution, beyond the supported maximum {MAX_N}"
        )
    p = on_device(_czt_plan, n, m, w, complex(a), _w_frac, device=x.device)
    xi = None
    if imag is not None:
        xi = _as_tensor(imag, x.device)
        xi = xi[None] if squeeze else xi
        if xi.shape != x.shape:
            raise ValueError(f"czt: real and imag shapes differ: {tuple(x.shape)} vs {tuple(xi.shape)}")
    # y = x * u
    if xi is None:
        yr = x * p["ur"]
        yi = x * p["ui"]
    else:
        yr = x * p["ur"] - xi * p["ui"]
        yi = x * p["ui"] + xi * p["ur"]
    pad = (0, L - n)
    fr, fi = transform_any(F.pad(yr, pad), F.pad(yi, pad), L, -1)
    cr = fr * p["kr"] - fi * p["ki"]
    ci = fr * p["ki"] + fi * p["kr"]
    gr, gi = transform_any(cr, ci, L, +1)  # unnormalized inverse
    s = 1.0 / L  # a power of two: exact in fp32
    gr = gr[:, :m] * s
    gi = gi[:, :m] * s
    outr = gr * p["pr"] - gi * p["pi"]
    outi = gr * p["pi"] + gi * p["pr"]
    return (outr[0], outi[0]) if squeeze else (outr, outi)


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j) -> np.ndarray:
    """``scipy.signal.czt_points``: the z-plane points a chirp-z transform
    with these parameters evaluates at — z_k = a * w^{-k}, k = 0..m-1
    (default w traces the full unit circle).  Host f64 math: the phase is
    accumulated as k*arg(w) rather than powered, so |z_k| stays exact for
    unit-modulus w at any m."""
    if int(m) != m or m < 1:
        raise ValueError(f"m must be a positive integer, got {m!r}")
    m = int(m)
    k = np.arange(m, dtype=np.float64)
    if w is None:
        return a * np.exp(2j * np.pi * k / m)
    w = complex(w)
    r = np.abs(w) ** -k
    th = -k * np.angle(w)
    return a * r * (np.cos(th) + 1j * np.sin(th))


def czt(x, m: int | None = None, w: complex | None = None, a: complex = 1 + 0j, device=None):
    """Host-convenience chirp-z transform; see :func:`czt_device`."""
    yr, yi = czt_device(np.asarray(x, dtype=np.float32), m, w, a, device=device)
    return yr.cpu().numpy(), yi.cpu().numpy()


def zoom_fft_device(x, fn, m: int | None = None, fs: float = 2.0, device=None):
    """Zoomed DFT of real rows over the band ``fn = [f1, f2]``, on the
    tensor's device.

    m equally spaced spectrum points from f1 to f2 (endpoint excluded: step
    (f2 - f1) / m) without the full transform (``scipy.signal.zoom_fft``
    semantics).  A scalar ``fn`` means [0, fn]; ``m`` defaults to the signal
    length; ``fs`` is the sample rate.  Returns split-complex (re, im).
    """
    xa = _as_tensor(x, device)
    n = xa.shape[-1]
    if np.ndim(fn) == 0:
        f1, f2 = 0.0, float(fn)
    else:
        fn = np.asarray(fn, dtype=np.float64)
        if fn.shape != (2,):
            raise ValueError(f"fn must be a scalar or [f1, f2], got shape {fn.shape}")
        f1, f2 = float(fn[0]), float(fn[1])
    m = n if m is None else m
    if fs <= 0:
        raise ValueError(f"fs must be positive, got {fs}")
    # The band step is rational in the (exact binary) floats f1, f2, fs, so
    # the chirp phase takes the exact integer-mod path: the chirp
    # w^(e/2) = exp(1j*pi*e*p/q) with p/q = -(f2 - f1) / (m * fs) exactly.
    from fractions import Fraction

    frac = -Fraction(f2 - f1) / (m * Fraction(fs))
    w = complex(np.exp(-2j * np.pi * (f2 - f1) / (m * fs)))
    a = complex(np.exp(2j * np.pi * f1 / fs))
    return czt_device(xa, m=m, w=w, a=a, _w_frac=(frac.numerator, frac.denominator))


def zoom_fft(x, fn, m: int | None = None, fs: float = 2.0, device=None):
    """Host-convenience zoom FFT; see :func:`zoom_fft_device`."""
    yr, yi = zoom_fft_device(np.asarray(x, dtype=np.float32), fn, m, fs, device=device)
    return yr.cpu().numpy(), yi.cpu().numpy()


class CZT:
    """Reusable chirp-z transform plan (``scipy.signal.CZT``): fixes
    (n, m, w, a) once so repeated calls share the precomputed chirp and
    filter tables, cached per device."""

    def __init__(self, n: int, m: int | None = None, w: complex | None = None,
                 a: complex = 1 + 0j, device=None):
        if n < 1:
            raise ValueError("n must be positive")
        self.n = int(n)
        self.m = int(m) if m is not None else int(n)
        if self.m < 1:
            raise ValueError("m must be positive")
        self.w = w
        self.a = a
        self.device = device

    def __call__(self, x, *, axis: int = -1):
        x = np.asarray(x)
        if x.shape[axis] != self.n:
            raise ValueError(f"input length {x.shape[axis]} != plan n {self.n}")
        x = np.moveaxis(x, axis, -1)
        re, im = czt(x.reshape(-1, self.n), m=self.m, w=self.w, a=self.a, device=self.device)
        out = re + 1j * im  # every row in one batched call
        return np.moveaxis(out.reshape(x.shape[:-1] + (self.m,)), -1, axis)

    def points(self) -> np.ndarray:
        """The m z-plane evaluation points of this plan."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Bandlimited DFT plan (``scipy.signal.ZoomFFT``): a CZT whose points
    sweep [f1, f2] on the unit circle."""

    def __init__(self, n: int, fn, m: int | None = None, *, fs: float = 2.0,
                 endpoint: bool = False, device=None):
        fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
        if fn.size == 2:
            f1, f2 = float(fn[0]), float(fn[1])
        elif fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            raise ValueError("fn must be one or two frequencies")
        m = int(m) if m is not None else int(n)
        scale = (f2 - f1) / (m - 1) if endpoint and m > 1 else (f2 - f1) / m
        w = np.exp(-2j * np.pi * scale / fs)
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m=m, w=w, a=a, device=device)
        self.f1, self.f2, self.fs = f1, f2, fs
