"""Fourier-domain filters — the ``scipy.ndimage`` fourier_* family.

Port of ``gpu_fft_tpu/ops/ndimage_fourier.py``.  The four filters multiply
an already-transformed spectrum by a closed-form transfer function:

* ``fourier_gaussian`` — separable ``prod_i exp(-(2*pi*sigma_i*f_i)^2 / 2)``
* ``fourier_uniform``  — separable ``prod_i sinc(size_i * f_i)``
* ``fourier_ellipsoid`` — radial: 1-D ``sinc(r/pi)``, 2-D ``2*J1(r)/r``,
  3-D ``3*(sin r - r*cos r)/r^3`` with ``r = sqrt(sum (pi*size_i*f_i)^2)``
  (>3-D raises NotImplementedError like scipy)
* ``fourier_shift``    — separable ``prod_i exp(-2j*pi*f_i*shift_i)``

The transfer tables are built on the host in f64, cast to f32 once and
cached per device (``plan.on_device``); the separable filters keep one 1-D
table per axis and broadcast it, so the device work is a few elementwise
multiplies.  J1 is computed to f64 machine precision from Bessel's integral
``J1(x) = (1/pi) * int_0^pi cos(t - x*sin t) dt`` by the midpoint rule, no
scipy.special.

The real-transform mode (``n >= 0``) follows scipy: the ``axis`` grid is
``j / n`` for ``j < input.shape[axis]`` (an rfft layout of a length-``n``
real signal).  ``*_device`` forms take and return split-complex tensors; the
scipy-signature forms take a real or complex array and return numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..plan import on_device
from .transform import _as_tensor

__all__ = [
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_ellipsoid",
    "fourier_shift",
    "fourier_gaussian_device",
    "fourier_uniform_device",
    "fourier_ellipsoid_device",
    "fourier_shift_device",
]


def _normalize_sequence(val, ndim: int, name: str) -> list[float]:
    if np.isscalar(val):
        return [float(val)] * ndim
    seq = [float(v) for v in np.asarray(val).ravel()]
    if len(seq) != ndim:
        raise ValueError(f"{name} must be a scalar or have one value per axis")
    return seq


def _axis_freqs(shape: tuple[int, ...], n: int, axis: int) -> list[np.ndarray]:
    """Per-axis frequency grids (f64).  ``axis`` uses the real-transform
    layout ``j/n`` when ``n >= 0``; every other axis is fftfreq."""
    ndim = len(shape)
    axis = axis % ndim
    freqs = []
    for ax, m in enumerate(shape):
        if ax == axis and n >= 0:
            if n == 0:
                raise ValueError("n must be positive for a real transform axis")
            freqs.append(np.arange(m, dtype=np.float64) / float(n))
        else:
            freqs.append(np.fft.fftfreq(m).astype(np.float64))
    return freqs


# Radii per block of the J1 quadrature: a (block, m) f64 array, ~40 MB at
# m = 80, where the whole grid at once would take m * 8 bytes a radius.
_J1_BLOCK = 1 << 16


def _bessel_j1(x: np.ndarray) -> np.ndarray:
    """J1 to f64 machine precision via the midpoint rule on Bessel's
    integral (spectral convergence for point count > ~max|x|).  Each
    distinct radius is integrated once, in blocks: a 4,096 x 4,096 radial
    grid holds ~2M distinct radii, and the whole grid at once would need
    ~10 GB of temporaries.  Every value is the JAX package's, bit for bit
    (each radius's sum runs alone along its own row)."""
    x = np.asarray(x, np.float64)
    m = int(max(64, 2 * np.ceil(np.abs(x).max() if x.size else 0) + 32))
    t = (np.arange(m, dtype=np.float64) + 0.5) * (np.pi / m)  # midpoint rule
    radii, where = np.unique(x, return_inverse=True)
    out = np.empty_like(radii)
    for s in range(0, radii.size, _J1_BLOCK):
        r = radii[s:s + _J1_BLOCK]
        out[s:s + _J1_BLOCK] = np.cos(t[None, :] - r[:, None] * np.sin(t)[None, :]).mean(axis=1)
    return out[where].reshape(x.shape)


def _separable_tables(kind: str, params, shape, n, axis):
    """Per-axis REAL f64 transfer tables for gaussian/uniform."""
    vals = _normalize_sequence(params, len(shape), kind)
    tables = []
    for f, v in zip(_axis_freqs(shape, n, axis), vals):
        if kind == "sigma":
            tables.append(np.exp(-0.5 * (2.0 * np.pi * v * f) ** 2))
        else:  # box size
            tables.append(np.sinc(v * f))
    return tables


def _ellipsoid_table(size, shape, n, axis) -> np.ndarray:
    """Full radial transfer grid (f64).  Non-separable for ndim >= 2, so the
    grid is materialized on the host."""
    ndim = len(shape)
    if ndim > 3:
        raise NotImplementedError(
            "fourier_ellipsoid supports up to 3 dimensions (scipy parity)"
        )
    sizes = _normalize_sequence(size, ndim, "size")
    freqs = _axis_freqs(shape, n, axis)
    if ndim == 1:
        return np.sinc(sizes[0] * freqs[0])
    r2 = np.zeros(shape, np.float64)
    for ax, (f, v) in enumerate(zip(freqs, sizes)):
        view = [None] * ndim
        view[ax] = slice(None)
        r2 = r2 + (np.pi * v * f)[tuple(view)] ** 2
    r = np.sqrt(r2)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ndim == 2:
            out = 2.0 * _bessel_j1(r) / r
        else:
            out = 3.0 * (np.sin(r) - r * np.cos(r)) / (r**3)
    return np.where(r == 0.0, 1.0, out)


def _shift_tables(shift, shape, n, axis):
    """Per-axis COMPLEX tables exp(-2j*pi*f*shift) as (re, im) f64 pairs."""
    shifts = _normalize_sequence(shift, len(shape), "shift")
    tables = []
    for f, s in zip(_axis_freqs(shape, n, axis), shifts):
        ang = -2.0 * np.pi * f * s
        tables.append((np.cos(ang), np.sin(ang)))
    return tables


def _bcast(t, ax: int, ndim: int):
    view = [None] * ndim
    view[ax] = slice(None)
    return t[tuple(view)]


# ── Tables, f32, cached per device ───────────────────────────────────────────


def _key(val):
    """A hashable form of a scalar-or-sequence parameter."""
    return float(val) if np.isscalar(val) else tuple(float(v) for v in np.asarray(val).ravel())


@functools.lru_cache(maxsize=64)
def _separable_plan(kind: str, params, shape: tuple, n: int, axis: int) -> dict:
    return {ax: t.astype(np.float32) for ax, t in enumerate(_separable_tables(kind, params, shape, n, axis))}


@functools.lru_cache(maxsize=8)
def _ellipsoid_plan(size, shape: tuple, n: int, axis: int) -> dict:
    return {"t": _ellipsoid_table(size, shape, n, axis).astype(np.float32)}


@functools.lru_cache(maxsize=64)
def _shift_plan(shift, shape: tuple, n: int, axis: int) -> dict:
    return {ax: {"r": cr.astype(np.float32), "i": ci.astype(np.float32)}
            for ax, (cr, ci) in enumerate(_shift_tables(shift, shape, n, axis))}


# ── Device (split-complex) variants ──────────────────────────────────────────


def _operands(xr, xi, device):
    xr = _as_tensor(xr, device)
    return xr, None if xi is None else _as_tensor(xi, xr.device)


def _apply_real_tables(xr, xi, tables: dict):
    ndim = xr.dim()
    for ax, t in tables.items():
        m = _bcast(t, ax, ndim)
        xr = xr * m
        xi = None if xi is None else xi * m
    return xr, xi


def fourier_gaussian_device(xr, xi, sigma, n: int = -1, axis: int = -1, device=None):
    """Split-complex device form of :func:`fourier_gaussian`; ``xi`` may be
    None (a real spectrum part)."""
    xr, xi = _operands(xr, xi, device)
    tables = on_device(_separable_plan, "sigma", _key(sigma), tuple(xr.shape), n, axis, device=xr.device)
    return _apply_real_tables(xr, xi, tables)


def fourier_uniform_device(xr, xi, size, n: int = -1, axis: int = -1, device=None):
    """Split-complex device form of :func:`fourier_uniform`."""
    xr, xi = _operands(xr, xi, device)
    tables = on_device(_separable_plan, "size", _key(size), tuple(xr.shape), n, axis, device=xr.device)
    return _apply_real_tables(xr, xi, tables)


def fourier_ellipsoid_device(xr, xi, size, n: int = -1, axis: int = -1, device=None):
    """Split-complex device form of :func:`fourier_ellipsoid` (ndim <= 3)."""
    xr, xi = _operands(xr, xi, device)
    t = on_device(_ellipsoid_plan, _key(size), tuple(xr.shape), n, axis, device=xr.device)["t"]
    return xr * t, (None if xi is None else xi * t)


def fourier_shift_device(xr, xi, shift, n: int = -1, axis: int = -1, device=None):
    """Split-complex device form of :func:`fourier_shift`.  The output is
    complex, so ``xi=None`` input still returns both parts."""
    xr, xi = _operands(xr, xi, device)
    ndim = xr.dim()
    if xi is None:
        xi = torch.zeros_like(xr)
    tables = on_device(_shift_plan, _key(shift), tuple(xr.shape), n, axis, device=xr.device)
    for ax, c in tables.items():
        mr = _bcast(c["r"], ax, ndim)
        mi = _bcast(c["i"], ax, ndim)
        xr, xi = xr * mr - xi * mi, xr * mi + xi * mr
    return xr, xi


# ── scipy-signature facade (complex arrays in, numpy out) ────────────────────


def _split(input):
    x = input.detach().cpu().numpy() if isinstance(input, torch.Tensor) else np.asarray(input)
    if np.iscomplexobj(x):
        return np.real(x).astype(np.float32), np.imag(x).astype(np.float32)
    return x.astype(np.float32), None


def _check_output(output):
    if output is not None:
        raise ValueError("output= is not supported: use the return value")


def _join(yr, yi):
    yr = yr.cpu().numpy()
    return yr if yi is None else yr + 1j * yi.cpu().numpy()


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1, output=None, device=None):
    """Multidimensional Gaussian Fourier filter — ``scipy.ndimage.fourier_gaussian``.

    Multiplies the spectrum by the transform of a Gaussian kernel.  Real
    input stays real (the transfer function is real); compute is f32.
    """
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_gaussian_device(xr, xi, sigma, n, axis, device=device))


def fourier_uniform(input, size, n: int = -1, axis: int = -1, output=None, device=None):
    """Multidimensional uniform (box) Fourier filter — ``scipy.ndimage.fourier_uniform``."""
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_uniform_device(xr, xi, size, n, axis, device=device))


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1, output=None, device=None):
    """Multidimensional ellipsoid Fourier filter — ``scipy.ndimage.fourier_ellipsoid``
    (1-3 dimensions, scipy parity)."""
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_ellipsoid_device(xr, xi, size, n, axis, device=device))


def fourier_shift(input, shift, n: int = -1, axis: int = -1, output=None, device=None):
    """Multidimensional Fourier shift filter — ``scipy.ndimage.fourier_shift``.

    The output is complex whatever the input (phase ramps are complex).
    """
    _check_output(output)
    xr, xi = _split(input)
    return _join(*fourier_shift_device(xr, xi, shift, n, axis, device=device))
