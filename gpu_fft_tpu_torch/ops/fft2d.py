"""2-D and N-D FFTs, built from the 1-D dispatch.

Port of ``gpu_fft_tpu/ops/fft2d.py``.  Row transforms with the batch folded
into the leading dim, one transpose, column transforms, the transpose back.
Conventions match ``numpy.fft.fft2``: split-complex f32 in and out,
unnormalized forward, 1/(H*W) on the inverse, and any side length: power-of-
two sides run ``kernels/large.py:transform_any`` (``plan.route``'s
engine), other lengths run exactly by Bluestein (``ops/exact.py:_bluestein``),
never by padding.

Where ``plan.axis0_applies(H, W)`` the column pass runs in place over axis
0 instead (``kernels/fused_torch.py:transform_axis0``), as in the JAX
package; that gate is closed on both tuning rows, so the transpose branch
is what runs.

``*_device`` functions take and return tensors on the input's device (a
non-tensor goes to ``device``, default ``"cuda"``) and carry autograd
through the transform Functions; the host forms take numpy, return numpy
and run on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import plan as _plan
from ..config import MAX_N
from ..kernels import fused_torch as _fused_torch
from ..utils.profiling import span
from .exact import _check_exact_n
from .transform import _as_tensor

__all__ = [
    "fft2",
    "ifft2",
    "fft2_device",
    "ifft2_device",
    "fftn_device",
    "ifftn_device",
    "fftn",
    "ifftn",
    "rfft2",
    "irfft2",
    "rfft2_device",
    "irfft2_device",
    "rfftn",
    "irfftn",
    "rfftn_device",
    "irfftn_device",
    "hfft2",
    "ihfft2",
    "hfftn",
    "ihfftn",
    "hfftn_device",
    "ihfftn_device",
]


def _normalize_axes(ndim: int, axes, name: str) -> tuple:
    """Validate and canonicalize an ``axes`` argument (numpy.fft semantics)."""
    if axes is None:
        return tuple(range(ndim))
    norm = []
    for a in axes:
        if not -ndim <= a < ndim:  # numpy.fft raises too
            raise ValueError(f"{name}: axis {a} out of range for rank {ndim}")
        norm.append(a % ndim)
    if not norm:
        raise ValueError(f"{name}: axes must name at least one axis")
    if len(set(norm)) != len(norm):
        raise ValueError(f"{name}: repeated axes {tuple(axes)}")
    return tuple(norm)


def _check_sides(h: int, w: int) -> None:
    for name, s in (("height", h), ("width", w)):
        if s < 2:
            raise ValueError(f"fft2 {name} must be >= 2, got {s}")
        if s > MAX_N:
            raise ValueError(f"fft2 {name} {s} exceeds the supported maximum {MAX_N}")
        _check_exact_n(s)  # Bluestein bound for non-pow2 sides


def _rows(xr, xi, n: int, sign: int):
    """Length-n transform of (B, n) rows: pow2 direct, otherwise Bluestein."""
    from ..kernels.large import transform_any
    from .exact import _bluestein

    if n & (n - 1) == 0:
        return transform_any(xr, xi, n, sign)
    return _bluestein(xr, xi, n, sign)


def _swap(t, b: int, rows: int, cols: int):
    """(b, rows, cols) -> (b * cols, rows): the transposed rows, contiguous."""
    return t.reshape(b, rows, cols).transpose(1, 2).reshape(b * cols, rows)


def _transform2d(xr, xi, sign: int):
    """Split-complex 2-D transform over the last two axes of (..., H, W)."""
    *lead, h, w = xr.shape
    b = int(np.prod(lead)) if lead else 1
    # Rows: all B*H rows in one batched 1-D transform.
    rr, ri = _rows(xr.reshape(b * h, w), None if xi is None else xi.reshape(b * h, w), w, sign)
    # Columns: in place over axis 0 where the gate opens; otherwise
    # transpose, transform the H-length rows, transpose back.
    if _plan.axis0_applies(h, w):
        sr, si = _fused_torch.transform_axis0(rr.reshape(b, h, w), ri.reshape(b, h, w), h, sign)
        return sr.reshape(*lead, h, w), si.reshape(*lead, h, w)
    sr, si = _rows(_swap(rr, b, h, w), _swap(ri, b, h, w), h, sign)
    return _swap(sr, b, w, h).reshape(*lead, h, w), _swap(si, b, w, h).reshape(*lead, h, w)


def fft2_device(x, imag=None, device=None):
    """Forward 2-D FFT over the last two axes of (..., H, W), on the tensor's
    device.

    ``x`` real f32 (``imag`` for complex input); any side >= 2.  Returns
    split-complex (re, im), unnormalized, natural order — ``numpy.fft.fft2``.
    """
    with span("gft.entry.fft2"):
        x = _as_tensor(x, device)
        if x.dim() < 2:
            raise ValueError(f"fft2 expects (..., H, W), got shape {tuple(x.shape)}")
        _check_sides(x.shape[-2], x.shape[-1])
        xi = None
        if imag is not None:
            xi = _as_tensor(imag, x.device)
            if xi.shape != x.shape:
                raise ValueError(f"fft2: real and imag shapes differ: {tuple(x.shape)} vs {tuple(xi.shape)}")
        return _transform2d(x, xi, -1)


def ifft2_device(xr, xi, device=None):
    """Inverse 2-D FFT (normalized by 1/(H*W)) of split-complex tensors."""
    with span("gft.entry.ifft2"):
        xr = _as_tensor(xr, device)
        xi = _as_tensor(xi, xr.device)
        if xr.shape != xi.shape or xr.dim() < 2:
            raise ValueError(
                f"ifft2: real and imag must share one (..., H, W) shape, got "
                f"{tuple(xr.shape)} vs {tuple(xi.shape)}"
            )
        h, w = xr.shape[-2], xr.shape[-1]
        _check_sides(h, w)
        yr, yi = _transform2d(xr, xi, +1)
        s = float(np.float32(1.0 / (h * w)))
        return yr * s, yi * s


def fftn_device(x, imag=None, axes=None, sign: int = -1, device=None):
    """N-dimensional FFT over ``axes`` (default: all), on the tensor's device.

    ``numpy.fft.fftn`` semantics: split-complex f32, unnormalized forward
    (``sign=-1``) or unnormalized inverse (``sign=+1``; callers apply
    1/prod(sizes)), any axis length >= 2 (non-pow2 via Bluestein).  Each
    axis is moved last and every other element batched into rows: one
    batched transform per axis.
    """
    xr = _as_tensor(x, device)
    xi = None if imag is None else _as_tensor(imag, xr.device)
    if xi is not None and xi.shape != xr.shape:
        raise ValueError(f"fftn: real and imag shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.dim() == 0:
        raise ValueError("fftn expects at least one axis")
    axes = _normalize_axes(xr.dim(), axes, "fftn")
    for a in axes:
        s = xr.shape[a]
        if s < 2:
            raise ValueError(f"fftn axis {a} has length {s} < 2")
        if s > MAX_N:
            raise ValueError(f"fftn axis {a} length {s} exceeds the maximum {MAX_N}")
        _check_exact_n(s)
    for a in axes:
        n = xr.shape[a]
        mr = torch.movedim(xr, a, -1)
        mi = None if xi is None else torch.movedim(xi, a, -1)
        lead = mr.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        rr, ri = _rows(mr.reshape(b, n), None if mi is None else mi.reshape(b, n), n, sign)
        xr = torch.movedim(rr.reshape(*lead, n), -1, a)
        xi = torch.movedim(ri.reshape(*lead, n), -1, a)
    return xr, xi


def ifftn_device(real, imag, axes=None, device=None):
    """N-dimensional inverse FFT on the tensors' device, normalized by the
    product of the transformed axis lengths (``numpy.fft.ifftn``)."""
    xr = _as_tensor(real, device)
    xi = _as_tensor(imag, xr.device)
    yr, yi = fftn_device(xr, xi, axes=axes, sign=+1)  # validates axes
    ax = tuple(range(xr.dim())) if axes is None else tuple(a % xr.dim() for a in axes)
    s = float(np.float32(1.0 / np.prod([xr.shape[a] for a in ax])))
    return yr * s, yi * s


def _host(*ts):
    """Tensors -> numpy arrays (the host forms' outputs)."""
    out = tuple(t.detach().cpu().numpy() for t in ts)
    return out[0] if len(out) == 1 else out


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def fftn(x, axes=None, device=None):
    """Host N-D forward FFT (``numpy.fft.fftn`` semantics)."""
    return _host(*fftn_device(_f32(x), axes=axes, device=device))


def ifftn(real, imag, axes=None, device=None):
    """Host N-D inverse FFT, normalized by the product of the transformed
    axis lengths (``numpy.fft.ifftn`` semantics)."""
    return _host(*ifftn_device(_f32(real), _f32(imag), axes, device=device))


def fft2(x, device=None):
    """Host forward 2-D FFT: numpy in, (re, im) numpy out."""
    return _host(*fft2_device(_f32(x), device=device))


def ifft2(real, imag, device=None):
    """Host inverse 2-D FFT: numpy in, (re, im) numpy out."""
    return _host(*ifft2_device(_f32(real), _f32(imag), device=device))


def rfft2_device(x, device=None):
    """One-sided 2-D FFT of real images: the W//2 + 1 unique column bins.

    ``x``: (H, W) or (B, H, W) real f32 with POWER-OF-TWO sides.  Returns
    split-complex (..., H, W//2 + 1) — ``numpy.fft.rfft2`` semantics (rfft
    over the last axis, full FFT over rows); the column pass runs on half
    the bins.
    """
    from ..kernels.large import transform_any
    from .transform import rfft_device

    x = _as_tensor(x, device)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f"rfft2 expects (H, W) or (B, H, W), got {tuple(x.shape)}")
    b, h, w = x.shape
    for name, s in (("height", h), ("width", w)):
        if s < 2 or s & (s - 1):
            raise ValueError(f"rfft2 {name} must be a power of two >= 2, got {s}")
    hw = w // 2 + 1
    rr, ri = rfft_device(x.reshape(b * h, w))  # rows: (b*h, hw)
    if _plan.axis0_applies(h, hw):
        out_r, out_i = _fused_torch.transform_axis0(rr.reshape(b, h, hw), ri.reshape(b, h, hw), h, -1)
        return (out_r[0], out_i[0]) if squeeze else (out_r, out_i)
    sr, si = transform_any(_swap(rr, b, h, hw), _swap(ri, b, h, hw), h, -1)  # columns: full complex FFT
    out_r = sr.reshape(b, hw, h).transpose(1, 2)
    out_i = si.reshape(b, hw, h).transpose(1, 2)
    return (out_r[0], out_i[0]) if squeeze else (out_r, out_i)


def irfft2_device(xr, xi, device=None):
    """Inverse of :func:`rfft2_device`: real images back, 1/(H*W) normalized.

    ``xr, xi``: (..., H, W//2 + 1) split-complex one-sided spectra of
    power-of-two sides.  ``numpy.fft.irfft2`` semantics (even output width).
    """
    from ..kernels.large import transform_any
    from .transform import irfft_device

    xr = _as_tensor(xr, device)
    xi = _as_tensor(xi, xr.device)
    if xr.shape != xi.shape:
        raise ValueError(f"irfft2: real and imag shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    squeeze = xr.dim() == 2
    if squeeze:
        xr, xi = xr[None], xi[None]
    if xr.dim() != 3:
        raise ValueError(f"irfft2 expects (H, hw) or (B, H, hw), got {tuple(xr.shape)}")
    b, h, hw = xr.shape
    w = 2 * (hw - 1)
    if h < 2 or h & (h - 1) or hw < 2 or w & (w - 1):
        raise ValueError(
            f"irfft2 expects power-of-two sides (H, W//2 + 1 bins), got {tuple(xr.shape[1:])}"
        )
    # Columns first: the inverse complex FFT over H with the 1/H scale in
    # the dispatch's tables (in place over axis 0 where the gate opens).
    if _plan.axis0_applies(h, hw):
        rr3, ri3 = _fused_torch.transform_axis0(xr, xi, h, +1, scale=1.0 / h)
        rr, ri = rr3.reshape(b * h, hw), ri3.reshape(b * h, hw)
    else:
        sr, si = transform_any(_swap(xr, b, h, hw), _swap(xi, b, h, hw), h, +1, scale=1.0 / h)
        rr = _swap(sr, b, hw, h)
        ri = _swap(si, b, hw, h)
    out = irfft_device(rr, ri).reshape(b, h, w)  # rows carry the 1/W scale
    return out[0] if squeeze else out


def rfft2(x, device=None):
    """Host one-sided 2-D FFT; see :func:`rfft2_device`."""
    return _host(*rfft2_device(_f32(x), device=device))


def irfft2(real, imag, device=None):
    """Host inverse of :func:`rfft2`; see :func:`irfft2_device`."""
    return _host(irfft2_device(_f32(real), _f32(imag), device=device))


def rfftn_device(x, axes=None, device=None):
    """One-sided N-D FFT of real input (``numpy.fft.rfftn`` semantics).

    The LAST axis in ``axes`` (default: all axes) carries the real transform
    and shrinks to ``n//2 + 1`` bins: the one-sided dispatch for a power of
    two, the full exact transform sliced otherwise; every other named axis
    gets a full complex FFT of any length >= 2 (non-pow2 via Bluestein).
    Returns split-complex (re, im), unnormalized, on the tensor's device.
    """
    from .transform import rfft_device

    x = _as_tensor(x, device)
    if x.dim() == 0:
        raise ValueError("rfftn expects at least one axis")
    axes = _normalize_axes(x.dim(), axes, "rfftn")
    last = axes[-1]
    w = x.shape[last]
    if w < 2:
        raise ValueError(f"rfftn axis {last} has length {w} < 2")
    if w > MAX_N:
        raise ValueError(f"rfftn axis {last} length {w} exceeds the maximum {MAX_N}")
    _check_exact_n(w)
    hw = w // 2 + 1
    mr = torch.movedim(x, last, -1)
    lead = mr.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    if w & (w - 1) == 0:
        rr, ri = rfft_device(mr.reshape(b, w))
    else:
        rr, ri = _rows(mr.reshape(b, w), None, w, -1)
        rr, ri = rr[..., :hw], ri[..., :hw]
    xr = torch.movedim(rr.reshape(*lead, hw), -1, last)
    xi = torch.movedim(ri.reshape(*lead, hw), -1, last)
    if axes[:-1]:
        xr, xi = fftn_device(xr, xi, axes=axes[:-1], sign=-1)
    return xr, xi


def irfftn_device(real, imag, axes=None, device=None):
    """Inverse of :func:`rfftn_device`: real output back, 1/prod normalized
    (``numpy.fft.irfftn`` semantics, even last-axis output length).

    The LAST named axis holds ``n//2 + 1`` one-sided bins of a POWER-OF-TWO
    n (the real-output dispatch takes it); the other named axes are full
    spectra of any length.
    """
    from .transform import irfft_device

    xr = _as_tensor(real, device)
    xi = _as_tensor(imag, xr.device)
    if xr.shape != xi.shape:
        raise ValueError(f"irfftn: real and imag shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.dim() == 0:
        raise ValueError("irfftn expects at least one axis")
    axes = _normalize_axes(xr.dim(), axes, "irfftn")
    last = axes[-1]
    hw = xr.shape[last]
    w = 2 * (hw - 1)
    if hw < 2 or w & (w - 1):
        raise ValueError(
            f"irfftn: last axis must hold n//2 + 1 bins of a power-of-two n, got {hw} bins"
        )
    rest = axes[:-1]
    if rest:
        # The unnormalized inverse over the complex axes; their 1/prod scale
        # on the half-width spectrum.
        xr, xi = fftn_device(xr, xi, axes=rest, sign=+1)
        s = float(np.float32(1.0 / np.prod([xr.shape[a] for a in rest])))
        xr, xi = xr * s, xi * s
    mr = torch.movedim(xr, last, -1)
    mi = torch.movedim(xi, last, -1)
    lead = mr.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    out = irfft_device(mr.reshape(b, hw), mi.reshape(b, hw))  # carries 1/w
    return torch.movedim(out.reshape(*lead, w), -1, last)


def rfftn(x, axes=None, device=None):
    """Host one-sided N-D FFT; see :func:`rfftn_device`."""
    return _host(*rfftn_device(_f32(x), axes=axes, device=device))


def irfftn(real, imag, axes=None, device=None):
    """Host inverse of :func:`rfftn`; see :func:`irfftn_device`."""
    return _host(irfftn_device(_f32(real), _f32(imag), axes=axes, device=device))


def hfftn_device(real, imag, axes=None, device=None):
    """N-D FFT of a Hermitian-symmetric signal -> REAL spectrum
    (``scipy.fft.hfftn`` semantics, even last-axis output length).

    ``real, imag``: the ``n//2 + 1`` unique last-axis samples (power-of-two
    n), full complex samples on the other named axes.  Computed as
    ``irfftn(conj(a)) * prod(n)``, so it rides the real-output dispatch.
    """
    xr = _as_tensor(real, device)
    xi = _as_tensor(imag, xr.device)
    if xr.shape != xi.shape:
        raise ValueError(f"hfftn: real and imag shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.dim() == 0:
        raise ValueError("hfftn expects at least one axis")
    naxes = _normalize_axes(xr.dim(), axes, "hfftn")
    last = naxes[-1]
    hw = xr.shape[last]
    w = 2 * (hw - 1)
    if hw < 2 or w & (w - 1):
        raise ValueError(
            f"hfftn: last axis must hold n//2 + 1 samples of a power-of-two n, got {hw} samples"
        )
    prod = float(w) * float(np.prod([xr.shape[a] for a in naxes[:-1]] or [1.0]))
    out = irfftn_device(xr, -xi, axes=naxes)
    return out * float(np.float32(prod))


def ihfftn_device(x, axes=None, device=None):
    """Inverse of :func:`hfftn_device`: real spectrum -> the one-sided
    Hermitian signal (``scipy.fft.ihfftn``: ``conj(rfftn(x)) / prod(n)``)."""
    x = _as_tensor(x, device)
    if x.dim() == 0:
        raise ValueError("ihfftn expects at least one axis")
    naxes = _normalize_axes(x.dim(), axes, "ihfftn")
    w = x.shape[naxes[-1]]
    if w < 2 or w & (w - 1):
        raise ValueError(f"ihfftn: last axis length {w} is not a power of two >= 2")
    rr, ri = rfftn_device(x, axes=naxes)
    s = float(np.float32(1.0 / np.prod([x.shape[a] for a in naxes])))
    return rr * s, -(ri * s)


def hfft2(real, imag, axes=(-2, -1), device=None):
    """2-D Hermitian-input FFT (``scipy.fft.hfft2``); see :func:`hfftn_device`."""
    return _host(hfftn_device(_f32(real), _f32(imag), axes=axes, device=device))


def ihfft2(x, axes=(-2, -1), device=None):
    """2-D inverse of :func:`hfft2` (``scipy.fft.ihfft2``); see :func:`ihfftn_device`."""
    return _host(*ihfftn_device(_f32(x), axes=axes, device=device))


def hfftn(real, imag, axes=None, device=None):
    """Host N-D Hermitian-input FFT; see :func:`hfftn_device`."""
    return _host(hfftn_device(_f32(real), _f32(imag), axes=axes, device=device))


def ihfftn(x, axes=None, device=None):
    """Host inverse of :func:`hfftn`; see :func:`ihfftn_device`."""
    return _host(*ihfftn_device(_f32(x), axes=axes, device=device))
