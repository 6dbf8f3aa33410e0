"""Pencil- and slab-decomposed 2-D / 3-D FFTs: one image or volume too large
for a card, its leading axis sharded.

Port of ``gpu_fft_tpu/parallel/pencil.py``.  The (H, W) image lives
ROW-sharded over the mesh axis ``sp``, so

  1. each rank transforms its own rows (length-W FFTs, all local),
  2. one all-to-all re-shards to a COLUMN-sharded pencil (the distributed
     transpose),
  3. each rank transforms its own columns (length-H FFTs, local),
  4. a second all-to-all restores the row-sharded layout.

A (D, H, W) volume is D-sharded (slab): the (H, W) passes are local and only
the D pass needs an all-to-all each way.  Each local pass runs the
single-card dispatch, ``kernels/large.py:transform_any``, and each
all-to-all is one ``all_to_all_single`` per real and imaginary part.
Inputs and outputs are DTensors (a plain tensor or numpy array is the
global array every rank holds); the outputs keep the input's row or slab
sharding.
"""

from __future__ import annotations

from ..kernels.large import transform_any
from . import _sharding as S

__all__ = ["fft2_sharded", "ifft2_sharded", "fftn_sharded", "ifftn_sharded"]


def _check_dims(h: int, w: int, d: int) -> None:
    for name, n in (("H", h), ("W", w)):
        if n < 2 or n & (n - 1):
            raise ValueError(f"fft2_sharded requires power-of-two {name}, got {n}")
    if h % d or w % d:
        raise ValueError(
            f"fft2_sharded requires the mesh axis size {d} to divide both "
            f"H={h} and W={w}"
        )
    if h // d < 1 or w // d < 1:
        raise ValueError(f"image {h}x{w} too small for a {d}-device pencil split")


def _pencil(lr, li, h: int, w: int, sign: int, mesh, sp: str, scale):
    """The local pipeline over this rank's (B_local, H/d, W) rows (``li``
    may be None)."""
    bl, hd, _ = lr.shape
    # 1. Row FFTs (length W), all rows of this shard in one call.
    rr, ri = transform_any(lr.reshape(bl * hd, w), None if li is None else li.reshape(bl * hd, w), w, sign)
    # 2. Distributed transpose: (B, H/d, W) -> (B, H, W/d); the pieces come
    #    back in rank order = global row order.
    rr = S.all_to_all(rr.reshape(bl, hd, w), mesh, sp, 2, 1)
    ri = S.all_to_all(ri.reshape(bl, hd, w), mesh, sp, 2, 1)
    # 3. Column FFTs (length H): make H minor, transform, restore.
    wd = rr.shape[2]
    cr, ci = transform_any(rr.transpose(1, 2).reshape(bl * wd, h), ri.transpose(1, 2).reshape(bl * wd, h), h, sign)
    if scale is not None:
        cr, ci = cr * scale, ci * scale
    cr = cr.reshape(bl, wd, h).transpose(1, 2)
    ci = ci.reshape(bl, wd, h).transpose(1, 2)
    # 4. Back to the row-sharded layout: (B, H, W/d) -> (B, H/d, W).
    return S.all_to_all(cr, mesh, sp, 1, 2), S.all_to_all(ci, mesh, sp, 1, 2)


def _run2d(xr, xi, mesh, sign: int, sp: str, dp, scale=None):
    squeeze = xr.dim() == 2
    if squeeze:
        xr = xr.unsqueeze(0)
        xi = None if xi is None else xi.unsqueeze(0)
    if xr.dim() != 3:
        raise ValueError(f"fft2_sharded expects (H, W) or (B, H, W), got {tuple(xr.shape)}")
    b, h, w = xr.shape
    d = S.axis_size(mesh, sp)
    _check_dims(h, w, d)
    if dp is not None and b % S.axis_size(mesh, dp):
        raise ValueError(
            f"batch {b} not divisible by mesh axis '{dp}' size {S.axis_size(mesh, dp)}"
        )
    places = S.placements(mesh, {dp: 0, sp: 1})
    lr = S.to_local(xr, mesh, places)
    li = None if xi is None else S.to_local(xi, mesh, places)
    yr, yi = _pencil(lr, li, h, w, sign, mesh, sp, scale)
    if squeeze:
        places = S.placements(mesh, {sp: 0})
        return S.from_local(yr[0], mesh, places, (h, w)), S.from_local(yi[0], mesh, places, (h, w))
    return S.from_local(yr, mesh, places, (b, h, w)), S.from_local(yi, mesh, places, (b, h, w))


def fft2_sharded(x, mesh, sp_axis: str = "sp", dp_axis: str | None = None, imag=None):
    """2-D FFT of a single large image with its ROWS sharded over the mesh.

    ``x``: (H, W) or (B, H, W) f32, power-of-two H and W both divisible by
    the ``sp_axis`` size; ``imag`` optionally supplies a complex input's
    imaginary part.  Optional ``dp_axis`` additionally shards the batch.
    Returns split-complex DTensors, row-sharded, natural order —
    ``numpy.fft.fft2`` semantics.
    """
    x = S.global_tensor(x, mesh)
    xi = None if imag is None else S.global_tensor(imag, mesh)
    if xi is not None and xi.shape != x.shape:
        raise ValueError(f"fft2_sharded: real and imag shapes differ: {tuple(x.shape)} vs {tuple(xi.shape)}")
    return _run2d(x, xi, mesh, -1, sp_axis, dp_axis)


def ifft2_sharded(xr, xi, mesh, sp_axis: str = "sp", dp_axis: str | None = None):
    """Inverse 2-D FFT (1/(H*W) normalized) of a row-sharded split-complex
    image — the inverse of :func:`fft2_sharded`."""
    xr = S.global_tensor(xr, mesh)
    xi = S.global_tensor(xi, mesh)
    if xr.shape != xi.shape:
        raise ValueError(f"ifft2_sharded: shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    return _run2d(xr, xi, mesh, +1, sp_axis, dp_axis, scale=1.0 / (xr.shape[-1] * xr.shape[-2]))


# ── 3-D volumes: slab decomposition ──────────────────────────────────────────


def _slab(xr, xi, d0: int, h: int, w: int, sign: int, mesh, sp: str, scale=None):
    """The pipeline over a (D, H, W) global volume sharded on D (``xi`` may be
    None).  Each rank holds complete (H, W) planes, so two of the three
    passes are entirely local; only the D-axis pass needs the all-to-all."""
    places = S.placements(mesh, {sp: 0})
    lr = S.to_local(xr, mesh, places)
    li = None if xi is None else S.to_local(xi, mesh, places)
    dd = lr.shape[0]  # D/d
    # 1. W-axis FFTs: every plane row local.
    rr, ri = transform_any(lr.reshape(dd * h, w), None if li is None else li.reshape(dd * h, w), w, sign)
    # 2. H-axis FFTs: make H minor, transform, restore.
    cr, ci = transform_any(rr.reshape(dd, h, w).transpose(1, 2).reshape(dd * w, h),
                           ri.reshape(dd, h, w).transpose(1, 2).reshape(dd * w, h), h, sign)
    rr = cr.reshape(dd, w, h).transpose(1, 2)
    ri = ci.reshape(dd, w, h).transpose(1, 2)
    # 3. D-axis FFTs: reshard (D/d, H, W) -> (D, H/d, W), transform the
    #    now-local D axis, reshard back.
    rr = S.all_to_all(rr, mesh, sp, 1, 0)
    ri = S.all_to_all(ri, mesh, sp, 1, 0)
    hd = rr.shape[1]
    dr, di = transform_any(rr.movedim(0, 2).reshape(hd * w, d0), ri.movedim(0, 2).reshape(hd * w, d0), d0, sign)
    if scale is not None:
        dr, di = dr * scale, di * scale
    rr = S.all_to_all(dr.reshape(hd, w, d0).movedim(2, 0), mesh, sp, 0, 1)
    ri = S.all_to_all(di.reshape(hd, w, d0).movedim(2, 0), mesh, sp, 0, 1)
    return S.from_local(rr, mesh, places, (d0, h, w)), S.from_local(ri, mesh, places, (d0, h, w))


def fftn_sharded(x, mesh, sp_axis: str = "sp", imag=None):
    """3-D FFT of a volume with its LEADING axis sharded (slab decomposition).

    ``x``: (D, H, W) f32, power-of-two dims, D and H divisible by the mesh
    axis size.  The in-plane (H, W) passes are entirely local; the D-axis
    pass reshards with one all-to-all each way.  Returns split-complex
    DTensors, D-sharded, natural order — ``numpy.fft.fftn`` semantics over
    all three axes.
    """
    x = S.global_tensor(x, mesh)
    xi = None if imag is None else S.global_tensor(imag, mesh)
    if x.dim() != 3:
        raise ValueError(f"fftn_sharded expects a (D, H, W) volume, got {tuple(x.shape)}")
    if xi is not None and xi.shape != x.shape:
        raise ValueError(f"fftn_sharded: real and imag shapes differ: {tuple(x.shape)} vs {tuple(xi.shape)}")
    d0, h, w = x.shape
    d = S.axis_size(mesh, sp_axis)
    _check_dims(h, w, d)
    if d0 < 2 or d0 & (d0 - 1):
        raise ValueError(f"fftn_sharded requires power-of-two D, got {d0}")
    if d0 % d or h % d:
        raise ValueError(
            f"fftn_sharded requires the mesh axis size {d} to divide D={d0} and H={h}"
        )
    return _slab(x, xi, d0, h, w, -1, mesh, sp_axis)


def ifftn_sharded(xr, xi, mesh, sp_axis: str = "sp"):
    """Inverse 3-D FFT (1/(D*H*W) normalized) of a D-sharded split-complex
    volume — the inverse of :func:`fftn_sharded`."""
    xr = S.global_tensor(xr, mesh)
    xi = S.global_tensor(xi, mesh)
    if xr.shape != xi.shape:
        raise ValueError(f"ifftn_sharded: shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.dim() != 3:
        raise ValueError(f"ifftn_sharded expects a (D, H, W) volume, got {tuple(xr.shape)}")
    d0, h, w = xr.shape
    d = S.axis_size(mesh, sp_axis)
    _check_dims(h, w, d)
    if d0 < 2 or d0 & (d0 - 1) or d0 % d or h % d:
        raise ValueError(
            f"ifftn_sharded requires power-of-two dims with {d} | D and {d} | H, "
            f"got {tuple(xr.shape)}"
        )
    return _slab(xr, xi, d0, h, w, +1, mesh, sp_axis, scale=1.0 / (d0 * h * w))
