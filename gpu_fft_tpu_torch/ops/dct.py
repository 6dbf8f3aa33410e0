"""Discrete cosine / sine transforms (types I-IV) via the FFT path.

Port of ``gpu_fft_tpu/ops/dct.py``.  DCT-II ("the DCT") is Makhoul's
reduction: permute the signal into even-index samples ascending followed by
odd-index samples descending, take ONE same-length transform (the exact
transforms of ``ops/exact.py``: the dispatch for a power of two, the mixed
four-step or Bluestein otherwise), and rotate each bin by
e^{-i*pi*k/(2n)}.  DCT-III inverts that factorization through the
real-output inverse (``kernels/large.py:inverse_real``) at power-of-two n.
The DSTs ride the classic index/sign identities to the DCT cores:

    DST-II(x)[k]  = DCT-II(x~)[n-1-k],   x~[j] = (-1)^j x[j]
    DST-III(y)[k] = (-1)^k DCT-III(y~)[k],  y~[j] = y[n-1-j]

The Makhoul permutation is strided slices, a flip and an interleaving
``stack`` here at every n; the JAX package runs it at power-of-two
n >= 256 as a 0/1 permutation matmul and a tile reversal, workarounds for
a TPU's lane shuffles.  Conventions match ``scipy.fft.dct`` / ``dst``
(types 1-4, ``norm=None`` and ``norm='ortho'``).  The host API takes numpy
and returns numpy and runs on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..plan import on_device
from .transform import _as_tensor

__all__ = [
    "dct",
    "dct_device",
    "dctn",
    "dctn_device",
    "dst",
    "dst_device",
    "dstn",
    "dstn_device",
    "idct",
    "idct_device",
    "idctn",
    "idctn_device",
    "idst",
    "idst_device",
    "idstn",
    "idstn_device",
]


@functools.lru_cache(maxsize=None)
def _rotation(n: int) -> dict:
    """cos/sin of pi*k/(2n), k = 0..n-1, f64-generated f32 tables."""
    ang = np.pi * np.arange(n, dtype=np.float64) / (2.0 * n)
    return {"cos": np.cos(ang).astype(np.float32), "sin": np.sin(ang).astype(np.float32)}


def _makhoul_permute(x):
    """v = [x[0::2] | reversed(x[1::2])] along the last axis."""
    return torch.cat([x[:, 0::2], x[:, 1::2].flip(-1)], dim=-1)


def _makhoul_unpermute(v):
    """Inverse of :func:`_makhoul_permute`: x[0::2] = v[:h], x[1::2] =
    reversed(v[h:]), an interleaving stack."""
    b, n = v.shape
    h = (n + 1) // 2  # even-index count
    a = v[:, :h]
    rev = v[:, h:].flip(-1)  # odd positions, ascending (n // 2 of them)
    if n % 2 == 0:
        return torch.stack([a, rev], dim=-1).reshape(b, n)
    body = torch.stack([a[:, : h - 1], rev], dim=-1).reshape(b, n - 1)
    return torch.cat([body, a[:, h - 1 :]], dim=-1)


def _dct2_core(x):
    """Unnormalized DCT-II of (B, n) f32 rows: 2*sum x_j cos(pi*k*(2j+1)/2n)."""
    from .exact import fft_exact_device

    n = x.shape[-1]
    vr, vi = fft_exact_device(_makhoul_permute(x))
    rot = on_device(_rotation, n, device=x.device)
    c, s = rot["cos"], rot["sin"]
    # X_k = 2 * Re(e^{-i*pi*k/2n} V_k)
    return 2.0 * (vr * c + vi * s)


def _dct3_core(y):
    """Unnormalized DCT-III of (B, n) f32 rows: y_0 + 2*sum_{j>=1} y_j cos(pi*j*(2k+1)/2n).

    Inverts the Makhoul factorization: V_k = (e^{i*pi*k/2n}/2)(y_k - i*y_{n-k})
    (with y_n := 0) is Hermitian for real y, so IFFT(V) is real; un-permuting
    and scaling by 2n gives DCT-III.
    """
    n = y.shape[-1]
    t = torch.cat([torch.zeros_like(y[:, :1]), y[:, 1:].flip(-1)], dim=-1)  # t_k = y_{n-k}, t_0 = 0
    rot = on_device(_rotation, n, device=y.device)
    c, s = rot["cos"], rot["sin"]
    vr = 0.5 * (y * c + t * s)
    vi = 0.5 * (y * s - t * c)
    if n >= 2 and n & (n - 1) == 0:
        # V is Hermitian (real DCT-III output): the real-output inverse.
        from ..kernels.large import inverse_real

        xr = inverse_real(vr, vi, n, scale=1.0 / n)
    else:
        from .exact import ifft_exact_device

        xr, _ = ifft_exact_device(vr, vi)
    return (2.0 * n) * _makhoul_unpermute(xr)


@functools.lru_cache(maxsize=None)
def _quarter_rotation(n: int) -> dict:
    """Pre/post twiddles of the type-IV reduction, f64-generated f32:
    (cos, sin) of pi*j/(2n) (pre) and of pi*(2k+1)/(4n) (post)."""
    j = np.arange(n, dtype=np.float64)
    pre = np.pi * j / (2.0 * n)
    post = np.pi * (2.0 * j + 1.0) / (4.0 * n)
    return {
        "pre_cos": np.cos(pre).astype(np.float32),
        "pre_sin": np.sin(pre).astype(np.float32),
        "post_cos": np.cos(post).astype(np.float32),
        "post_sin": np.sin(post).astype(np.float32),
    }


def _type4_spectrum(x):
    """U_k = first n bins of FFT_2n([x_j * e^{-i*pi*j/(2n)}, 0]) and the post
    twiddle tables.

    The shared core of DCT-IV and DST-IV: with w = e^{-i*pi/(4n)},
    (2j+1)(2k+1) = 4jk + 2j + 2k + 1 factorizes the quarter-shifted
    cosine/sine into one zero-padded length-2n complex transform and two
    diagonal twiddles.
    """
    from .exact import fft_exact_device

    n = x.shape[-1]
    q = on_device(_quarter_rotation, n, device=x.device)
    ur, ui = fft_exact_device(F.pad(x * q["pre_cos"], (0, n)), F.pad(-x * q["pre_sin"], (0, n)))
    return ur[:, :n], ui[:, :n], q["post_cos"], q["post_sin"]


def _dct1_core(x):
    """Unnormalized DCT-I of (B, n>=2) rows: the real part of the transform
    of the even extension [x_0..x_{n-1}, x_{n-2}..x_1] (length 2n-2)."""
    from .exact import fft_exact_device

    yr, _ = fft_exact_device(torch.cat([x, x[:, 1:-1].flip(-1)], dim=-1))
    return yr[:, : x.shape[-1]]


def _dst1_core(x):
    """Unnormalized DST-I of (B, n) rows: minus the imaginary part of the
    transform of the odd extension [0, x, 0, -reversed(x)] (length 2n+2)."""
    from .exact import fft_exact_device

    z = x.new_zeros(x.shape[0], 1)
    _, yi = fft_exact_device(torch.cat([z, x, z, -x.flip(-1)], dim=-1))
    return -yi[:, 1 : x.shape[-1] + 1]


def _as_rows(x, name: str, device=None):
    x = _as_tensor(x, device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or x.shape[-1] < 1:
        raise ValueError(f"{name} expects non-empty 1-D or (B, n) input, got shape {tuple(x.shape)}")
    return x, squeeze


def _check_type_norm(type: int, norm, name: str) -> None:
    if type not in (1, 2, 3, 4):
        raise ValueError(f"{name} supports types 1-4, got {type}")
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")


@functools.lru_cache(maxsize=None)
def _gain_rows(n: int) -> dict:
    """The f32 gain rows of the orthonormal scalings and the DST sign
    alternation at length n (tensors on a device through ``on_device``, so
    a captured step uploads nothing)."""
    rows = {}
    f = np.full(n, np.sqrt(1.0 / (2.0 * n)), dtype=np.float32)
    rows["dct2"], rows["dct3"], rows["dst2"], rows["dst3"] = f.copy(), f.copy(), f.copy(), f.copy()
    rows["dct2"][0] = np.sqrt(1.0 / (4.0 * n))
    rows["dct3"][0] = np.sqrt(1.0 / n)
    rows["dst2"][-1] = np.sqrt(1.0 / (4.0 * n))
    rows["dst3"][-1] = np.sqrt(1.0 / n)
    rows["alt"] = np.resize(np.array([1.0, -1.0], dtype=np.float32), n)
    if n >= 2:
        # Orthonormal DCT-I: Mo = diag(c_k) Mr diag(c_j / e_j) sqrt(2/(n-1))
        # with c = 1/sqrt(2) at the endpoints (else 1) and e = the raw
        # kernel's endpoint weight (1 at the ends, 2 interior).
        r2 = np.float32(1.0 / np.sqrt(2.0))
        gin = np.full(n, 0.5 * np.sqrt(2.0 / (n - 1.0)), dtype=np.float32)
        gin[0] = gin[-1] = np.float32(r2 * np.sqrt(2.0 / (n - 1.0)))
        gout = np.ones(n, dtype=np.float32)
        gout[0] = gout[-1] = r2
        rows["dct1_in"], rows["dct1_out"] = gin, gout
    return rows


def dct_device(x, type: int = 2, norm: str | None = None, device=None):
    """DCT of real rows on the tensor's device (``scipy.fft.dct`` types 1-4).

    ``x``: (n,) or (B, n) f32, any length.  ``norm=None`` is the unnormalized
    convention; ``norm='ortho'`` makes the transform orthonormal (type 3 is
    then exactly the inverse of type 2).
    """
    _check_type_norm(type, norm, "dct")
    x, squeeze = _as_rows(x, "dct", device)
    n = x.shape[-1]
    if type == 1:
        if n < 2:
            raise ValueError("dct type 1 requires n >= 2")
        if norm == "ortho":
            g = on_device(_gain_rows, n, device=x.device)
            y = _dct1_core(x * g["dct1_in"]) * g["dct1_out"]
        else:
            y = _dct1_core(x)
        return y[0] if squeeze else y
    if type == 4:
        ur, ui, tc, ts = _type4_spectrum(x)
        y = 2.0 * (ur * tc + ui * ts)
        if norm == "ortho":
            y = y * float(np.float32(np.sqrt(1.0 / (2.0 * n))))
        return y[0] if squeeze else y
    if type == 2:
        y = _dct2_core(x)
        if norm == "ortho":
            y = y * on_device(_gain_rows, n, device=x.device)["dct2"]
    else:
        if norm == "ortho":
            x = x * on_device(_gain_rows, n, device=x.device)["dct3"]
        y = _dct3_core(x)
    return y[0] if squeeze else y


def idct_device(y, type: int = 2, norm: str | None = None, device=None):
    """Inverse DCT: ``idct(dct(x, type, norm), type, norm) == x``."""
    _check_type_norm(type, norm, "idct")
    inv_type = type if type in (1, 4) else 5 - type  # I/IV self-inverse, 2 <-> 3
    out = dct_device(y, type=inv_type, norm=norm, device=device)
    if norm is None:
        n = out.shape[-1]
        denom = 2.0 * (n - 1.0) if type == 1 else 2.0 * n
        out = out * float(np.float32(1.0 / denom))
    return out


def dst_device(x, type: int = 2, norm: str | None = None, device=None):
    """DST of real rows on the tensor's device (``scipy.fft.dst`` types 1-4)."""
    _check_type_norm(type, norm, "dst")
    x, squeeze = _as_rows(x, "dst", device)
    n = x.shape[-1]
    if type == 1:
        y = _dst1_core(x)
        if norm == "ortho":
            y = y * float(np.float32(np.sqrt(1.0 / (2.0 * (n + 1.0)))))
        return y[0] if squeeze else y
    if type == 4:
        ur, ui, tc, ts = _type4_spectrum(x)
        y = 2.0 * (ur * ts - ui * tc)
        if norm == "ortho":
            y = y * float(np.float32(np.sqrt(1.0 / (2.0 * n))))
        return y[0] if squeeze else y
    g = on_device(_gain_rows, n, device=x.device)
    if type == 2:
        y = _dct2_core(x * g["alt"]).flip(-1)
        if norm == "ortho":
            y = y * g["dst2"]
    else:
        if norm == "ortho":
            x = x * g["dst3"]
        y = _dct3_core(x.flip(-1)) * g["alt"]
    return y[0] if squeeze else y


def idst_device(y, type: int = 2, norm: str | None = None, device=None):
    """Inverse DST: ``idst(dst(x, type, norm), type, norm) == x``."""
    _check_type_norm(type, norm, "idst")
    inv_type = type if type in (1, 4) else 5 - type
    out = dst_device(y, type=inv_type, norm=norm, device=device)
    if norm is None:
        n = out.shape[-1]
        denom = 2.0 * (n + 1.0) if type == 1 else 2.0 * n
        out = out * float(np.float32(1.0 / denom))
    return out


def _host(fn, x, type, norm, device, *extra):
    return fn(np.asarray(x, dtype=np.float32), type, norm, *extra, device=device).cpu().numpy()


def dct(x, type: int = 2, norm: str | None = None, device=None):
    """Host-convenience DCT; see :func:`dct_device`.  Numpy in and out."""
    return _host(dct_device, x, type, norm, device)


def idct(y, type: int = 2, norm: str | None = None, device=None):
    """Host-convenience inverse DCT; see :func:`idct_device`."""
    return _host(idct_device, y, type, norm, device)


def dst(x, type: int = 2, norm: str | None = None, device=None):
    """Host-convenience DST; see :func:`dst_device`."""
    return _host(dst_device, x, type, norm, device)


def idst(y, type: int = 2, norm: str | None = None, device=None):
    """Host-convenience inverse DST; see :func:`idst_device`."""
    return _host(idst_device, y, type, norm, device)


def _along_axes(x, axes, fn):
    """Apply a (B, n)-rows transform along each of ``axes`` of an N-D tensor."""
    for a in axes:
        n = x.shape[a]
        moved = x.movedim(a, -1)
        lead = moved.shape[:-1]
        rows = fn(moved.reshape(-1, n))
        x = rows.reshape(*lead, n).movedim(-1, a)
    return x


def _norm_axes(x, axes, name):
    if axes is None:
        return tuple(range(x.ndim))
    out = []
    for a in axes:
        if not -x.ndim <= a < x.ndim:
            raise ValueError(f"{name}: axis {a} out of range for rank {x.ndim}")
        out.append(a % x.ndim)
    if not out:
        raise ValueError(f"{name}: axes must name at least one axis")
    if len(set(out)) != len(out):
        raise ValueError(f"{name}: repeated axes {tuple(axes)}")
    return tuple(out)


def _nd(name: str, row_fn, x, type, norm, axes, device):
    _check_type_norm(type, norm, name)
    x = _as_tensor(x, device)
    if x.dim() == 0:
        raise ValueError(f"{name} expects at least one axis")
    axes = _norm_axes(x, axes, name)
    return _along_axes(x, axes, lambda r: row_fn(r, type=type, norm=norm))


def dctn_device(x, type: int = 2, norm: str | None = None, axes=None, device=None):
    """N-dimensional DCT over ``axes`` (default: all), on the tensor's device
    (``scipy.fft.dctn``: the 1-D DCT applied separably along each axis)."""
    return _nd("dctn", dct_device, x, type, norm, axes, device)


def idctn_device(y, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Inverse N-D DCT: ``idctn(dctn(x)) == x`` (``scipy.fft.idctn``)."""
    return _nd("idctn", idct_device, y, type, norm, axes, device)


def dstn_device(x, type: int = 2, norm: str | None = None, axes=None, device=None):
    """N-dimensional DST over ``axes`` (``scipy.fft.dstn``)."""
    return _nd("dstn", dst_device, x, type, norm, axes, device)


def idstn_device(y, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Inverse N-D DST: ``idstn(dstn(x)) == x`` (``scipy.fft.idstn``)."""
    return _nd("idstn", idst_device, y, type, norm, axes, device)


def dctn(x, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Host-convenience N-D DCT; see :func:`dctn_device`."""
    return _host(dctn_device, x, type, norm, device, axes)


def idctn(y, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Host-convenience inverse N-D DCT; see :func:`idctn_device`."""
    return _host(idctn_device, y, type, norm, device, axes)


def dstn(x, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Host-convenience N-D DST; see :func:`dstn_device`."""
    return _host(dstn_device, x, type, norm, device, axes)


def idstn(y, type: int = 2, norm: str | None = None, axes=None, device=None):
    """Host-convenience inverse N-D DST; see :func:`idstn_device`."""
    return _host(idstn_device, y, type, norm, device, axes)
