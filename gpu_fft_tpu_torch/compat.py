"""scipy.fft-compatible namespace: complex arrays in, complex arrays out.

Port of ``gpu_fft_tpu/compat.py``.  The library's native API uses
split-complex ``(re, im)`` f32 pairs; this module wraps the same dispatches
in the call signatures of ``scipy.fft`` so existing code can switch by
changing one import::

    import gpu_fft_tpu_torch.compat as fft   # instead of scipy.fft
    X = fft.fft(x)                           # complex64, any length, any axis

or, with no code changes at all, through scipy's backend protocol::

    import scipy.fft
    with scipy.fft.set_backend(gpu_fft_tpu_torch.compat.backend):
        X = scipy.fft.fft(x)                 # runs on this library's paths

Semantics follow ``scipy.fft``: ``n``/``s`` crop or zero-pad,
``axis``/``axes`` select, ``norm`` is one of ``"backward"`` (default),
``"ortho"``, ``"forward"``.  Transforms of ANY length are exact (powers of
two ride the dispatch — K2 at 1,024, K1 at 2,048 … 16,384 for one row, K3
staged above 65,536 — other lengths the mixed four-step or Bluestein,
never silently padded).  Compute is single precision: float32 in,
complex64 / float32 out; ``overwrite_x``, ``workers`` and ``plan`` are
accepted and ignored.

A ``torch.Tensor`` input gives a tensor out, on the input's device, and
autograd runs through it.  Anything else is computed on
``config.resolve_device(device)`` (default ``"cuda"``, or
``GPU_FFT_TPU_TORCH_DEVICE``) and comes back as numpy, as scipy returns it.
Every function takes a keyword-only ``device`` after scipy's arguments; the
uarray path passes scipy's arguments only.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .config import resolve_device
from .ops import dct as _dct_ops
from .ops.dsp import (  # re-exported helpers, already scipy-compatible
    fftfreq,
    fftshift,
    ifftshift,
    next_fast_len,
    prev_fast_len,
    rfftfreq,
)
from .ops.exact import fft_exact_device, ifft_exact_device
from .ops.fht import fht, fhtoffset, ifht  # already scipy signatures
from .ops.transform import irfft_device, rfft_device

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "fht", "ifht", "fhtoffset",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
    "next_fast_len", "prev_fast_len",
    "backend",
]


def _check_norm(norm) -> str:
    if norm is None:
        return "backward"
    if norm in ("backward", "ortho", "forward"):
        return norm
    raise ValueError(f"invalid norm value {norm!r}; must be 'backward', 'ortho' or 'forward'")


def _fwd_scale(norm: str, n: int) -> float:
    return {"backward": 1.0, "ortho": 1.0 / np.sqrt(n), "forward": 1.0 / n}[norm]


def _inv_scale(norm: str, n: int) -> float:
    # on top of the library's inverse, which already divides by n
    return {"backward": 1.0, "ortho": np.sqrt(n), "forward": float(n)}[norm]


def _scaled(t, s: float):
    return t * float(s) if s != 1.0 else t


# ── tensors in, the caller's kind out ────────────────────────────────────────


def _in(x, device):
    """``x`` as a tensor (complex64 or float32) and whether it was one: a
    tensor keeps its device unless ``device`` is given, anything else goes
    to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(resolve_device(device))
        return t.to(torch.complex64 if t.is_complex() else torch.float32), True
    a = np.asarray(x)
    dt = np.complex64 if np.iscomplexobj(a) else np.float32
    # contiguous: torch refuses numpy's negative strides (a reversed view).
    return torch.as_tensor(np.ascontiguousarray(a, dtype=dt), device=resolve_device(device)), False


def _out(t, as_tensor: bool):
    return t if as_tensor else t.detach().cpu().numpy()


def _split(t):
    """(f32 real part, f32 imaginary part or None), both contiguous."""
    if t.is_complex():
        return t.real.contiguous(), t.imag.contiguous()
    return t.contiguous(), None


def _conj(t):
    """Complex conjugate as a materialized complex64 tensor (real input as
    complex with a zero imaginary part)."""
    re, im = _split(t)
    return torch.complex(re, torch.zeros_like(re) if im is None else -im)


def _fit(x, n: int | None, axis: int):
    """Crop or zero-pad along ``axis`` to length ``n`` (scipy semantics)."""
    if n is None:
        return x
    if n < 1:
        raise ValueError(f"invalid number of data points ({n}) specified")
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        return x.narrow(axis, 0, n)
    pad = list(x.shape)
    pad[axis] = n - cur
    return torch.cat([x, x.new_zeros(pad)], dim=axis)


def _to_rows(x, axis: int):
    """Move ``axis`` last and flatten to contiguous (B, n); returns (rows,
    restore)."""
    x = x.movedim(axis, -1)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).contiguous()

    def restore(y):
        return y.reshape(*lead, y.shape[-1]).movedim(-1, axis)

    return rows, restore


def _norm_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of bounds for array of dimension {ndim}")
    return axis % ndim


def _axis_len(x, axis: int) -> int:
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)
    return shape[_norm_axis(axis, max(len(shape), 1))]


# ── 1-D complex transforms ───────────────────────────────────────────────────


def _fft(t, n, axis, norm, inverse: bool):
    norm = _check_norm(norm)
    name = "ifft" if inverse else "fft"
    if t.dim() == 0:
        raise ValueError(f"{name} expects at least a 1-D signal")
    axis = _norm_axis(axis, t.dim())
    xr, xi = _split(t)
    if inverse and xi is None:
        xi = torch.zeros_like(xr)
    xr = _fit(xr, n, axis)
    xi = _fit(xi, n, axis) if xi is not None else None
    m = xr.shape[axis]
    rows, restore = _to_rows(xr, axis)
    irows = _to_rows(xi, axis)[0] if xi is not None else None
    if inverse:
        yr, yi = ifft_exact_device(rows, irows)
        s = _inv_scale(norm, m)
    else:
        yr, yi = fft_exact_device(rows, irows)
        s = _fwd_scale(norm, m)
    return _scaled(restore(torch.complex(yr, yi)), s)


def fft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Exact n-point DFT along ``axis`` — ``scipy.fft.fft`` semantics, complex64."""
    t, as_tensor = _in(x, device)
    return _out(_fft(t, n, axis, norm, inverse=False), as_tensor)


def ifft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Exact n-point inverse DFT along ``axis`` — ``scipy.fft.ifft`` semantics."""
    t, as_tensor = _in(x, device)
    return _out(_fft(t, n, axis, norm, inverse=True), as_tensor)


# ── 1-D real / Hermitian transforms ──────────────────────────────────────────


def _rfft(t, n, axis, norm):
    norm = _check_norm(norm)
    if t.is_complex():
        raise TypeError("rfft requires a real input; use fft for complex data")
    if t.dim() == 0:
        raise ValueError("rfft expects at least a 1-D signal")
    axis = _norm_axis(axis, t.dim())
    xr = _fit(t, n, axis)
    m = xr.shape[axis]
    h = m // 2 + 1
    rows, restore = _to_rows(xr, axis)
    if m >= 2 and m & (m - 1) == 0:
        yr, yi = rfft_device(rows)  # the one-sided bins of the dispatch
    else:
        yr, yi = fft_exact_device(rows)
        yr, yi = yr[..., :h], yi[..., :h]
    return _scaled(restore(torch.complex(yr, yi)), _fwd_scale(norm, m))


def _irfft(t, n, axis, norm):
    norm = _check_norm(norm)
    if t.dim() == 0:
        raise ValueError("irfft expects at least a 1-D spectrum")
    axis = _norm_axis(axis, t.dim())
    xr, xi = _split(t)
    if xi is None:
        xi = torch.zeros_like(xr)
    if n is None:
        n = 2 * (xr.shape[axis] - 1)
        if n < 1:
            raise ValueError("invalid number of data points (0) specified")
    h = n // 2 + 1
    rr, restore = _to_rows(_fit(xr, h, axis), axis)
    ri = _to_rows(_fit(xi, h, axis), axis)[0]
    if n >= 16 and n & (n - 1) == 0:
        out = restore(irfft_device(rr, ri))  # the real-output fold path
    else:
        # Hermitian extension: full[k] = conj(full[n-k]) for the upper half,
        # the imaginary parts of DC (and of Nyquist for even n) dropped.
        tail = slice(1, n - h + 1)
        fr = torch.cat([rr, rr[..., tail].flip(-1)], dim=-1)
        fi = torch.cat([ri, -ri[..., tail].flip(-1)], dim=-1)
        fi = fi.index_fill(-1, torch.tensor([0] if n % 2 else [0, h - 1], device=fi.device), 0.0)
        yr, _ = ifft_exact_device(fr, fi)
        out = restore(yr)
    return _scaled(out, _inv_scale(norm, n))


def rfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """One-sided DFT of a real signal — ``scipy.fft.rfft`` semantics."""
    t, as_tensor = _in(x, device)
    return _out(_rfft(t, n, axis, norm), as_tensor)


def irfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Real inverse of :func:`rfft` — ``scipy.fft.irfft`` semantics.

    ``n`` is the OUTPUT length (default ``2*(m - 1)``); the one-sided input
    is cropped or zero-padded to ``n//2 + 1`` bins first, like scipy.
    """
    t, as_tensor = _in(x, device)
    return _out(_irfft(t, n, axis, norm), as_tensor)


def hfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Real spectrum of a Hermitian signal — ``scipy.fft.hfft`` semantics:
    ``hfft(a, n) = irfft(conj(a), n) * n`` with the forward norm rules."""
    norm = _check_norm(norm)
    if n is None:
        n = 2 * (_axis_len(x, axis) - 1)
        if n < 1:
            raise ValueError("invalid number of data points (0) specified")
    t, as_tensor = _in(x, device)
    out = _irfft(_conj(t), n, axis, None)
    return _out(out * float(np.float32(n * _fwd_scale(norm, n))), as_tensor)


def ihfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Inverse of :func:`hfft` — ``ihfft(x, n) = conj(rfft(x, n)) / n`` with
    the inverse norm rules (``scipy.fft.ihfft`` semantics)."""
    norm = _check_norm(norm)
    t, as_tensor = _in(x, device)
    out = _conj(_rfft(t, n, axis, None))
    m = n if n is not None else _axis_len(x, axis)
    return _out(out * float(np.float32(_inv_scale(norm, m) / m)), as_tensor)


# ── N-D transforms (separable: repeated 1-D over the named axes) ─────────────


def _resolve_axes(x_ndim: int, s, axes):
    """scipy's s/axes resolution: axes default to all (or the last len(s))."""
    if axes is None:
        axes = list(range(x_ndim)) if s is None else list(range(x_ndim - len(s), x_ndim))
    else:
        axes = [a % x_ndim if -x_ndim <= a < x_ndim else None for a in np.atleast_1d(axes)]
        if None in axes:
            raise ValueError("axes exceeds dimensionality of input")
        axes = [int(a) for a in axes]
    if len(set(axes)) != len(axes):
        raise ValueError("all axes must be unique")
    if s is not None and len(s) != len(axes):
        raise ValueError("when given, axes and shapes arguments have to be of the same length")
    return axes, (list(s) if s is not None else [None] * len(axes))


def _fftn(t, s, axes, norm, inverse: bool):
    axes, sizes = _resolve_axes(t.dim(), s, axes)
    for a, m in zip(axes, sizes):
        t = _fft(t, m, a, norm, inverse)
    return t


def _rfftn(t, s, axes, norm):
    axes, sizes = _resolve_axes(t.dim(), s, axes)
    t = _rfft(t, sizes[-1], axes[-1], norm)
    for a, m in zip(axes[:-1], sizes[:-1]):
        t = _fft(t, m, a, norm, inverse=False)
    return t


def _irfftn(t, s, axes, norm):
    axes, sizes = _resolve_axes(t.dim(), s, axes)
    for a, m in zip(axes[:-1], sizes[:-1]):
        t = _fft(t, m, a, norm, inverse=True)
    return _irfft(t, sizes[-1], axes[-1], norm)


def fftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """N-D DFT over ``axes`` — ``scipy.fft.fftn`` semantics (also covers fft2)."""
    t, as_tensor = _in(x, device)
    return _out(_fftn(t, s, axes, norm, inverse=False), as_tensor)


def ifftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """N-D inverse DFT over ``axes`` — ``scipy.fft.ifftn`` semantics."""
    t, as_tensor = _in(x, device)
    return _out(_fftn(t, s, axes, norm, inverse=True), as_tensor)


def fft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D DFT — ``scipy.fft.fft2`` semantics."""
    return fftn(x, s, axes, norm, device=device)


def ifft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D inverse DFT — ``scipy.fft.ifft2`` semantics."""
    return ifftn(x, s, axes, norm, device=device)


def rfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """N-D one-sided DFT of real input: real transform on the LAST named
    axis, complex on the rest — ``scipy.fft.rfftn`` semantics."""
    t, as_tensor = _in(x, device)
    return _out(_rfftn(t, s, axes, norm), as_tensor)


def irfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Inverse of :func:`rfftn` — ``scipy.fft.irfftn`` semantics (the last
    named axis carries the one-sided real inverse)."""
    t, as_tensor = _in(x, device)
    return _out(_irfftn(t, s, axes, norm), as_tensor)


def rfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D one-sided DFT of real input — ``scipy.fft.rfft2`` semantics."""
    return rfftn(x, s, axes, norm, device=device)


def irfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D inverse of :func:`rfft2` — ``scipy.fft.irfft2`` semantics."""
    return irfftn(x, s, axes, norm, device=device)


def _swap_norm(norm):
    # A Hermitian transform IS the opposite-direction real transform of the
    # conjugate, with the norm's direction swapped:
    # hfftn(x, norm) = irfftn(conj(x), swap(norm)).
    return {None: "forward", "backward": "forward", "forward": "backward", "ortho": "ortho"}[norm]


def hfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """N-D spectrum of a Hermitian-symmetric signal — ``scipy.fft.hfftn``."""
    _check_norm(norm)
    t, as_tensor = _in(x, device)
    return _out(_irfftn(_conj(t), s, axes, _swap_norm(norm)), as_tensor)


def ihfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """Inverse of :func:`hfftn` — ``scipy.fft.ihfftn`` semantics."""
    _check_norm(norm)
    t, as_tensor = _in(x, device)
    return _out(_conj(_rfftn(t, s, axes, _swap_norm(norm))), as_tensor)


def hfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D Hermitian-input spectrum — ``scipy.fft.hfft2`` semantics."""
    return hfftn(x, s, axes, norm, device=device)


def ihfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False, workers=None, *, plan=None, device=None):
    """2-D inverse of :func:`hfft2` — ``scipy.fft.ihfft2`` semantics."""
    return ihfftn(x, s, axes, norm, device=device)


# ── DCT / DST with scipy's n/axis handling around the ops/dct.py cores ───────


def _real_1d(op, t, type, n, axis, norm, orthogonalize):
    if orthogonalize not in (None, True) and norm == "ortho":
        raise NotImplementedError("orthogonalize=False is not supported")
    if t.is_complex():
        raise TypeError("DCT/DST require real input")
    if t.dim() == 0:
        raise ValueError("expects at least a 1-D signal")
    axis = _norm_axis(axis, t.dim())
    rows, restore = _to_rows(_fit(t, n, axis), axis)
    return restore(op(rows, type=type, norm=norm))


def _real_nd(op, t, type, s, axes, norm, orthogonalize):
    axes, sizes = _resolve_axes(t.dim(), s, axes)
    for a, m in zip(axes, sizes):
        t = _real_1d(op, t, type, m, a, norm, orthogonalize)
    return t


def _real(name: str, nd: bool, x, type, s, axes, norm, orthogonalize, device):
    """The public DCT/DST forms: ``ops/dct.py``'s ``<name>_device`` over one
    axis (``nd`` False: ``s``, ``axes`` are ``n``, ``axis``) or several."""
    t, as_tensor = _in(x, device)
    run = _real_nd if nd else _real_1d
    return _out(run(getattr(_dct_ops, f"{name}_device"), t, type, s, axes, norm, orthogonalize), as_tensor)


def dct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
        device=None):
    """DCT types 1-4 — ``scipy.fft.dct`` semantics."""
    return _real("dct", False, x, type, n, axis, norm, orthogonalize, device)


def idct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
         device=None):
    """Inverse DCT — ``scipy.fft.idct`` semantics."""
    return _real("idct", False, x, type, n, axis, norm, orthogonalize, device)


def dst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
        device=None):
    """DST types 1-4 — ``scipy.fft.dst`` semantics."""
    return _real("dst", False, x, type, n, axis, norm, orthogonalize, device)


def idst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
         device=None):
    """Inverse DST — ``scipy.fft.idst`` semantics."""
    return _real("idst", False, x, type, n, axis, norm, orthogonalize, device)


def dctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
         device=None):
    """N-D DCT — ``scipy.fft.dctn`` semantics."""
    return _real("dct", True, x, type, s, axes, norm, orthogonalize, device)


def idctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
          device=None):
    """N-D inverse DCT — ``scipy.fft.idctn`` semantics."""
    return _real("idct", True, x, type, s, axes, norm, orthogonalize, device)


def dstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
         device=None):
    """N-D DST — ``scipy.fft.dstn`` semantics."""
    return _real("dst", True, x, type, s, axes, norm, orthogonalize, device)


def idstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False, workers=None, orthogonalize=None, *,
          device=None):
    """N-D inverse DST — ``scipy.fft.idstn`` semantics."""
    return _real("idst", True, x, type, s, axes, norm, orthogonalize, device)


# ── scipy.fft backend protocol (uarray) ──────────────────────────────────────

_UA_IMPLS = {
    name: obj
    for name, obj in list(globals().items())
    if name in __all__ and callable(obj) and name != "backend"
}


class _Backend:
    """uarray backend for ``scipy.fft.set_backend``: dispatches every
    function this module implements to the library's paths (on
    ``GPU_FFT_TPU_TORCH_DEVICE``, default ``"cuda"``), and returns
    NotImplemented for the rest so scipy falls back to its own."""

    __ua_domain__ = "numpy.scipy.fft"

    @staticmethod
    def __ua_convert__(dispatchables, coerce):
        # accept array-likes as they are; the wrappers convert them
        return tuple(d.value for d in dispatchables)

    @staticmethod
    def __ua_function__(method, args, kwargs):
        fn = _UA_IMPLS.get(method.__name__)
        if fn is None:
            return NotImplemented
        try:
            return fn(*args, **kwargs)
        except NotImplementedError:
            return NotImplemented


backend = _Backend


# ── scipy.fft worker/backend-control API parity ─────────────────────────────
#
# scipy.fft's remaining module surface is process-level control.  The
# workers value (scipy's pocketfft thread count) has no meaning here, so the
# workers API is a context-managed no-op (values round-trip; compute is
# unaffected, exactly like passing ``workers=`` to the transforms).  The
# backend registration functions delegate to scipy's own uarray registry
# with THIS module's backend as the default argument, so
# ``gpu_fft_tpu_torch.compat.set_global_backend()`` makes plain
# ``scipy.fft.fft`` calls run on the library's paths.

_workers_state = threading.local()


def get_workers() -> int:
    """``scipy.fft.get_workers``: the current workers-context value (the
    default 1 unless inside :func:`set_workers`).  Informational only."""
    return getattr(_workers_state, "value", 1)


@contextlib.contextmanager
def set_workers(workers: int):
    """``scipy.fft.set_workers`` context manager (the value round-trips
    through :func:`get_workers`; compute is unaffected)."""
    if int(workers) == 0:
        raise ValueError("workers must not be zero")
    prev = get_workers()
    _workers_state.value = int(workers)
    try:
        yield
    finally:
        _workers_state.value = prev


def set_global_backend(backend_=None, coerce: bool = False, only: bool = False, try_last: bool = False):
    """Install a backend for plain ``scipy.fft`` calls process-wide
    (default: this module's).  Delegates to scipy's uarray registry — after
    this, ``scipy.fft.fft(x)`` runs on the library's paths."""
    import scipy.fft as _sfft

    _sfft.set_global_backend(backend if backend_ is None else backend_, coerce=coerce, only=only, try_last=try_last)


def set_backend(backend_=None, coerce: bool = False, only: bool = False):
    """Context manager routing ``scipy.fft`` calls through a backend
    (default: this module's); see ``scipy.fft.set_backend``::

        with gpu_fft_tpu_torch.compat.set_backend():
            X = scipy.fft.fft(x)          # runs on the library's paths
    """
    import scipy.fft as _sfft

    return _sfft.set_backend(backend if backend_ is None else backend_, coerce=coerce, only=only)


def register_backend(backend_=None):
    """Register a backend (default: this module's) for scipy.fft fallback
    dispatch; see ``scipy.fft.register_backend``."""
    import scipy.fft as _sfft

    _sfft.register_backend(backend if backend_ is None else backend_)


def skip_backend(backend_=None):
    """Context manager skipping a backend (default: this module's) inside
    ``scipy.fft`` dispatch; see ``scipy.fft.skip_backend``."""
    import scipy.fft as _sfft

    return _sfft.skip_backend(backend if backend_ is None else backend_)


__all__ += [
    "get_workers",
    "set_workers",
    "set_backend",
    "set_global_backend",
    "register_backend",
    "skip_backend",
]
