"""IIR filtering (``lfilter`` / ``filtfilt`` / ``sosfilt``) on torch devices.

Port of ``gpu_fft_tpu/ops/iir.py``.  An IIR recursion
``y[t] = sum_i b[i] x[t-i] - sum_j a[j] y[t-j]`` is sequential by
definition.  The **block-state decomposition** leaves little of it
sequential: split the signal into length-L blocks; inside a block the
ZERO-STATE response is a causal FIR convolution with the impulse response
truncated at L (exact: in-block samples see no tap beyond L), one batched
:func:`~gpu_fft_tpu_torch.ops.filter.fftfilt_device` over every block; the
ZERO-INPUT response is linear in the block's entry state ``z`` through the
observability matrix, one (L, k) product.  What stays sequential is the
carry ``z_{j+1} = F^L z_j + G x_j``, n/L steps of k-vectors (k the order).
The tables (impulse response, observability, input-to-state kernels, F^L)
are made on the host in f64 from the transposed direct-form-II state
matrices and cached on the device.

The carry runs as a Python loop of ``addmm`` steps, giving the JAX
package's ``lax.scan`` state sequence exactly: a few microseconds of host
time a block (a doubling scan or a captured graph would cut it).  The
state products are fp32 with TF32 off (``config.apply_precision``): every
block's output rides them, and a TF32 product (10 mantissa bits) leaves
~1e-3 state error where the JAX package pins ``Precision.HIGHEST``.

State convention: ``z`` IS scipy's transposed-DF-II ``zi``, so ``zi`` /
``zf`` interoperate with ``scipy.signal`` exactly.  The host API takes
numpy and returns numpy and runs on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import apply_precision, resolve_device
from .transform import _as_tensor, _upload

__all__ = [
    "filtfilt",
    "lfilter",
    "lfilter_device",
    "lfilter_zi",
    "lfiltic",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
]

_BLOCK = 1024  # block length L: >= 8x typical orders, one fused-size convolution


def _normalize_ba(b, a):
    """Pad b, a to equal length and normalize a[0] = 1 (f64)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.ndim != 1 or a.ndim != 1 or b.size == 0 or a.size == 0:
        raise ValueError("b and a must be non-empty 1-D coefficient arrays")
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    m = max(b.shape[0], a.shape[0])
    b = np.pad(b, (0, m - b.shape[0])) / a[0]
    a = np.pad(a, (0, m - a.shape[0])) / a[0]
    return b, a


def _df2t_matrices(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form-II state space (f64): z_t = F z_{t-1} + g x_t,
    y_t = c^T z_{t-1} + d x_t, with k = len(a) - 1 states."""
    k = a.shape[0] - 1
    f = np.zeros((k, k), dtype=np.float64)
    f[:, 0] = -a[1:]
    f[: k - 1, 1:] = np.eye(k - 1)
    g = b[1:] - a[1:] * b[0]
    c = np.zeros(k, dtype=np.float64)
    if k:
        c[0] = 1.0
    return f, g, c, float(b[0])


@functools.lru_cache(maxsize=None)
def _block_tables(bk: tuple, ak: tuple, L: int, rem: int) -> dict:
    """Host-made block-state tables (f64 -> f32):

    ``h``   (L,)   impulse response of b/a (the zero-state in-block kernel)
    ``obs`` (L, k) zero-input response rows: obs[t] = c^T F^t
    ``gin`` (L, k) input-to-end-state kernel: gin[j] = (F^{L-1-j} g)^T
    ``flT`` (k, k) (F^L)^T, the block carry propagator (transposed)
    ``gr``  (rem, k), ``frT`` (k, k): the same for the trailing partial
    block (the state at sample n, so ``zf`` is exact for any n).
    """
    b = np.asarray(bk, dtype=np.float64)
    a = np.asarray(ak, dtype=np.float64)
    f, g, c, d = _df2t_matrices(b, a)
    k = f.shape[0]
    # Impulse response by running the recursion L steps in f64.
    h = np.empty(L, dtype=np.float64)
    z = np.zeros(k, dtype=np.float64)
    x = 1.0
    for t in range(L):
        h[t] = (c @ z if k else 0.0) + d * x
        z = f @ z + g * x if k else z
        x = 0.0
    # Observability rows and input kernels by iterating F.
    obs = np.empty((L, k), dtype=np.float64)
    powg = np.empty((L, k), dtype=np.float64)  # powg[i] = F^i g
    row = c.copy()
    col = g.copy()
    for t in range(L):
        obs[t] = row
        powg[t] = col
        row = f.T @ row
        col = f @ col
    fl = np.linalg.matrix_power(f, L) if k else f
    gin = powg[::-1].copy()  # gin[j] = F^{L-1-j} g
    gr = powg[:rem][::-1].copy() if rem else np.zeros((0, k))
    fr = np.linalg.matrix_power(f, rem) if k else f
    f32 = np.float32
    return {
        "h": h.astype(f32),
        "obs": obs.astype(f32),
        "gin": gin.astype(f32),
        "flT": np.ascontiguousarray(fl.T).astype(f32),
        "gr": gr.astype(f32),
        "frT": np.ascontiguousarray(fr.T).astype(f32),
    }


def lfilter_device(b, a, x, zi=None, block: int = _BLOCK, device=None):
    """Filter (R, n) f32 rows with the rational filter b/a, on the tensor's
    device.

    Returns ``y`` when ``zi`` is None, else ``(y, zf)`` in scipy's
    transposed-DF-II state convention (``zi`` / ``zf``: (R, k) rows, or (k,)
    broadcast).
    """
    from ..plan import on_device
    from .filter import fftfilt_device

    b64, a64 = _normalize_ba(b, a)
    k = b64.shape[0] - 1
    x = _as_tensor(x, device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or x.shape[-1] < 1:
        raise ValueError(f"lfilter expects (n,) or (R, n) input, got shape {tuple(x.shape)}")
    r, n = x.shape
    if k == 0:
        y = x * float(np.float32(b64[0]))
        out = y[0] if squeeze else y
        if zi is None:
            return out
        zf = x.new_zeros(r, 0)
        return out, (zf[0] if squeeze else zf)
    apply_precision()
    L = max(4 * k, min(block, max(16, n)))
    nb = -(-n // L)
    rem = n - (nb - 1) * L  # 1..L samples in the last block
    t = on_device(_block_tables, tuple(b64), tuple(a64), L, rem % L, device=x.device)
    pad = nb * L - n
    xp = F.pad(x, (0, pad)) if pad else x
    blocks = xp.reshape(r * nb, L)
    # Zero-state response: one batched causal FIR convolution over all blocks.
    y_zs = fftfilt_device(blocks, t["h"]).reshape(r, nb, L)
    # Input-to-end-state of each block: one (r*nb, L) @ (L, k) product.
    z_end_zs = (blocks @ t["gin"]).reshape(r, nb, k)
    if zi is None:
        z = x.new_zeros(r, k)
    else:
        z = _as_tensor(zi, x.device).expand(r, k)
    # The carry, block by block: z_starts[j] is the ENTRY state of block j.
    z_starts = []
    for j in range(nb):
        z_starts.append(z)
        z = torch.addmm(z_end_zs[:, j], z, t["flT"])
    z_last = z
    z_starts = torch.stack(z_starts, dim=1)  # (r, nb, k)
    y = y_zs + z_starts @ t["obs"].T
    y = y.reshape(r, nb * L)[:, :n]
    out = y[0] if squeeze else y
    if zi is None:
        return out
    # The exact state at sample n: the LAST block's entry state propagated
    # by the rem-step tables (the zero-padded tail never touches zf).
    if rem == L:
        zf = z_last
    else:
        tail = xp.reshape(r, nb, L)[:, -1, :rem]
        zf = z_starts[:, -1] @ t["frT"] + tail @ t["gr"]
    return out, (zf[0] if squeeze else zf)


def lfilter(b, a, x, axis: int = -1, zi=None, device=None):
    """``scipy.signal.lfilter``: rational IIR/FIR filter along ``axis``.

    Numpy in and out; returns ``y``, or ``(y, zf)`` when ``zi`` is given
    (scipy's transposed-DF-II state, shaped like x with ``axis`` replaced
    by ``max(len(a), len(b)) - 1``).
    """
    x = np.asarray(x, dtype=np.float64)
    moved = np.moveaxis(x, axis, -1)
    lead = moved.shape[:-1]
    dev = resolve_device(device)
    rows = _upload(moved.reshape(-1, moved.shape[-1]), dev)
    zrows = None
    if zi is not None:
        zi = np.asarray(zi, dtype=np.float32)
        k = max(np.atleast_1d(b).shape[0], np.atleast_1d(a).shape[0]) - 1
        if zi.ndim == 1:
            zrows = np.tile(zi, (rows.shape[0], 1))
        else:
            zrows = np.moveaxis(zi, axis, -1).reshape(-1, k)
        zrows = _upload(zrows, dev)
    res = lfilter_device(b, a, rows, zi=zrows)
    if zi is None:
        return np.moveaxis(res.cpu().numpy().reshape(*lead, -1), -1, axis)
    y, zf = (v.cpu().numpy() for v in res)
    y = np.moveaxis(y.reshape(*lead, -1), -1, axis)
    zf = np.moveaxis(zf.reshape(*lead, -1), -1, axis)
    return y, zf


def lfilter_zi(b, a) -> np.ndarray:
    """``scipy.signal.lfilter_zi``: the steady-state DF2T state for a unit
    step — ``zi = (I - F)^-1 g`` (f64 host solve)."""
    b64, a64 = _normalize_ba(b, a)
    f, g, _, _ = _df2t_matrices(b64, a64)
    k = f.shape[0]
    if k == 0:
        return np.zeros(0, dtype=np.float64)
    return np.linalg.solve(np.eye(k) - f, g)


def _edge_extend(moved, pad: int, padtype: str | None = "odd"):
    """``moved`` (..., n) with ``pad`` samples added at each end of the last
    axis: the odd or even reflection about the end sample, or the end
    sample repeated (``constant``); unchanged when ``pad`` is 0."""
    if pad == 0:
        return moved
    head, tail = moved[..., pad:0:-1], moved[..., -2 : -pad - 2 : -1]
    if padtype == "odd":
        head = 2.0 * moved[..., :1] - head
        tail = 2.0 * moved[..., -1:] - tail
    elif padtype == "constant":
        head = np.broadcast_to(moved[..., :1], head.shape)
        tail = np.broadcast_to(moved[..., -1:], tail.shape)
    return np.concatenate([head, moved, tail], axis=-1)


def filtfilt(b, a, x, axis: int = -1, padtype: str | None = "odd", padlen: int | None = None,
             device=None):
    """``scipy.signal.filtfilt`` (pad method): zero-phase IIR filtering —
    odd/even/constant edge extension, steady-state initial conditions,
    forward and reverse passes through :func:`lfilter`."""
    x = np.asarray(x, dtype=np.float64)
    m = max(np.atleast_1d(b).shape[0], np.atleast_1d(a).shape[0])
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(f"padtype must be odd|even|constant|None, got {padtype!r}")
    pad = 0 if padtype is None else (3 * m if padlen is None else int(padlen))
    n = x.shape[axis]
    if pad >= n:
        raise ValueError(f"padlen ({pad}) must be less than x.shape[axis] ({n})")
    ext = _edge_extend(np.moveaxis(x, axis, -1), pad, padtype)
    zi = lfilter_zi(b, a)
    y, _ = lfilter(b, a, ext, axis=-1, zi=zi * ext[..., :1], device=device)
    y = y[..., ::-1]
    y, _ = lfilter(b, a, y, axis=-1, zi=zi * y[..., :1], device=device)
    y = y[..., ::-1]
    if pad > 0:
        y = y[..., pad:-pad]
    return np.moveaxis(y, -1, axis)


def sosfilt(sos, x, axis: int = -1, zi=None, device=None):
    """``scipy.signal.sosfilt``: cascade of second-order sections, each
    section through the block-state engine.  ``zi``: (n_sections, ..., 2)
    like scipy; returns ``(y, zf)`` when given."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    y = np.asarray(x, dtype=np.float64)
    zfs = []
    for i in range(sos.shape[0]):
        b, a = sos[i, :3], sos[i, 3:]
        if zi is None:
            y = lfilter(b, a, y, axis=axis, device=device)
        else:
            y, zf = lfilter(b, a, y, axis=axis, zi=np.asarray(zi)[i], device=device)
            zfs.append(zf)
    if zi is None:
        return y
    return y, np.stack(zfs)


def sosfilt_zi(sos) -> np.ndarray:
    """``scipy.signal.sosfilt_zi``: per-section steady-state states for a
    unit step, each scaled by the DC gain of the sections before it."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    zi = np.empty((sos.shape[0], 2), dtype=np.float64)
    scale = 1.0
    for i in range(sos.shape[0]):
        b, a = sos[i, :3], sos[i, 3:]
        zi[i] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfiltfilt(sos, x, axis: int = -1, padtype: str | None = "odd", padlen: int | None = None,
                device=None):
    """``scipy.signal.sosfiltfilt``: zero-phase second-order-section
    filtering — the pad method of :func:`filtfilt` with per-section
    steady-state initial conditions, both passes through the block-state
    engine."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    x = np.asarray(x, dtype=np.float64)
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(f"padtype must be odd|even|constant|None, got {padtype!r}")
    # scipy's default padlen: 3 * the effective tap count of the cascade.
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    pad = 0 if padtype is None else (3 * ntaps if padlen is None else int(padlen))
    n = x.shape[axis]
    if pad >= n:
        raise ValueError(f"padlen ({pad}) must be less than x.shape[axis] ({n})")
    ext = _edge_extend(np.moveaxis(x, axis, -1), pad, padtype)
    zi = sosfilt_zi(sos)  # (m, 2)
    # Broadcast to (m, ...lead, 2) scaled by each row's first sample.
    zi_shaped = zi.reshape((sos.shape[0],) + (1,) * (ext.ndim - 1) + (2,))
    y, _ = sosfilt(sos, ext, axis=-1, zi=zi_shaped * ext[..., :1], device=device)
    y = y[..., ::-1]
    y, _ = sosfilt(sos, y, axis=-1, zi=zi_shaped * y[..., :1], device=device)
    y = y[..., ::-1]
    if pad > 0:
        y = y[..., pad:-pad]
    return np.moveaxis(y, -1, axis)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial ``lfilter`` state from past outputs/inputs
    (``scipy.signal.lfiltic``): the transposed direct-form-II delay line
    that makes ``lfilter(b, a, x_future, zi=...)`` continue the sequence
    whose most recent outputs were ``y[0], y[1], ...`` (newest first) and
    inputs ``x[0], x[1], ...``."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        if a[0] == 0.0:
            raise ValueError("a[0] must be nonzero")
        b, a = b / a[0], a / a[0]
    n, m = a.size - 1, b.size - 1
    k = max(n, m)
    y = np.asarray(y, dtype=np.float64)[:n]
    y = np.concatenate([y, np.zeros(n - y.size)])
    if x is None:
        x = np.zeros(m)
    else:
        x = np.asarray(x, dtype=np.float64)[:m]
        x = np.concatenate([x, np.zeros(m - x.size)])
    zi = np.zeros(k, dtype=np.float64)
    for i in range(m):
        zi[i] += np.sum(b[i + 1:] * x[: m - i])
    for i in range(n):
        zi[i] -= np.sum(a[i + 1:] * y[: n - i])
    return zi
