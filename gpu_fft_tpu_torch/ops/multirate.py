"""Multirate ops: upfirdn, resample_poly, decimate.

Port of ``gpu_fft_tpu/ops/multirate.py``.  Every rate change runs on the
overlap-add engine (``ops/filter.py:oaconvolve_device``): zero-stuffing is
an interleaving ``cat(...).reshape`` and downsampling a strided slice.  The
full upsampled convolution runs through the batched block transform in
place of scipy's streaming polyphase kernel.  The host API takes numpy and
returns numpy and runs on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from math import gcd as _gcd

import numpy as np
import torch
import torch.nn.functional as F

from .transform import _as_tensor

__all__ = [
    "decimate",
    "resample_poly",
    "resample_poly_device",
    "upfirdn",
    "upfirdn_device",
]


def upfirdn_device(h, x, up: int = 1, down: int = 1, device=None):
    """Upsample, FIR filter, downsample (``scipy.signal.upfirdn``), on the
    tensor's device.

    ``x``: (n,) or (B, n) real f32 rows; ``h``: (lh,) taps.  Inserts
    ``up - 1`` zeros between samples, convolves through the overlap-add
    engine and keeps every ``down``-th sample: ``((n-1)*up + lh - 1)//down
    + 1`` samples a row.
    """
    from .filter import oaconvolve_device

    x = _as_tensor(x, device)
    h = _as_tensor(h, x.device)
    if h.dim() != 1 or h.shape[0] == 0:
        raise ValueError("upfirdn expects non-empty 1-D taps")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or x.shape[-1] == 0:
        raise ValueError(f"upfirdn expects non-empty 1-D or (B, n) input, got {tuple(x.shape)}")
    b, n = x.shape
    if up > 1:
        stuffed = torch.cat([x[:, :, None], x.new_zeros(b, n, up - 1)], dim=2)
        stuffed = stuffed.reshape(b, n * up)[:, : (n - 1) * up + 1]
    else:
        stuffed = x
    full = oaconvolve_device(stuffed, h)  # (b, (n-1)*up + lh)
    out = full[:, ::down] if down > 1 else full
    return out[0] if squeeze else out


def upfirdn(h, x, up: int = 1, down: int = 1, device=None):
    """Host-convenience :func:`upfirdn_device`; numpy in and out.

    >>> upfirdn([1.0, 1.0, 1.0], [1.0, 2.0, 3.0], up=2, device="cpu").round(5).tolist()
    [1.0, 1.0, 3.0, 2.0, 5.0, 3.0, 3.0]
    """
    return upfirdn_device(h, np.asarray(x, dtype=np.float32), up, down, device=device).cpu().numpy()


def _poly_filter(up: int, down: int, window) -> np.ndarray:
    """The resample_poly anti-alias FIR: kaiser-5.0 by default, cutoff at
    the tighter of the two Nyquists, unity passband after upsampling."""
    from .filter import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate  # scipy's length heuristic
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    return h * up


def resample_poly_device(x, up: int, down: int, window=("kaiser", 5.0), device=None):
    """Rational-rate resampling (``scipy.signal.resample_poly`` for real
    input, 'constant' zero padding), on the tensor's device.

    ``x``: (n,) or (B, n) real f32; ceil(n * up / down) samples a row.  The
    anti-alias FIR is scipy's kaiser-windowed design, or ``window`` as an
    ARRAY of taps used directly (scaled by ``up``, as scipy does).  The
    taps are zero-padded in front to a multiple of ``down`` so the kept
    samples stay phase-aligned with the group delay.
    """
    x = _as_tensor(x, device)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    squeeze = x.dim() == 1
    xs = x[None] if squeeze else x
    if xs.dim() != 2 or xs.shape[-1] == 0:
        raise ValueError(f"resample_poly expects non-empty 1-D or (B, n) input, got {tuple(x.shape)}")
    g = _gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    n = xs.shape[-1]
    n_out = n * up // down + bool(n * up % down)

    if isinstance(window, np.ndarray) or (not isinstance(window, (str, tuple)) and hasattr(window, "__len__")):
        h = np.asarray(window, dtype=np.float64) * up  # scipy scales taps too
        if h.ndim != 1 or h.size == 0:
            raise ValueError("array window must be non-empty 1-D FIR taps")
    else:
        h = _poly_filter(up, down, window)
    half_len = (h.shape[0] - 1) // 2
    # Zeros in front so the group delay lands on a kept (every down-th)
    # sample; the first kept sample past the delay is output 0.
    z = (-half_len) % down
    hp = np.concatenate([np.zeros(z), h]).astype(np.float32)
    skip = (half_len + z) // down
    out = upfirdn_device(hp, xs, up, down)[:, skip : skip + n_out]
    if out.shape[-1] < n_out:  # the tail ran past the convolution: pad (scipy keeps the length)
        out = F.pad(out, (0, n_out - out.shape[-1]))
    return out[0] if squeeze else out


def resample_poly(x, up: int, down: int, window=("kaiser", 5.0), device=None):
    """Host-convenience :func:`resample_poly_device`; numpy in and out."""
    return resample_poly_device(np.asarray(x, dtype=np.float32), up, down, window, device=device).cpu().numpy()


def decimate(x, q: int, n: int | None = None, ftype: str = "iir", zero_phase: bool = True, device=None):
    """Downsample by ``q`` after an anti-alias filter
    (``scipy.signal.decimate``, its defaults included).

    ``ftype='iir'`` (the default): an order-``n`` (default 8) Chebyshev-I
    lowpass at 0.8/q as second-order sections, zero-phase through
    :func:`~gpu_fft_tpu_torch.ops.iir.sosfiltfilt` (or causal through
    ``sosfilt``), then a strided slice.  ``ftype='fir'``: ``n``-order
    (default 20*q) hamming ``firwin`` taps; ``zero_phase`` compensates the
    group delay through the polyphase path.
    """
    xv = np.asarray(x, dtype=np.float32)
    if xv.ndim != 1 or xv.size == 0:
        raise ValueError("decimate expects a non-empty 1-D signal")
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if ftype not in ("iir", "fir"):
        raise ValueError(f"ftype must be 'iir' or 'fir', got {ftype!r}")
    if q == 1:
        return xv.copy()
    if ftype == "iir":
        from .design import cheby1
        from .iir import sosfilt, sosfiltfilt

        order = 8 if n is None else int(n)
        if order < 1:
            raise ValueError(f"filter order must be >= 1, got {order}")
        # Second-order sections, not ba: the narrow high-order Chebyshev's
        # ba polynomials are ill-conditioned in f32 (the JAX package
        # measured 2.4e-2 error at q=7 as ba against 1.9e-6 as sos).
        sos = cheby1(order, 0.05, 0.8 / q, output="sos")
        y = sosfiltfilt(sos, xv, device=device) if zero_phase else sosfilt(sos, xv, device=device)
        return np.asarray(y[::q], dtype=np.float32)
    from .filter import firwin

    order = 20 * q if n is None else int(n)
    if order < 1:
        raise ValueError(f"filter order must be >= 1, got {order}")
    h = firwin(order + 1, 1.0 / q)
    if zero_phase:
        return resample_poly(xv, 1, q, window=h, device=device)
    n_out = xv.shape[0] // q + bool(xv.shape[0] % q)
    return upfirdn(h.astype(np.float32), xv, 1, q, device=device)[:n_out].copy()
