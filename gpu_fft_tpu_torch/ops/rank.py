"""Rank-order and local-statistics filters (scipy.signal parity).

Port of ``gpu_fft_tpu/ops/rank.py``: a copy of that pure-numpy module (only
this docstring differs).  ``medfilt``/``medfilt2d``/``order_filter`` are
windowed order statistics on ``sliding_window_view`` (one vectorized sort
over all windows); ``wiener`` is the local-variance denoiser built on two
zero-padded box sums.
"""

from __future__ import annotations

import numpy as np

__all__ = ["medfilt", "medfilt2d", "order_filter", "wiener"]


def _window_stack(a: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Zero-pad ``a`` so windows center on each element, then return the
    (a.shape..., prod(shape)) stack of window contents."""
    pads = [(s // 2, s // 2) for s in shape]
    ap = np.pad(a, pads, mode="constant")
    win = np.lib.stride_tricks.sliding_window_view(ap, shape)
    return win.reshape(a.shape + (-1,))


def order_filter(a, domain, rank: int):
    """Windowed rank filter (``scipy.signal.order_filter``): at each
    position, the ``rank``-th smallest of the neighbors selected by the
    nonzero mask ``domain`` (odd sizes, zero padding)."""
    a = np.asarray(a)
    domain = np.asarray(domain)
    if domain.ndim != a.ndim:
        raise ValueError("domain must have the same rank as the input")
    if any(s % 2 == 0 for s in domain.shape):
        raise ValueError("all domain dimensions must be odd")
    mask = domain.ravel() != 0
    if not 0 <= rank < int(mask.sum()):
        raise ValueError(f"rank must be in [0, {int(mask.sum())}), got {rank}")
    stack = _window_stack(a, domain.shape)[..., mask]
    return np.sort(stack, axis=-1)[..., rank]


def medfilt(volume, kernel_size=None):
    """Odd-window median filter, any rank (``scipy.signal.medfilt``):
    zero-padded, the middle order statistic per window."""
    volume = np.asarray(volume)
    if kernel_size is None:
        kernel_size = (3,) * volume.ndim
    kernel_size = np.atleast_1d(np.asarray(kernel_size, dtype=np.intp))
    if kernel_size.size == 1:
        kernel_size = np.repeat(kernel_size, volume.ndim)
    if kernel_size.size != volume.ndim:
        raise ValueError("kernel_size must match the input rank")
    if np.any(kernel_size % 2 == 0):
        raise ValueError("each kernel_size element must be odd")
    stack = _window_stack(volume, tuple(int(k) for k in kernel_size))
    return np.median(stack, axis=-1)


def medfilt2d(input, kernel_size=3):
    """2-D median filter (``scipy.signal.medfilt2d``)."""
    input = np.asarray(input)
    if input.ndim != 2:
        raise ValueError("medfilt2d needs a 2-D input")
    return medfilt(input, kernel_size)


def wiener(im, mysize=None, noise=None):
    """Local-statistics Wiener denoiser (``scipy.signal.wiener``):
    out = mean + (1 − noise/var)·(x − mean), clamped to the mean where the
    local variance is below the noise floor; ``noise`` defaults to the
    average local variance."""
    im = np.asarray(im, dtype=np.float64)
    if mysize is None:
        mysize = (3,) * im.ndim
    mysize = np.atleast_1d(np.asarray(mysize, dtype=np.intp))
    if mysize.size == 1:
        mysize = np.repeat(mysize, im.ndim)
    shape = tuple(int(k) for k in mysize)
    size = float(np.prod(shape))
    stack = _window_stack(im, shape)
    l_mean = stack.sum(axis=-1) / size
    l_var = (stack * stack).sum(axis=-1) / size - l_mean * l_mean
    if noise is None:
        noise = float(np.mean(l_var))
    res = im - l_mean
    with np.errstate(divide="ignore", invalid="ignore"):
        res *= 1.0 - noise / l_var
    res += l_mean
    return np.where(l_var < noise, l_mean, res)
