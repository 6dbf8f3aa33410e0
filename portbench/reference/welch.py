"""Reference of ``welch_device``: ``scipy.signal.welch`` on each channel,
worked out again from the recording: the segments framed, detrended,
windowed, transformed, their power averaged and scaled one-sided."""

from __future__ import annotations

import math

import torch

from .dft import dft_rows, precision, rel_errors


def window(name, n: int, device):
    """scipy's periodic (DFT-even) window of ``n`` points, in float64."""
    j = torch.arange(n, device=device, dtype=torch.float64)
    if name in (None, "boxcar"):
        return torch.ones(n, device=device, dtype=torch.float64)
    if name == "hann":
        return 0.5 - 0.5 * torch.cos(2.0 * math.pi * j / n)
    if name == "hamming":
        return 0.54 - 0.46 * torch.cos(2.0 * math.pi * j / n)
    raise ValueError(f"reference window {name!r} is not one of hann, hamming, boxcar")


def _detrend(segs, mode):
    if mode in (False, None):
        return segs
    if mode in (True, "constant"):
        return segs - segs.mean(dim=-1, keepdim=True)
    if mode == "linear":
        n = segs.shape[-1]
        t = torch.arange(n, device=segs.device, dtype=segs.dtype) - (n - 1) / 2.0
        slope = (segs * t).sum(dim=-1, keepdim=True) / (t * t).sum()
        return segs - segs.mean(dim=-1, keepdim=True) - slope * t
    raise ValueError(f"detrend must be False, 'constant' or 'linear', got {mode!r}")


def _median_bias(m: int) -> float:
    """scipy.signal's bias of the median of m periodograms against their mean."""
    return 1.0 + sum(1.0 / (i + 1.0) - 1.0 / i for i in range(2, 2 * ((m - 1) // 2) + 1, 2))


def reference(x, params, prec: str = "float64"):
    """The one-sided PSD of every channel of the (C, L) real ``x``: (C, nperseg/2 + 1)."""
    nperseg = params["nperseg"]
    hop = nperseg - params["noverlap"]
    fs = params.get("fs", 1.0)
    m = (x.shape[-1] - nperseg) // hop + 1
    h = nperseg // 2 + 1
    w64 = window(params.get("window", "hann"), nperseg, x.device)
    if params.get("scaling", "density") == "density":
        scale = 1.0 / (fs * float((w64 * w64).sum()))
    else:
        scale = 1.0 / float(w64.sum()) ** 2
    mult = torch.full((h,), 2.0 * scale, dtype=torch.float64, device=x.device)
    mult[0] = scale
    mult[-1] = scale  # nperseg is even: the Nyquist bin is not doubled
    out = []
    with precision(prec) as dtype:
        w = w64.to(dtype)
        for row in x:
            segs = row.to(dtype)[:(m - 1) * hop + nperseg].unfold(0, nperseg, hop)
            segs = _detrend(segs, params.get("detrend", "constant")) * w
            yr, yi = dft_rows(segs, None, -1, dtype)
            power = yr[:, :h] ** 2 + yi[:, :h] ** 2
            if params.get("average", "mean") == "median":
                avg = power.to(torch.float64).quantile(0.5, dim=0) / _median_bias(m)
            else:
                avg = power.mean(dim=0)
            out.append(avg.to(torch.float64) * mult)
    return torch.stack(out)


def judge(out, ref) -> dict:
    """``rel_err`` and ``rel_l2`` (dft.rel_errors) over every channel's bins."""
    return rel_errors([(out, None, ref, None)])
