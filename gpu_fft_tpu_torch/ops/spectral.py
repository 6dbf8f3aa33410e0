"""Power spectral density and the fused fft -> PSD pipeline
(``gpu_fft_tpu/ops/spectral.py:psd`` and friends)."""

from __future__ import annotations

import numpy as np
import torch

from .transform import fft_device

__all__ = ["psd", "psd_device", "one_sided_bins", "power_spectrum_device"]


def psd(real, imag):
    """Power Spectral Density: (real^2 + imag^2) / n per bin (host, numpy).

    >>> psd([3.0, 0.0, 4.0, 0.0], [4.0, 0.0, 3.0, 0.0]).tolist()
    [6.25, 0.0, 6.25, 0.0]
    """
    r = np.asarray(real, dtype=np.float32)
    i = np.asarray(imag, dtype=np.float32)
    if r.shape != i.shape:
        raise ValueError(f"psd: real and imag must have the same shape, got {r.shape} vs {i.shape}")
    n = np.float32(r.shape[-1])
    return (r * r + i * i) / n


def psd_device(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """PSD over the last axis of tensors, on their device."""
    if real.shape != imag.shape:
        raise ValueError(
            f"psd_device: real and imag must have the same shape, got {real.shape} vs {imag.shape}"
        )
    return (real * real + imag * imag) * (1.0 / real.shape[-1])


def one_sided_bins(n: int) -> int:
    """Number of unique bins of a real-signal spectrum: n // 2 + 1."""
    return n // 2 + 1


def power_spectrum_device(x, backend=None, one_sided: bool = True, device=None):
    """fft -> PSD of (n,) or (B, n) real rows on the device, optionally only
    the n // 2 + 1 one-sided bins."""
    yr, yi = fft_device(x, backend=backend, device=device)
    p = psd_device(yr, yi)
    if one_sided:
        p = p[..., : one_sided_bins(p.shape[-1])]
    return p
