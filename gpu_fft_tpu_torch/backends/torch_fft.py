"""TORCH_FFT backend: ``torch.fft`` behind the library's split-complex API
(1/n on the inverse, as ``numpy.fft.ifft``)."""

from __future__ import annotations

import torch

__all__ = ["forward", "inverse"]


def forward(x):
    spec = torch.fft.fft(x.to(torch.complex64), dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()


def inverse(xr, xi):
    sig = torch.fft.ifft(torch.complex(xr, xi), dim=-1)
    return sig.real.contiguous(), sig.imag.contiguous()
