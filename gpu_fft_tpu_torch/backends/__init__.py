"""Runtime backend selection.

* ``TORCH`` — the port's own engines: the hand-written CUDA kernels and the
  torch contractions around them (the JAX package's ``PALLAS``).  Default.
* ``TORCH_FFT`` — ``torch.fft`` (cuFFT on the card), the vendor transform and
  the numerical oracle (the JAX package's ``XLA``).
"""

from __future__ import annotations

import enum

__all__ = ["Backend", "available_backends", "default_backend", "resolve_backend"]


class Backend(enum.Enum):
    TORCH = "torch"
    TORCH_FFT = "torch_fft"


def available_backends() -> list[Backend]:
    return [Backend.TORCH, Backend.TORCH_FFT]


def default_backend() -> Backend:
    return Backend.TORCH


def resolve_backend(backend) -> Backend:
    if backend is None:
        return default_backend()
    if isinstance(backend, Backend):
        return backend
    return Backend(str(backend).lower())


def backend_module(backend: Backend):
    """The module with ``forward(x)`` / ``inverse(xr, xi)`` for ``backend``."""
    if backend is Backend.TORCH_FFT:
        from . import torch_fft

        return torch_fft
    from . import torch as torch_backend

    return torch_backend
