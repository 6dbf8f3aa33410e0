"""Runtime backend selection.

* ``TORCH`` — the port's own engines: the hand-written CUDA kernels and the
  torch contractions around them (the JAX package's ``PALLAS``).  Default.
* ``TORCH_FFT`` — ``torch.fft`` (cuFFT on the card), the vendor transform and
  the numerical oracle (the JAX package's ``XLA``).
"""

from __future__ import annotations

import enum

from ..config import BACKEND_ENV_VAR, env_backend_name

__all__ = ["Backend", "available_backends", "default_backend", "resolve_backend"]


class Backend(enum.Enum):
    TORCH = "torch"
    TORCH_FFT = "torch_fft"


#: ``GPU_FFT_TPU_BACKEND`` values: the port's names and the JAX package's.
_ENV_NAMES = {
    "torch": Backend.TORCH,
    "torch_fft": Backend.TORCH_FFT,
    "pallas": Backend.TORCH,
    "xla": Backend.TORCH_FFT,
}


def available_backends() -> list[Backend]:
    return [Backend.TORCH, Backend.TORCH_FFT]


def default_backend() -> Backend:
    """``TORCH``, unless ``GPU_FFT_TPU_BACKEND`` names another backend: the
    port's names, or the JAX package's ``pallas`` (-> ``TORCH``) and ``xla``
    (-> ``TORCH_FFT``).  ``native`` and any other name raise ValueError."""
    name = env_backend_name()
    if not name:
        return Backend.TORCH
    if name == "native":
        raise ValueError(
            f"{BACKEND_ENV_VAR}=native: the NATIVE backend is not ported (ROADMAP item 10)"
        )
    if name not in _ENV_NAMES:
        raise ValueError(f"{BACKEND_ENV_VAR}={name!r} unknown; have {sorted(_ENV_NAMES)}")
    return _ENV_NAMES[name]


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
