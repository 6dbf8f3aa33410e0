"""Runtime backend selection.

* ``TORCH`` — the port's own engines: the hand-written CUDA kernels and the
  torch contractions around them (the JAX package's ``PALLAS``).  Default.
* ``TORCH_FFT`` — ``torch.fft`` (cuFFT on the card), the vendor transform and
  the numerical oracle (the JAX package's ``XLA``).
* ``NATIVE`` — the host C++ library ``native/libtpufft.so`` behind a C ABI,
  loaded via ctypes; listed only when the library loads.  A host backend:
  used only when asked for by name or through ``GPU_FFT_TPU_BACKEND``,
  never in place of the card.
"""

from __future__ import annotations

import enum

from ..config import BACKEND_ENV_VAR, env_backend_name

__all__ = ["Backend", "available_backends", "default_backend", "resolve_backend"]


class Backend(enum.Enum):
    TORCH = "torch"
    TORCH_FFT = "torch_fft"
    NATIVE = "native"


#: ``GPU_FFT_TPU_BACKEND`` values: the port's names and the JAX package's.
_ENV_NAMES = {
    "torch": Backend.TORCH,
    "torch_fft": Backend.TORCH_FFT,
    "native": Backend.NATIVE,
    "pallas": Backend.TORCH,
    "xla": Backend.TORCH_FFT,
}


def available_backends() -> list[Backend]:
    """TORCH and TORCH_FFT, and NATIVE where its library loads."""
    backends = [Backend.TORCH, Backend.TORCH_FFT]
    from . import native  # deferred: probes for the shared library

    if native.is_available():
        backends.append(Backend.NATIVE)
    return backends


def default_backend() -> Backend:
    """``TORCH``, unless ``GPU_FFT_TPU_BACKEND`` names another backend: the
    port's names, or the JAX package's ``pallas`` (-> ``TORCH``) and ``xla``
    (-> ``TORCH_FFT``); ``native`` is NATIVE.  Any other name raises
    ValueError."""
    name = env_backend_name()
    if not name:
        return Backend.TORCH
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
    """The module with ``forward(x)`` / ``inverse(xr, xi)`` for ``backend``
    (NATIVE's take and return numpy arrays, the others tensors)."""
    if backend is Backend.TORCH_FFT:
        from . import torch_fft

        return torch_fft
    if backend is Backend.NATIVE:
        from . import native

        return native
    from . import torch as torch_backend

    return torch_backend
