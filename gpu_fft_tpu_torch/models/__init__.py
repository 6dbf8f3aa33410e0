"""Model family built on the library's device transforms.

Port of ``gpu_fft_tpu/models``: Fourier Neural Operators (1-D and 2-D) as
``torch.nn`` modules, the flax weight carry, the single-device train step
on ``torch.optim`` and the mesh steps on ``torch.distributed``
(``make_data_parallel_step``, ``make_gspmd_step``, ``param_shardings``).
Imported lazily.
"""

from __future__ import annotations

__all__ = [
    "SpectralConv1d",
    "SpectralConv2d",
    "FNO1d",
    "FNO2d",
    "append_grid",
    "load_flax_params",
    "mse",
    "make_train_step",
    "make_data_parallel_step",
    "make_gspmd_step",
    "param_shardings",
    "fit",
]

_FNO = {"SpectralConv1d", "SpectralConv2d", "FNO1d", "FNO2d", "append_grid", "load_flax_params"}
_TRAIN = {"mse", "make_train_step", "make_data_parallel_step", "make_gspmd_step", "param_shardings", "fit"}


def __getattr__(name):
    if name in _FNO:
        from . import fno

        return getattr(fno, name)
    if name in _TRAIN:
        from . import train

        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
