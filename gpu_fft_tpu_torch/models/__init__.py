"""Model family built on the library's device transforms.

Port of ``gpu_fft_tpu/models``: Fourier Neural Operators (1-D and 2-D) as
``torch.nn`` modules, the flax weight carry, and the single-device train
step on ``torch.optim``.  Imported lazily.  The JAX package's mesh steps
(``make_data_parallel_step``, ``make_gspmd_step``, ``param_shardings``) are
not ported: asking for them raises ``AttributeError`` (ROADMAP item 15).
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
    "fit",
]

_FNO = {"SpectralConv1d", "SpectralConv2d", "FNO1d", "FNO2d", "append_grid", "load_flax_params"}
_TRAIN = {"mse", "make_train_step", "fit"}
_MESH = {"make_data_parallel_step", "make_gspmd_step", "param_shardings"}


def __getattr__(name):
    if name in _FNO:
        from . import fno

        return getattr(fno, name)
    if name in _TRAIN:
        from . import train

        return getattr(train, name)
    if name in _MESH:
        raise AttributeError(
            f"{name} (the JAX package's mesh train steps) is not ported yet: ROADMAP item 15 "
            "(parallel) brings it on torch.distributed"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
