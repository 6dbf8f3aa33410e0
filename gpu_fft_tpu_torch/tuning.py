"""Per-device dispatch constants (the tuning table), trimmed to the fields the
transform path reads.

The JAX package keys one row per TPU generation (``gpu_fft_tpu/tuning.py``).
The port keeps that shape with two rows: ``h100``, uncalibrated, carrying the
v5e gate values, and ``cpu-approx``, the same values for the CPU tests.
Identical gates mean the port takes the same engine as the JAX package for
every (B, n), so the tests compare like with like.  Re-tuning the gates on
H100 measurements is later work.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, replace

import torch

__all__ = ["ChipTuning", "TUNING", "get_tuning"]


@dataclass(frozen=True)
class ChipTuning:
    """Dispatch constants for one device; see ``gpu_fft_tpu/tuning.py`` for
    the measurement behind each v5e value.

    * ``wide_*``: the fused four-step takes the n2 = 128 split when
      b >= wide_batch_min and wide_n_min <= n <= wide_n_max.
    * ``folded_*``: the folded (zero-transpose) layout when
      n <= folded_n_max or b >= folded_batch_min.
    * ``stage_a_n1``: the staged column digit.
    * ``oa_block_min``: the floor of the overlap-add block transform length
      (``ops/filter.py:_best_block_fft_size``).
    * ``half_spectrum_min``: real input computes only k1 <= n1/2 and mirrors.
    * ``irfft_half_min``: a real-output inverse folds the conjugate half of
      its input before the matmuls (fused sizes);
      ``irfft_half_staged_min``: from this staged n, stage A runs on half
      the column tiles and stage B folds per row.
    * ``irfft_direct_k128``: the direct half inverse at n >= 256 contracts
      K = n/2 and adds the Nyquist row as a broadcast.
    * ``whole_*``: the (B, n) band that runs the whole transform as one kernel;
      ``whole_packed_n_max`` picks the packed-table variant inside it.
    * ``stage_a_wide_ct*``: the wider stage-A column tile at large n2.
    """

    name: str
    wide_batch_min: int
    wide_n_min: int
    wide_n_max: int
    folded_n_max: int
    folded_batch_min: int
    stage_a_n1: int
    oa_block_min: int
    half_spectrum_min: int
    irfft_half_min: int
    irfft_half_staged_min: int
    irfft_direct_k128: bool
    whole_n_min: int
    whole_n_max: int
    whole_batch_max: int
    whole_packed_n_max: int
    stage_a_wide_ct: int
    stage_a_wide_ct_n2_min: int
    calibrated: bool
    note: str


_H100 = ChipTuning(
    name="h100",
    wide_batch_min=16,
    wide_n_min=256,
    wide_n_max=16384,
    folded_n_max=16384,
    folded_batch_min=2,
    stage_a_n1=128,
    oa_block_min=16384,
    half_spectrum_min=1 << 15,
    irfft_half_min=1 << 15,
    irfft_half_staged_min=1 << 18,
    irfft_direct_k128=True,
    whole_n_min=1 << 10,
    whole_n_max=1 << 14,
    whole_batch_max=1,
    whole_packed_n_max=1 << 10,
    stage_a_wide_ct=2048,
    stage_a_wide_ct_n2_min=8192,
    calibrated=False,
    note="v5e gate values carried over unmeasured; re-tune on H100 measurements",
)

TUNING = {
    "h100": _H100,
    "cpu-approx": replace(
        _H100, name="cpu-approx", note="CPU tests: mirrors the h100 row so tests cover its dispatch"
    ),
}


@functools.lru_cache(maxsize=1)
def _detected_tuning() -> ChipTuning:
    if torch.cuda.is_available() and "H100" in torch.cuda.get_device_name(0):
        return TUNING["h100"]
    return TUNING["cpu-approx"]


def get_tuning() -> ChipTuning:
    """The tuning row for the detected device.

    ``GPU_FFT_TPU_CHIP`` forces a row (cross-device what-if runs, tests).
    """
    forced = os.environ.get("GPU_FFT_TPU_CHIP")
    if forced:
        key = forced.strip().lower()
        if key not in TUNING:
            raise ValueError(f"GPU_FFT_TPU_CHIP={forced!r} unknown; have {sorted(TUNING)}")
        return TUNING[key]
    return _detected_tuning()
