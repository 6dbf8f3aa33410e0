"""Wrappers of the launch-floor probes, each beside its plain version.

Two Pallas kernels of the JAX package's calibration scripts are CUDA kernels
here (``csrc/probes.cu``):

* ``copy_min`` (S5, ``scripts/calibrate_latency.py:pallas_min``): the least
  kernel, o = x * (1 + 2^-20) on one (8, 128) tile;
* ``operand_probe`` (S4, ``scripts/ablate_whole_packed.py:probe``): the same
  plus the first eight rows of each of k (128, 128) tables times 2^-24, one
  kernel instantiation per k in :data:`PROBE_KS`.

Their own work is nil: they measure what a launch costs on the card.  As in
:mod:`.fused`, a wrapper runs its plain torch version for a tensor on the
CPU and launches its kernel or raises for a CUDA tensor; ``COUNTS[name]``
counts both.  The kernels round each product and sum on its own, in the
plain version's order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import LaunchCount, _check, _launch, _on_cpu, _ptr, _stream

__all__ = [
    "COUNTS",
    "PROBE_KS",
    "copy_min",
    "copy_min_plain",
    "operand_probe",
    "operand_probe_plain",
    "reset_counts",
]

PROBE_KS = (0, 1, 2, 4, 8)  # table operands per S4 launch, as the script sweeps them
SCALE = 1.0 + 2.0**-20  # exact in fp32
TABLE_SCALE = 2.0**-24
TILE = (8, 128)
TABLE = (128, 128)

COUNTS = {"copy_min": LaunchCount(), "operand_probe": LaunchCount()}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


def copy_min_plain(x):
    """Plain torch version of :func:`copy_min`."""
    return x * SCALE


def copy_min(x):
    """o = x * (1 + 2^-20) for x (8, 128) fp32 in one launch (JAX:
    ``pallas_min`` of ``scripts/calibrate_latency.py``)."""
    if _on_cpu(x, "copy_min"):
        COUNTS["copy_min"].plain_calls += 1
        return copy_min_plain(x)
    _check("copy_min", x.device, {"x": x}, {"x": TILE})
    o = torch.empty_like(x)
    _launch(COUNTS, "copy_min", _build.library().gft_copy_min, _ptr(x), _ptr(o), _stream(x.device))
    return o


def operand_probe_plain(x, tables):
    """Plain torch version of :func:`operand_probe`, in the script's order."""
    acc = x * SCALE
    for t in tables:
        acc = acc + t[: TILE[0]] * TABLE_SCALE
    return acc


def operand_probe(x, tables):
    """o = x * (1 + 2^-20) + sum_i tables[i][0:8, :] * 2^-24 for x (8, 128)
    and k = len(tables) in :data:`PROBE_KS` (128, 128) fp32 tables, one
    launch taking exactly k table pointers (JAX: ``probe(k)`` of
    ``scripts/ablate_whole_packed.py``)."""
    k = len(tables)
    if k not in PROBE_KS:
        raise ValueError(f"operand_probe takes k in {PROBE_KS} tables, got {k}")
    if _on_cpu(x, "operand_probe"):
        COUNTS["operand_probe"].plain_calls += 1
        return operand_probe_plain(x, tables)
    names = [f"t{i}" for i in range(k)]
    _check("operand_probe", x.device, {"x": x, **dict(zip(names, tables))},
           {"x": TILE, **{n: TABLE for n in names}})
    o = torch.empty_like(x)
    ptrs = [_ptr(t) for t in tables] + [None] * (8 - k)
    _launch(COUNTS, "operand_probe", _build.library().gft_operand_probe, _ptr(x), *ptrs, _ptr(o), k,
            _stream(x.device))
    return o
