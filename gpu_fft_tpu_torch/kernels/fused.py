"""Wrappers of the hand-written Hopper kernels, each beside its plain version.

Three Pallas kernels of the JAX package sit on the transform path
(``gpu_fft_tpu/kernels/fused.py``); each is a CUDA kernel here (``csrc/``):

* ``whole_transform`` (K1) and ``whole_transform_packed`` (K2): the whole
  four-step of a B = 1 transform with 1024 <= n <= 16384 in one launch, a
  radix FFT on one thread-block cluster per transform
  (``csrc/whole_transform.cu``; launch shape from :func:`whole_geometry`);
* ``stage_a`` (K3): column DFT + twiddle, the first half of every staged
  transform, with the plan's factored twiddle: a radix FFT per column of the
  (n1, n2) view (``csrc/stage_a.cu``; launch shape from
  :func:`stage_a_geometry`); given a legacy plan with a materialized (n1, n2)
  twiddle it launches K3-legacy, a tiled product reading that table
  (``csrc/stage_a_tile.cuh``, counted as ``stage_a_legacy``).

:func:`lm_geometry` gives the launch shape of the same whole kernel at
n2 = 64, 128 or 256 for the left-matmul four-step (S1, :mod:`.engines`).

Each wrapper keeps the JAX signature.  For a tensor on the CPU it runs its
plain torch version (``*_plain``); for a CUDA tensor it launches the kernel
or raises.  ``COUNTS[name]`` counts both: ``launches`` where the kernel is
launched, ``plain_calls`` where the plain version runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .fused_torch import stage_a_torch

__all__ = [
    "COUNTS",
    "DEFAULT_SMS",
    "lm_geometry",
    "reset_counts",
    "sm_count",
    "stage_a",
    "stage_a_geometry",
    "stage_a_plain",
    "whole_geometry",
    "whole_slices",
    "whole_transform",
    "whole_transform_packed",
    "whole_transform_packed_plain",
    "whole_transform_plain",
]

_N2 = 128  # row length of the whole-transform (n1, 128) view
_VALUES = 8  # complex values a thread of a radix kernel holds in a pass
_MAX_THREADS = 1024


@dataclass
class LaunchCount:
    launches: int = 0
    plain_calls: int = 0


COUNTS = {
    "whole_transform": LaunchCount(),
    "whole_transform_packed": LaunchCount(),
    "stage_a": LaunchCount(),
    "stage_a_legacy": LaunchCount(),
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


def _on_cpu(x: torch.Tensor, kernel: str) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    return False


def _check(
    kernel: str, device: torch.device, tensors: dict, shapes: dict, dtype=torch.float32
) -> None:
    """Every tensor: of ``dtype``, contiguous, 16-byte aligned, on ``device``,
    and of the shape in ``shapes`` (a None tensor is skipped)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


# ── K1 / K2: whole transform ─────────────────────────────────────────────────


def _whole_plain(xr, xi, f1r, f1i, twr, twi, f2r, f2i):
    """The whole four-step on (B, n): P = F1 x, Z = P * TW, Y = F2 Z^T."""
    b, n = xr.shape
    n1 = f1r.shape[0]
    x = xr.reshape(b, n1, _N2)
    pr = f1r @ x
    pi = f1i @ x
    if xi is not None:
        xim = xi.reshape(b, n1, _N2)
        pr = pr - f1i @ xim
        pi = pi + f1r @ xim
    zr = (pr * twr - pi * twi).transpose(1, 2)  # (b, 128, n1) = [c, k1]
    zi = (pr * twi + pi * twr).transpose(1, 2)
    yr = f2r @ zr - f2i @ zi  # (b, 128, n1) = [j, k1]
    yi = f2r @ zi + f2i @ zr
    return yr.reshape(b, n), yi.reshape(b, n)


def whole_transform_plain(xr, xi, plan: dict):
    """Plain torch version of :func:`whole_transform`."""
    return _whole_plain(
        xr, xi, plan["f1r"], plan["f1i"], plan["twr"], plan["twi"], plan["f2r"], plan["f2i"]
    )


def _packed_tables(plan: dict):
    p, n1 = plan["packed"], plan["n1"]
    return (
        p[:n1, :n1], p[n1 : 2 * n1, :n1],
        p[2 * n1 : 3 * n1], p[3 * n1 : 4 * n1],
        p[4 * n1 : 4 * n1 + _N2], p[4 * n1 + _N2 : 4 * n1 + 2 * _N2],
    )


def whole_transform_packed_plain(xr, xi, plan: dict):
    """Plain torch version of :func:`whole_transform_packed`."""
    return _whole_plain(xr, xi, *_packed_tables(plan))


#: Blocks per cluster at B = 1, by n1 = n / 128: the fastest of the swept
#: sizes, real forward and complex inverse alike (``scripts/time_whole.py``
#: on an H100 80GB HBM3 at 700 W: 1,024 threads at the most, 1,024 to 4,096
#: values a block).
_B1_CLUSTER = {8: 1, 16: 1, 32: 4, 64: 8, 128: 16, 256: 16, 512: 16}
#: The same for S1, by n = n1 * n2 (``time_whole``'s S1 sweep).
_LM_B1_CLUSTER = {512: 1, 1024: 1, 2048: 1, 4096: 4, 8192: 8, 16384: 16, 32768: 16, 65536: 16}
#: SMs of an H100 SXM: the count a launch rule assumes for a call with no
#: device (the CPU tests); on a card the wrappers pass :func:`sm_count`.
DEFAULT_SMS = 132


#: SM count by CUDA device index, read once per device.
_SM_COUNTS: dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (132 on an H100 SXM, 114 on
    the PCIe card); :data:`DEFAULT_SMS` for a CPU tensor's device or None.
    A CUDA tensor's device costs one dict lookup after the first call."""
    if device is None:
        return DEFAULT_SMS
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        return DEFAULT_SMS
    index = torch.cuda.current_device() if device.index is None else device.index
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _pow2_in(v: int, lo: int, hi: int) -> bool:
    return lo <= v <= hi and v & (v - 1) == 0


def _stage2_ld(rows: int, n2: int = _N2) -> int:
    """Row stride (complex values) of the whole kernel's stage-2 tile."""
    return n2 + (16 // rows if rows < 16 else 1)


def whole_smem_bytes(n1: int, cluster: int, n2: int = _N2) -> int:
    """Dynamic shared memory of one block of the whole kernel: its tile
    (stage 1: n2/C padded columns of n1, stage 2: n1/C padded rows of n2, in
    turn) and the n1- and n2-point root tables, as complex fp32
    (``csrc/radix.cuh:smem_values``)."""
    rows = n1 // cluster
    return 8 * (max(n2 // cluster * (n1 + 1), rows * _stage2_ld(rows, n2)) + n1 + n2)


def _cluster_geometry(b: int, n1: int, n2: int, b1_cluster: int, sms: int,
                      max_threads: int = _MAX_THREADS) -> tuple[int, int, int]:
    """(cluster, threads, smem_bytes): ``b1_cluster`` at B = 1, halved while
    the grid holds more blocks than the card's ``sms`` SMs, down to the least
    cluster whose blocks fit ``max_threads``."""
    least = max(1, n1 * n2 // (_VALUES * max_threads))
    cluster = b1_cluster
    while cluster > least and b * cluster > sms:
        cluster //= 2
    return cluster, n1 * n2 // (_VALUES * cluster), whole_smem_bytes(n1, cluster, n2)


def whole_geometry(b: int, n1: int, sms: int = DEFAULT_SMS) -> tuple[int, int, int]:
    """(cluster, threads, smem_bytes) of the whole kernel for B = ``b`` rows
    of n = 128 * n1 points: one cluster of ``cluster`` blocks per row, each of
    ``threads`` = n / (8 * cluster) threads.  At B = 1 the cluster is the
    swept fastest; a larger batch halves it while the grid holds more blocks
    than the card has SMs (``sms``), down to the least cluster whose blocks
    fit 1,024 threads (the fastest of the sweep at B = 16 and 64, n = 4,096
    and 16,384, too)."""
    if n1 not in _B1_CLUSTER:
        raise ValueError(f"whole kernel: n1 must be a power of two in [8, 512], got {n1}")
    return _cluster_geometry(b, n1, _N2, _B1_CLUSTER[n1], sms)


def lm_geometry(b: int, n1: int, n2: int, sms: int = DEFAULT_SMS) -> tuple[int, int, int]:
    """(cluster, threads, smem_bytes) of S1, the whole kernel at n2 = 64, 128
    or 256 and n1 <= n2 a power of two >= 8, for B = ``b`` rows: the rule of
    :func:`whole_geometry` with S1's own cluster at B = 1, halved only while
    a block keeps to 512 threads (at (16, 65,536) two blocks of 512 a SM beat
    one of 1,024: ``time_whole``'s S1 sweep)."""
    if n2 not in (64, 128, 256) or not _pow2_in(n1, 8, n2):
        raise ValueError(
            f"fused_fft_lm kernel: n2 must be 64, 128 or 256 and n1 <= n2 a power of two >= 8 "
            f"(n1={n1}, n2={n2})"
        )
    return _cluster_geometry(b, n1, n2, _LM_B1_CLUSTER[n1 * n2], sms, max_threads=512)


def whole_slices(n1: int, cluster: int, n2: int = _N2) -> list[tuple[range, range]]:
    """What block ``r`` of a cluster owns: the x columns of its stage 1 and
    the rows k1 of its stage 2 (and so the output columns ``j * n1 + k1``)."""
    w, m = n2 // cluster, n1 // cluster
    return [(range(r * w, (r + 1) * w), range(r * m, (r + 1) * m)) for r in range(cluster)]


def _whole_args(kernel: str, xr, xi, plan: dict):
    b, n = xr.shape
    n1, n2 = plan["n1"], plan["n2"]
    if n2 != _N2 or n != n1 * n2:
        raise ValueError(f"{kernel}: x is (B, {n}), plan is n1={n1} x n2={n2}")
    if n1 < 8 or n1 & (n1 - 1) or n1 > 512:
        raise ValueError(f"{kernel}: n1 = n/128 must be a power of two in [8, 512], got n1={n1}")
    if xi is not None and xi.shape != xr.shape:
        raise ValueError(f"{kernel}: xr {tuple(xr.shape)} and xi {tuple(xi.shape)} differ")
    return b, n1


def whole_transform(xr, xi, plan: dict):
    """ONE launch for the whole (B, n) transform (JAX: ``whole_transform``).

    ``plan``: :func:`plan.get_whole_plan` tables on ``xr``'s device.  ``xi``
    may be None (real input).  Returns split-complex (B, n), natural order.
    """
    count = COUNTS["whole_transform"]
    if _on_cpu(xr, "whole_transform"):
        count.plain_calls += 1
        return whole_transform_plain(xr, xi, plan)
    b, n1 = _whole_args("whole_transform", xr, xi, plan)
    names = ("f1r", "f1i", "twr", "twi", "f2r", "f2i")
    shapes = {"xr": (b, n1 * _N2), "xi": (b, n1 * _N2), "f1r": (n1, n1), "f1i": (n1, n1),
              "twr": (n1, _N2), "twi": (n1, _N2), "f2r": (_N2, _N2), "f2i": (_N2, _N2)}
    _check("whole_transform", xr.device, {"xr": xr, "xi": xi, **{k: plan[k] for k in names}}, shapes)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    lib = _build.library()
    err = lib.gft_whole_split(
        _ptr(xr), _ptr(xi), *(_ptr(plan[k]) for k in names),
        _ptr(yr), _ptr(yi), b, n1, *whole_geometry(b, n1, sm_count(xr.device)), _stream(xr.device),
    )
    _build.check(err, "whole_transform")
    count.launches += 1
    return yr, yi


def whole_transform_packed(xr, xi, plan: dict):
    """The whole-transform kernel reading ONE packed table buffer (JAX:
    ``whole_transform_packed``; ``plan``: :func:`plan.get_whole_packed_plan`)."""
    count = COUNTS["whole_transform_packed"]
    if _on_cpu(xr, "whole_transform_packed"):
        count.plain_calls += 1
        return whole_transform_packed_plain(xr, xi, plan)
    b, n1 = _whole_args("whole_transform_packed", xr, xi, plan)
    shapes = {"xr": (b, n1 * _N2), "xi": (b, n1 * _N2), "packed": (4 * n1 + 2 * _N2, _N2)}
    tensors = {"xr": xr, "xi": xi, "packed": plan["packed"]}
    _check("whole_transform_packed", xr.device, tensors, shapes)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    lib = _build.library()
    err = lib.gft_whole_packed(
        _ptr(xr), _ptr(xi), _ptr(plan["packed"]), _ptr(yr), _ptr(yi), b, n1,
        *whole_geometry(b, n1, sm_count(xr.device)), _stream(xr.device),
    )
    _build.check(err, "whole_transform_packed")
    count.launches += 1
    return yr, yi


# ── K3 / K3-legacy: stage A ──────────────────────────────────────────────────


def _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows):
    """(output rows, output columns) after the JAX wrapper's checks.  A
    factored plan must be tiled by its own ``ct``; a legacy plan has none, so
    ``col_tile`` just tiles the columns."""
    if "two_r" in tables and col_tile != tables["ct"]:
        raise ValueError(
            f"col_tile {col_tile} does not match the plan's factored tile {tables['ct']}"
        )
    n_tiles = n2 // col_tile if col_tiles is None else col_tiles
    if not 1 <= n_tiles <= n2 // col_tile:
        raise ValueError(f"col_tiles {col_tiles} out of range for n2={n2}, ct={col_tile}")
    out_rows = n1
    if rows is not None:
        if not 8 <= rows <= n1 or rows % 8:
            raise ValueError(f"rows {rows} must be a multiple of 8 in [8, n1={n1}]")
        out_rows = rows
    return out_rows, n_tiles * col_tile


def stage_a_geometry(b: int, n1: int, n2: int, ncols: int) -> tuple[int, int, int]:
    """(width, threads, smem_bytes) of the K3 kernel over a (``b``, n1, n2)
    view of which the first ``ncols`` columns are kept: one block per row and
    tile of ``width`` columns (``ceil(ncols / width)`` tiles a row), each of
    ``threads`` = n1 * width / 8 threads; its shared memory holds the
    (n1, width) tile and the n1-point root table, as complex fp32.  The width
    is 32 columns (one warp's lanes on neighbouring columns), more where n1
    is small so that a block keeps 128 threads, fewer where n1 = 512 so that
    it keeps to 1,024, and at most the power of two that holds ``ncols``.
    It does not depend on ``b``: the grid is ``b`` times a row's tiles, and
    W = 32 is the fastest or within 1.5% of it at B = 1, 2^20 and 2^22
    (``scripts/time_stage_a.py --sweep`` on an H100 80GB HBM3 at 700 W)."""
    if not _pow2_in(n1, 8, 512):
        raise ValueError(f"stage_a kernel: n1 must be a power of two in [8, 512], got {n1}")
    if not 4 <= ncols <= n2 or ncols % 4 or n2 & (n2 - 1):
        raise ValueError(f"stage_a kernel: n2={n2} must be a power of two and ncols={ncols} "
                         f"a multiple of 4 in [4, n2]")
    width = min(max(32, 128 * _VALUES // n1), _VALUES * _MAX_THREADS // n1, n2,
                1 << (ncols - 1).bit_length())
    return width, n1 * width // _VALUES, 8 * (n1 * width + n1)


def stage_a_plain(xr, xi, n1, n2, tables, col_tile, col_tiles=None, rows=None):
    """Plain torch version of :func:`stage_a`."""
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    t = {"f1r": tables["f1r"][:r], "f1i": tables["f1i"][:r]}
    if "two_r" in tables:
        t.update(
            two_r=tables["two_r"][:r, : ncols // col_tile],
            two_i=tables["two_i"][:r, : ncols // col_tile],
            twi_r=tables["twi_r"][:r], twi_i=tables["twi_i"][:r],
        )
    else:
        t.update(twr=tables["twr"][:r, :ncols], twi=tables["twi"][:r, :ncols])
    return stage_a_torch(
        xr[:, :, :ncols], None if xi is None else xi[:, :, :ncols], t
    )


def stage_a(xr, xi, n1: int, n2: int, tables, col_tile: int, col_tiles=None, rows=None):
    """Column DFT + twiddle over a (B, n1, n2) view (JAX: ``stage_a``).

    ``tables``: :func:`plan.get_stage_a_plan` on ``xr``'s device (factored
    twiddle, K3), or a legacy plan with a materialized (n1, n2) ``twr``/``twi``
    pair (K3-legacy).  ``col_tiles`` keeps only the first column tiles and
    ``rows`` only the first k1 rows.  Returns split-complex
    (B, rows or n1, col_tiles * col_tile or n2).
    """
    factored = "two_r" in tables
    count = COUNTS["stage_a" if factored else "stage_a_legacy"]
    if _on_cpu(xr, "stage_a"):
        count.plain_calls += 1
        return stage_a_plain(xr, xi, n1, n2, tables, col_tile, col_tiles, rows)
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    if n2 % 4 or ncols % 4 or (factored and col_tile % 4):
        raise ValueError(
            f"stage_a kernel needs n2, the kept columns and ct to be multiples of 4 "
            f"(n2={n2}, columns={ncols}, ct={col_tile})"
        )
    b = xr.shape[0]
    geometry = stage_a_geometry(b, n1, n2, ncols) if factored else ()
    shapes = {"xr": (b, n1, n2), "xi": (b, n1, n2), "f1r": (n1, n1), "f1i": (n1, n1)}
    if factored:
        names = ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i")
        outer, inner = (n1, n2 // col_tile), (n1, col_tile)
        shapes.update(two_r=outer, two_i=outer, twi_r=inner, twi_i=inner)
    else:
        names = ("f1r", "f1i", "twr", "twi")
        shapes.update(twr=(n1, n2), twi=(n1, n2))
    _check("stage_a", xr.device, {"xr": xr, "xi": xi, **{k: tables[k] for k in names}}, shapes)
    yr = torch.empty((b, r, ncols), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    lib = _build.library()
    ptrs = (_ptr(xr), _ptr(xi), *(_ptr(tables[k]) for k in names), _ptr(yr), _ptr(yi))
    if factored:
        err = lib.gft_stage_a(*ptrs, b, n1, n2, col_tile, r, ncols, *geometry, _stream(xr.device))
    else:
        err = lib.gft_stage_a_full(*ptrs, b, n1, n2, r, ncols, _stream(xr.device))
    _build.check(err, "stage_a")
    count.launches += 1
    return yr, yi
