"""Wrappers of the hand-written Hopper kernels, each beside its plain version.

Three Pallas kernels of the JAX package sit on the transform path
(``gpu_fft_tpu/kernels/fused.py``); each is a CUDA kernel here (``csrc/``),
and each has a second one for ``GPU_FFT_TPU_PRECISION=fast``, where the JAX
kernels' dots run at bf16x1 (``config.mosaic_precision()``):

* ``whole_transform`` (K1) and ``whole_transform_packed`` (K2): the whole
  four-step of a (B, n) transform with n = 128 * n1, 1024 <= n <= 65536,
  in one launch, a radix FFT on one thread-block cluster per row
  (``csrc/whole_transform.cu``; launch shape from :func:`whole_geometry`);
* ``stage_a`` (K3): column DFT + twiddle, the first half of every staged
  transform, with the plan's factored twiddle: a radix FFT per column of the
  (n1, n2) view (``csrc/stage_a.cu``; launch shape from
  :func:`stage_a_geometry`); given a legacy plan with a materialized (n1, n2)
  twiddle it launches K3-legacy, the same radix kernel reading that table
  (counted as ``stage_a_legacy``).

* ``stage_b_kernel`` (K4): stage B of a complex staged transform under
  "full", the row four-step of length n2 = 128 * m1 over stage A's
  (B, n1, n2) output with the digit reversal and the transform's scale in
  its store, in one launch (``csrc/stage_b.cu``; launch shape from
  :func:`stage_b_geometry`).  It replaces no Pallas kernel: the JAX package
  leaves stage B to XLA, and its plain version is the torch engine
  ``fused_torch.stage_b``.

* ``whole_transform_bf16`` (K1F), ``whole_transform_packed_bf16`` (K2F) and
  ``stage_a_bf16`` (K3F, and K3-legacy-fast, K3LF, on a legacy plan,
  counted as ``stage_a_legacy_bf16``): the same functions as the JAX
  bodies compute them under "fast", on the bf16 tensor cores
  (``csrc/whole_bf16.cu``, ``csrc/stage_a_bf16.cu``): products with bf16
  operands and fp32 accumulation, the twiddle in fp32.  ``whole_transform``,
  ``whole_transform_packed`` and ``stage_a`` (either plan layout) hand over
  to them when the mode is "fast" at the call; their tables are the plan's
  fp32 tables rounded to bf16, laid out as the kernels read them
  (:func:`frag_image`, :func:`stage_a_bf16_image`) and kept per plan
  (:func:`bf16_images`).  K1F / K2F spread a row over 8 blocks with its
  tables on chip by bulk copies; launch shape from
  :func:`whole_bf16_geometry` and :func:`whole_bf16_split`.  K3F / K3LF run
  the ``wgmma`` kernel of ``csrc/dot_bf16.cuh`` (S3's and S2F's): F1
  resident in shared memory, persistent blocks over the column tiles of all
  B signals; launch shape from :func:`stage_a_bf16_geometry`.

:func:`lm_geometry` gives the launch shape of the same whole kernel at
n2 = 64, 128 or 256 for the left-matmul four-step (S1, :mod:`.engines`).

Each wrapper keeps the JAX signature and calls one operator of the
``gpu_fft_tpu_torch`` library (``torch.ops.gpu_fft_tpu_torch.whole_transform``,
``whole_transform_packed``, ``stage_a``, ``stage_b`` and the three ``*_bf16``), its
tables as a tensor list: the
CPU kernel of an operator runs the plain torch version (``*_plain``), the
CUDA kernel launches the Hopper kernel or raises, and a fake kernel gives
the output shapes, so ``torch.export`` records the operator itself on
either device.  ``COUNTS[name]`` counts inside the operator's kernels:
``launches`` where the kernel is launched, ``plain_calls`` where the plain
version runs.  Every hand-written kernel of the port is launched through
:func:`_launch`, which counts the launch and wraps the C call in the
profiler span ``gft.launch.<name>`` (or the span it is given: the matched
filter's kernels, :mod:`.matched`, are the entry op's own work and name a
``gft.entry.`` one).  A tensor on any other device raises in the wrapper.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import config
from ..utils.profiling import span
from . import _build
from .fused_torch import _stage_a_twiddle, stage_a_torch, stage_b

__all__ = [
    "COUNTS",
    "DEFAULT_SMS",
    "SMEM_MAX",
    "bf16_images",
    "frag_image",
    "lm_geometry",
    "pair_stacking",
    "reset_counts",
    "sm_count",
    "stage_a",
    "stage_a_bf16",
    "stage_a_bf16_geometry",
    "stage_a_bf16_image",
    "stage_a_bf16_launch",
    "stage_a_bf16_launch_shapes",
    "stage_a_bf16_plain",
    "stage_a_geometry",
    "stage_a_launch_shape",
    "stage_a_plain",
    "stage_b_geometry",
    "stage_b_kernel",
    "stage_b_kernel_plain",
    "stage_b_launch",
    "stage_b_launch_shapes",
    "stage_b_tables",
    "swizzled_image",
    "whole_geometry",
    "whole_slices",
    "whole_transform",
    "whole_transform_bf16",
    "whole_transform_bf16_plain",
    "whole_transform_packed",
    "whole_transform_packed_bf16",
    "whole_transform_packed_bf16_plain",
    "whole_transform_packed_plain",
    "whole_transform_plain",
    "whole_bf16_geometry",
    "whole_bf16_slices",
    "whole_bf16_smem_bytes",
    "whole_bf16_split",
    "whole_bf16_traffic",
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
    "stage_b": LaunchCount(),
    "whole_transform_bf16": LaunchCount(),
    "whole_transform_packed_bf16": LaunchCount(),
    "stage_a_bf16": LaunchCount(),
    "stage_a_legacy_bf16": LaunchCount(),
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


def _launch(counts: dict, kernel: str, entry, *args, span_name: str | None = None) -> None:
    """Launch ``kernel`` by its C entry, ``entry(*args)``, inside the span
    ``span_name``, by default ``gft.launch.<kernel>`` (a kernel of an entry
    op's own work names a ``gft.entry.`` span, the layer its device time
    belongs to); raise on its error and count the launch in
    ``counts[kernel]``: the span and the counter share this one site."""
    with span(span_name or "gft.launch." + kernel):
        err = entry(*args)
    _build.check(err, kernel)
    counts[kernel].launches += 1


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


_WHOLE_TABLES = ("f1r", "f1i", "twr", "twi", "f2r", "f2i")


def _whole_cuda(xr, xi, tables, n1):
    """K1 (six tables) or K2 (the packed buffer) on CUDA tensors."""
    b = xr.shape[0]
    packed = len(tables) == 1
    kernel = "whole_transform_packed" if packed else "whole_transform"
    shapes = {"xr": (b, n1 * _N2), "xi": (b, n1 * _N2)}
    if packed:
        names = ("packed",)
        shapes["packed"] = (4 * n1 + 2 * _N2, _N2)
    else:
        names = _WHOLE_TABLES
        shapes.update(f1r=(n1, n1), f1i=(n1, n1), twr=(n1, _N2), twi=(n1, _N2), f2r=(_N2, _N2), f2i=(_N2, _N2))
    _check(kernel, xr.device, {"xr": xr, "xi": xi, **dict(zip(names, tables))}, shapes)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    lib = _build.library()
    entry = lib.gft_whole_packed if packed else lib.gft_whole_split
    _launch(
        COUNTS, kernel, entry, _ptr(xr), _ptr(xi), *(_ptr(t) for t in tables), _ptr(yr), _ptr(yi), b, n1,
        *whole_geometry(b, n1, sm_count(xr.device)), _stream(xr.device),
    )
    return yr, yi


def _whole_transform_cpu(xr, xi, tables):
    COUNTS["whole_transform"].plain_calls += 1
    return _whole_plain(xr, xi, *tables)


def _whole_transform_cuda(xr, xi, tables):
    return _whole_cuda(xr, xi, tables, tables[0].shape[0])


def _whole_transform_packed_cpu(xr, xi, tables):
    COUNTS["whole_transform_packed"].plain_calls += 1
    return _whole_plain(xr, xi, *_packed_tables({"packed": tables[0], "n1": xr.shape[1] // _N2}))


def _whole_transform_packed_cuda(xr, xi, tables):
    return _whole_cuda(xr, xi, tables, xr.shape[1] // _N2)


def _whole_fake(xr, xi, tables):
    return torch.empty_like(xr), torch.empty_like(xr)


def whole_transform(xr, xi, plan: dict):
    """ONE launch for the whole (B, n) transform (JAX: ``whole_transform``).

    ``plan``: :func:`plan.get_whole_plan` tables on ``xr``'s device.  ``xi``
    may be None (real input).  Returns split-complex (B, n), natural order.
    Under "fast" it is :func:`whole_transform_bf16` (K1F).
    """
    if _fast():
        return whole_transform_bf16(xr, xi, plan)
    if not _on_cpu(xr, "whole_transform"):
        _whole_args("whole_transform", xr, xi, plan)
    return _OPS.whole_transform(xr, xi, [plan[k] for k in _WHOLE_TABLES])


def whole_transform_packed(xr, xi, plan: dict):
    """The whole-transform kernel reading ONE packed table buffer (JAX:
    ``whole_transform_packed``; ``plan``: :func:`plan.get_whole_packed_plan`).
    Under "fast" it is :func:`whole_transform_packed_bf16` (K2F)."""
    if _fast():
        return whole_transform_packed_bf16(xr, xi, plan)
    if not _on_cpu(xr, "whole_transform_packed"):
        _whole_args("whole_transform_packed", xr, xi, plan)
    return _OPS.whole_transform_packed(xr, xi, [plan["packed"]])


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


def _sliced_tables(tables, r: int, ncols: int, col_tile: int) -> dict:
    """The first ``r`` rows of a plan's F1 group and twiddle, the twiddle
    over the first ``ncols`` columns (a factored one: its first
    ``ncols / col_tile`` outer columns)."""
    t = {k: tables[k][:r] for k in ("f1r", "f1i", "f1s", "f1d") if k in tables}
    if "two_r" in tables:
        t.update(
            two_r=tables["two_r"][:r, : ncols // col_tile],
            two_i=tables["two_i"][:r, : ncols // col_tile],
            twi_r=tables["twi_r"][:r], twi_i=tables["twi_i"][:r],
        )
    else:
        t.update(twr=tables["twr"][:r, :ncols], twi=tables["twi"][:r, :ncols])
    return t


def _stage_a_sliced(xr, xi, tables, r: int, ncols: int, col_tile: int):
    """Plain stage A on the first ``r`` rows and ``ncols`` columns."""
    return stage_a_torch(
        xr[:, :, :ncols], None if xi is None else xi[:, :, :ncols], _sliced_tables(tables, r, ncols, col_tile)
    )


def stage_a_plain(xr, xi, n1, n2, tables, col_tile, col_tiles=None, rows=None):
    """Plain torch version of :func:`stage_a`."""
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    return _stage_a_sliced(xr, xi, tables, r, ncols, col_tile)


def stage_a_launch_shape(b: int, n1: int, n2: int, tables, col_tile: int, col_tiles=None,
                         rows=None) -> tuple[int, int, tuple[int, int, int]]:
    """(output rows, output columns, :func:`stage_a_geometry`) of the stage-A
    kernel over a (``b``, n1, n2) view, for either plan layout: the radix
    kernel takes the same launch shape whichever table it reads.  Raises
    ValueError for a shape the kernel cannot take (n1 not a power of two in
    [8, 512], n2, the kept columns or a factored ct not multiples of 4)."""
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    if n2 % 4 or ncols % 4 or ("two_r" in tables and col_tile % 4):
        raise ValueError(
            f"stage_a kernel needs n2, the kept columns and ct to be multiples of 4 "
            f"(n2={n2}, columns={ncols}, ct={col_tile})"
        )
    return r, ncols, stage_a_geometry(b, n1, n2, ncols)


_FACTORED_TABLES = ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i")
_LEGACY_TABLES = ("f1r", "f1i", "twr", "twi")


def _stage_a_tables(tables: list) -> dict:
    """The operator's table list as a plan dict: six tables are K3's
    factored twiddle, four K3-legacy's materialized one."""
    return dict(zip(_FACTORED_TABLES if len(tables) == 6 else _LEGACY_TABLES, tables))


def _stage_a_cpu(xr, xi, tables, n1, n2, col_tile, rows, ncols):
    t = _stage_a_tables(tables)
    COUNTS["stage_a" if "two_r" in t else "stage_a_legacy"].plain_calls += 1
    return _stage_a_sliced(xr, xi, t, rows, ncols, col_tile)


def _stage_a_cuda(xr, xi, tables, n1, n2, col_tile, rows, ncols):
    t = _stage_a_tables(tables)
    factored = "two_r" in t
    b = xr.shape[0]
    shapes = {"xr": (b, n1, n2), "xi": (b, n1, n2), "f1r": (n1, n1), "f1i": (n1, n1)}
    if factored:
        outer, inner = (n1, n2 // col_tile), (n1, col_tile)
        shapes.update(two_r=outer, two_i=outer, twi_r=inner, twi_i=inner)
    else:
        shapes.update(twr=(n1, n2), twi=(n1, n2))
    _check("stage_a", xr.device, {"xr": xr, "xi": xi, **t}, shapes)
    geometry = stage_a_geometry(b, n1, n2, ncols)
    yr = torch.empty((b, rows, ncols), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    lib = _build.library()
    ptrs = (_ptr(xr), _ptr(xi), *(_ptr(v) for v in t.values()), _ptr(yr), _ptr(yi))
    if factored:
        _launch(COUNTS, "stage_a", lib.gft_stage_a, *ptrs, b, n1, n2, col_tile, rows, ncols, *geometry,
                _stream(xr.device))
    else:
        _launch(COUNTS, "stage_a_legacy", lib.gft_stage_a_full, *ptrs, b, n1, n2, rows, ncols, *geometry,
                _stream(xr.device))
    return yr, yi


def _stage_a_fake(xr, xi, tables, n1, n2, col_tile, rows, ncols):
    out = xr.new_empty((xr.shape[0], rows, ncols))
    return out, torch.empty_like(out)


def stage_a(xr, xi, n1: int, n2: int, tables, col_tile: int, col_tiles=None, rows=None):
    """Column DFT + twiddle over a (B, n1, n2) view (JAX: ``stage_a``).

    ``tables``: :func:`plan.get_stage_a_plan` on ``xr``'s device (factored
    twiddle, K3), or a legacy plan with a materialized (n1, n2) ``twr``/``twi``
    pair (K3-legacy).  ``col_tiles`` keeps only the first column tiles and
    ``rows`` only the first k1 rows.  Returns split-complex
    (B, rows or n1, col_tiles * col_tile or n2).  Off the CPU, a shape the
    kernel cannot take raises ValueError before the device is looked at.
    Under "fast" it is :func:`stage_a_bf16`: K3F on a factored plan, K3LF
    on a legacy one.
    """
    if _fast():
        return stage_a_bf16(xr, xi, n1, n2, tables, col_tile, col_tiles, rows)
    names = _FACTORED_TABLES if "two_r" in tables else _LEGACY_TABLES
    if xr.device.type == "cpu":
        r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    else:
        r, ncols, _ = stage_a_launch_shape(xr.shape[0], n1, n2, tables, col_tile, col_tiles, rows)
        _on_cpu(xr, "stage_a")  # raises for any device but CUDA
    return _OPS.stage_a(xr, xi, [tables[k] for k in names], n1, n2, col_tile, r, ncols)


# ── K4: stage B ──────────────────────────────────────────────────────────────

#: K4's launch shape by m1 = n2 / 128: (G, C), G consecutive rows k1 a
#: cluster, C blocks a row (``csrc/stage_b.cu``).  G = 8 makes every store
#: fill whole 32-byte sectors; a row needs C >= m1 / 64 blocks of 1,024
#: threads and a cluster holds at most 16 blocks, so G = 16 / C above
#: m1 = 128.  Each entry is the fastest (G, C) of ``scripts/time_stage_b.py
#: --sweep`` at B·n1 = 1,024 and 8,192 rows (an H100 80GB HBM3 at 700 W):
#: at the matched filter's (64, 128, 8,192) C = 2 takes 0.959 ms, C = 1
#: 0.998 and G = 4 1.176.  At 128 rows (B = 1) it is the fastest too, but
#: at n2 = 4,096, where (8, 2) is 10% faster (0.0108 against 0.0119 ms),
#: and at 16,384, where (4, 4) is 8% faster (0.0461 against 0.0499 ms):
#: a few microseconds, so the rule keys on m1 alone.
_STAGE_B_SHAPE = {8: (8, 1), 16: (8, 1), 32: (8, 1), 64: (8, 2), 128: (8, 2), 256: (4, 4), 512: (2, 8)}
_MAX_CLUSTER = 16


def stage_b_launch_shapes(n1: int, m1: int) -> list[tuple[int, int]]:
    """Every (G, C) K4 takes for rows of n2 = 128 * ``m1`` under a stage-A
    split of ``n1`` rows a signal: G and C powers of two, G <= 8, C blocks
    of 32 to 1,024 threads a row, G <= n1 and G * C <= min(16, m1)."""
    least = max(1, m1 // 64)
    return [(1 << i, c) for i in range(4) for c in (least << j for j in range(5))
            if (1 << i) <= n1 and (1 << i) * c <= min(_MAX_CLUSTER, m1) and c <= m1 // 2]


def stage_b_geometry(n1: int, m1: int, shape: tuple[int, int] | None = None) -> tuple[int, int, int, int]:
    """(rows, cluster, threads, smem_bytes) of K4 over a (B, ``n1``, 128 *
    ``m1``) stage-A output: ``rows`` = G consecutive rows k1 a cluster of
    ``cluster`` = G * C blocks, each of n2 / (8 C) threads, with K1's shared
    memory at n1 = m1 (:func:`whole_smem_bytes`).  ``shape`` = (G, C), one
    of :func:`stage_b_launch_shapes`; by default the rule's pick, G capped at
    ``n1``."""
    if not _pow2_in(m1, 8, 512) or not _pow2_in(n1, 1, 1 << 30):
        raise ValueError(f"stage_b kernel: m1 = n2/128 must be a power of two in [8, 512] and n1 a "
                         f"power of two (n1={n1}, m1={m1})")
    if shape is None:
        g, c = _STAGE_B_SHAPE[m1]
        shape = (min(g, n1), c)
    if shape not in stage_b_launch_shapes(n1, m1):
        raise ValueError(f"stage_b kernel: (G, C) = {shape} is not a launch shape at n1={n1}, m1={m1}")
    g, c = shape
    return g, g * c, m1 * _N2 // (_VALUES * c), whole_smem_bytes(m1, c)


_STAGE_B_TABLES = ("f1r", "f1i", "f1s", "f1d", "f2r", "f2i", "f2s", "f2d", "twr", "twi")


def stage_b_tables(t: dict, tw: dict) -> list:
    """The ``stage_b`` operator's table list: the stage-B tables ``t`` (the
    plain version's), then K4's twiddle ``tw`` laid out (m1, 128)."""
    return [t[k] for k in _STAGE_B_TABLES] + [tw["twr"], tw["twi"]]


def stage_b_kernel_plain(yr, yi, n1: int, n2: int, t: dict, tw: dict, scale: float | None = None):
    """Plain torch version of :func:`stage_b_kernel`, with its signature:
    the torch engine ``fused_torch.stage_b`` on the stage-B tables ``t``
    (which hold ``tw``'s values laid out (128, m1)), times ``scale``."""
    rr, ri = stage_b(yr, yi, n1, n2, t)
    if scale is None or scale == 1.0:
        return rr, ri
    return rr * scale, ri * scale


def _stage_b_cpu(yr, yi, tables, n1, scale):
    COUNTS["stage_b"].plain_calls += 1
    t = dict(zip(_STAGE_B_TABLES, tables), m1=tables[0].shape[0], m2=_N2)
    tw = dict(zip(("twr", "twi"), tables[len(_STAGE_B_TABLES):]))
    return stage_b_kernel_plain(yr, yi, n1, yr.shape[-1], t, tw, scale)


def stage_b_launch(yr, yi, tables: list, n1: int, scale: float, geometry: tuple[int, int, int, int]):
    """Launch K4 on CUDA tensors: ``tables`` as the operator takes them (the
    stage-B tables, then the (m1, 128) twiddle), ``geometry`` one of
    :func:`stage_b_geometry` (a sweep times each)."""
    b, n2 = yr.shape[0], yr.shape[-1]
    m1 = n2 // _N2
    t = dict(zip((*_STAGE_B_TABLES, "twr_k", "twi_k"), tables))
    read = {"yr": yr, "yi": yi, **{k: t[k] for k in ("f1r", "f1i", "f2r", "f2i", "twr_k", "twi_k")}}
    shapes = {"yr": (b, n1, n2), "yi": (b, n1, n2), "f1r": (m1, m1), "f1i": (m1, m1), "f2r": (_N2, _N2),
              "f2i": (_N2, _N2), "twr_k": (m1, _N2), "twi_k": (m1, _N2)}
    _check("stage_b", yr.device, read, shapes)
    out_r = torch.empty((b, n1 * n2), dtype=torch.float32, device=yr.device)
    out_i = torch.empty_like(out_r)
    rows, cluster, threads, smem = geometry
    _launch(COUNTS, "stage_b", _build.library().gft_stage_b, _ptr(yr), _ptr(yi), _ptr(t["f1r"]),
            _ptr(t["f1i"]), _ptr(t["f2r"]), _ptr(t["f2i"]), _ptr(t["twr_k"]), _ptr(t["twi_k"]), _ptr(out_r),
            _ptr(out_i), b, n1, m1, rows, cluster, threads, smem, scale, _stream(yr.device))
    return out_r, out_i


def _stage_b_cuda(yr, yi, tables, n1, scale):
    return stage_b_launch(yr, yi, tables, n1, scale, stage_b_geometry(n1, yr.shape[-1] // _N2))


def _stage_b_fake(yr, yi, tables, n1, scale):
    out = yr.new_empty((yr.shape[0], n1 * yr.shape[-1]))
    return out, torch.empty_like(out)


def stage_b_kernel(yr, yi, n1: int, n2: int, t: dict, tw: dict, scale: float | None = None):
    """Stage B of a complex staged transform in one launch (K4): the row
    transforms of length n2 = 128 * m1 of stage A's (B, n1, n2) output
    ``yr``, ``yi``, stored in natural order (flat k1 + n1 * k2) times
    ``scale``.  ``t``: the stage-A plan's ``stage_b`` tables; ``tw``:
    :func:`plan.get_stage_b_twiddle` (the twiddle (m1, 128)), both on the
    input's device.  Returns split-complex (B, n1 * n2).  On a CPU tensor
    the plain version (the torch engine ``fused_torch.stage_b``, then the
    scale).  On every device ``yr`` and ``yi`` must be contiguous fp32
    (B, n1, n2), as the kernel reads them; off the CPU a shape the kernel
    cannot take raises ValueError before the device is looked at.  No
    "fast" form: the dispatch takes the torch engine under "high" and
    "fast"."""
    for name, y in (("yr", yr), ("yi", yi)):
        if y is None or y.dim() != 3 or tuple(y.shape) != (yr.shape[0], n1, n2):
            raise ValueError(f"stage_b kernel: yr and yi must both be (B, {n1}, {n2}), got "
                             f"{tuple(yr.shape)} and {None if yi is None else tuple(yi.shape)}")
        if y.dtype != torch.float32 or not y.is_contiguous():
            raise ValueError(f"stage_b kernel: {name} must be contiguous float32")
    if t["m1"] * t["m2"] != n2 or t["m2"] != _N2:
        raise ValueError(f"stage_b kernel: n2={n2} is not the plan's {t['m1']} x {t['m2']}")
    if not _on_cpu(yr, "stage_b"):
        stage_b_geometry(n1, n2 // _N2)
    return _OPS.stage_b(yr, yi, stage_b_tables(t, tw), n1, 1.0 if scale is None else float(scale))


# ── K1F / K2F / K3F: the "fast" kernels on the bf16 tensor cores ─────────────


def _fast() -> bool:
    """Whether the kernels take their bf16x1 form now (``config.PRECISION``
    is read at every call, as the JAX kernels read it at trace time)."""
    return config.mosaic_precision() == "bf16x1"


def _bf(t):
    """``t`` rounded to bf16 (to nearest even), as fp32: what a DEFAULT dot
    takes of an fp32 operand."""
    return t.to(torch.bfloat16).float()


def _bf16_dots(fr, fi, fs, fd, ar, ai):
    """(re, im) of F (ar + i ai) with bf16-rounded operands and fp32
    products (exact) and sums: real data Fr x and Fi x; complex data the
    Karatsuba form Fr (ar + ai), Fd ar, Fs ai when ``fs`` is given, else the
    4-product form.  F (m, k) multiplies (.., k, cols)."""
    if ai is None:
        x = _bf(ar)
        return _bf(fr) @ x, _bf(fi) @ x
    if fs is not None:
        k1 = _bf(fr) @ _bf(ar + ai)
        k2 = _bf(fd) @ _bf(ar)
        k3 = _bf(fs) @ _bf(ai)
        return k1 - k3, k1 + k2
    xr, xi = _bf(ar), _bf(ai)
    fr, fi = _bf(fr), _bf(fi)
    return fr @ xr - fi @ xi, fi @ xr + fr @ xi


def _whole_bf16_plain(xr, xi, f1, twr, twi, f2):
    """The whole four-step as the JAX bodies compute it under "fast":
    P = F1 x, Z = P * TW in fp32, Y = F2 Z^T, each dot on bf16-rounded
    operands.  ``f1``, ``f2``: (r, i, s, d) with s, d None for K2's
    4-product form."""
    b, n = xr.shape
    n1 = f1[0].shape[0]
    x = xr.reshape(b, n1, _N2)
    pr, pi = _bf16_dots(*f1, x, None if xi is None else xi.reshape(b, n1, _N2))
    zr = pr * twr - pi * twi  # (b, n1, 128) = [k1, c]
    zi = pr * twi + pi * twr
    yr, yi = _bf16_dots(*f2, zr.transpose(1, 2), zi.transpose(1, 2))  # (b, 128, n1) = [j, k1]
    return yr.reshape(b, n), yi.reshape(b, n)


_WHOLE_BF16_F1 = ("f1r", "f1i", "f1s", "f1d")
_WHOLE_BF16_F2 = ("f2r", "f2i", "f2s", "f2d")


def whole_transform_bf16_plain(xr, xi, plan: dict):
    """Plain torch version of :func:`whole_transform_bf16` (K1F)."""
    return _whole_bf16_plain(xr, xi, [plan[k] for k in _WHOLE_BF16_F1], plan["twr"], plan["twi"],
                             [plan[k] for k in _WHOLE_BF16_F2])


def whole_transform_packed_bf16_plain(xr, xi, plan: dict):
    """Plain torch version of :func:`whole_transform_packed_bf16` (K2F)."""
    f1r, f1i, twr, twi, f2r, f2i = _packed_tables(plan)
    return _whole_bf16_plain(xr, xi, (f1r, f1i, None, None), twr, twi, (f2r, f2i, None, None))


def frag_image(*mats: torch.Tensor) -> torch.Tensor:
    """The bf16 image of (M, K) fp32 matrices as ``csrc/mma_bf16.cuh`` reads
    an mma.sync m16n8k16 A operand: each rounded to bf16, zero-padded to
    multiples of 16, then (len(mats), M/16, K/16, 32 lanes, 8 values) with
    lane 4 g + t holding rows (g, g + 8) x depths (2t, 2t + 1, 2t + 8,
    2t + 9) in register order."""
    m, k = mats[0].shape
    mp, kp = -(-m // 16) * 16, -(-k // 16) * 16
    out = torch.zeros((len(mats), mp, kp), dtype=torch.bfloat16, device=mats[0].device)
    for i, a in enumerate(mats):
        out[i, :m, :k] = a.to(torch.bfloat16)
    # [slot, mt, h, g, kt, kh, t, e] -> [slot, mt, kt, g, t, kh, h, e]
    tiles = out.reshape(len(mats), mp // 16, 2, 8, kp // 16, 2, 4, 2)
    return tiles.permute(0, 1, 4, 3, 6, 5, 2, 7).reshape(len(mats), mp // 16, kp // 16, 32, 8).contiguous()


def swizzled_image(parts: torch.Tensor) -> torch.Tensor:
    """The bf16 ``wgmma`` kernel's shared-memory image of the stacked parts
    (P, M, n1) (``csrc/dot_bf16.cuh``): (ceil(M / 64), P, ceil(n1 / 64), 64,
    64), per 64 rows g, part p and 64-deep chunk c the rows r as ``wgmma``'s
    K-major 128-byte swizzle lays them out: the 16-byte word j (depths 8 j ..
    8 j + 7) of row r stored at word j ^ (r % 8), rows past M and depths
    past n1 zero.  A block's parts of one row group are then one run of
    bytes, copied as it is."""
    n_parts, m, n1 = parts.shape
    groups, chunks = -(-m // 64), -(-n1 // 64)
    padded = parts.new_zeros(n_parts, groups * 64, chunks * 64)
    padded[:, :m, :n1] = parts
    t = padded.reshape(n_parts, groups, 64, chunks, 8, 8)  # p, g, r, c, word, depth
    r = torch.arange(64, device=parts.device).reshape(64, 1)
    word = torch.arange(8, device=parts.device).reshape(1, 8)
    idx = (word ^ (r % 8)).reshape(1, 1, 64, 1, 8, 1).expand_as(t)
    img = torch.gather(t, 4, idx).permute(1, 0, 3, 2, 4, 5)
    return img.reshape(groups, n_parts, chunks, 64, 64).contiguous()


_PAIR = 32  # output rows of a real-input group: 64 stacked rows, Fr's then Fi's


def pair_stacking(fr: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """S2's stacking of an (n1, n1) pair, as S2F, K3F and K3LF read it on
    real input: for every 32 output rows k1 (the last run zero-padded to 32),
    their Fr rows then their Fi rows as one 64-row group, so that rows 32
    apart are Re and Im of one output row.  (64 ceil(n1 / 32), n1)."""
    (n1, k), groups = fr.shape, -(-fr.shape[0] // _PAIR)
    runs = [torch.nn.functional.pad(f, (0, 0, 0, groups * _PAIR - n1)).reshape(groups, _PAIR, k) for f in (fr, fi)]
    return torch.stack(runs, dim=1).reshape(2 * groups * _PAIR, k)


def stage_a_bf16_image(plan: dict) -> torch.Tensor:
    """K3F's and K3LF's bf16 image of F1 (``csrc/stage_a_bf16.cu``): the
    :func:`swizzled_image` runs, (ceil(n1 / 32) + 3 ceil(n1 / 64),
    ceil(n1 / 64), 64, 64), of real input's :func:`pair_stacking` of (Fr,
    Fi), one part a group, then of the Karatsuba parts (Fr, Fd, Fs) of every
    64 rows, three parts a group.  One image serves every ``rows`` cut: a
    launch reads the first ceil(rows / 32) (ceil(rows / 64)) groups."""
    fr, fi, fs, fd = (plan[k].to(torch.bfloat16) for k in _STAGE_A_BF16_F1)
    real = swizzled_image(pair_stacking(fr, fi)[None])
    kara = swizzled_image(torch.stack([fr, fd, fs]))
    return torch.cat([real.flatten(0, 1), kara.flatten(0, 1)])


#: The bf16 images of each plan, keyed by (the identity of) one of the
#: plan's own table tensors, so they live as long as the plan does.
_IMAGES = WeakIdKeyDictionary()


def bf16_images(plan: dict) -> tuple:
    """The fast kernels' bf16 tables of a plan, built once per plan on the
    plan's device from its fp32 tables (the same f64 formulas, rounded to
    bf16 to nearest even, as a DEFAULT dot rounds them): a whole plan gives
    F1's and F2's :func:`frag_image` (slots r, i, s, d), a packed plan the
    same for r, i, a stage-A plan (factored or legacy) its
    :func:`stage_a_bf16_image`.  An image made while ``torch.export`` traces
    (a fake tensor) is not kept."""
    key = plan["packed"] if "packed" in plan else plan["f1r"]
    images = _IMAGES.get(key)
    if images is None:
        if "packed" in plan:
            f1r, f1i, _, _, f2r, f2i = _packed_tables(plan)
            images = (frag_image(f1r, f1i), frag_image(f2r, f2i))
        elif "f2r" in plan:
            images = (frag_image(*(plan[k] for k in _WHOLE_BF16_F1)),
                      frag_image(*(plan[k] for k in _WHOLE_BF16_F2)))
        else:
            images = (stage_a_bf16_image(plan),)
        if all(type(t) is torch.Tensor for t in images):
            _IMAGES[key] = images
    return images


def _whole_bf16_tables(kernel: str, xr, xi, plan: dict, packed: bool) -> list:
    """The operator's table list: on the CPU the plan's fp32 tables (the
    plain version rounds them), on the card the bf16 images and the fp32
    twiddle."""
    if _on_cpu(xr, kernel):
        if packed:
            return [plan["packed"]]
        return [plan[k] for k in (*_WHOLE_BF16_F1, "twr", "twi", *_WHOLE_BF16_F2)]
    _, n1 = _whole_args(kernel, xr, xi, plan)
    if n1 > 128:
        raise ValueError(f"{kernel}: n1 = n/128 must be at most 128 (n <= 16384), got n1={n1}")
    img1, img2 = bf16_images(plan)
    twr, twi = _packed_tables(plan)[2:4] if packed else (plan["twr"], plan["twi"])
    return [img1, img2, twr, twi]


def whole_transform_bf16(xr, xi, plan: dict):
    """K1F: :func:`whole_transform` as the JAX body computes it under
    "fast" (Karatsuba dots on bf16 operands, fp32 twiddle), one launch on the
    tensor cores; ``plan``: :func:`plan.get_whole_plan`, n <= 16,384."""
    tables = _whole_bf16_tables("whole_transform_bf16", xr, xi, plan, False)
    return _OPS.whole_transform_bf16(xr, xi, tables)


def whole_transform_packed_bf16(xr, xi, plan: dict):
    """K2F: :func:`whole_transform_packed` under "fast" (the stacked
    4-product dots on bf16 operands); ``plan``:
    :func:`plan.get_whole_packed_plan`."""
    tables = _whole_bf16_tables("whole_transform_packed_bf16", xr, xi, plan, True)
    return _OPS.whole_transform_packed_bf16(xr, xi, tables)


#: K1F / K2F's blocks a row at B = 1, by n1: the fastest of
#: ``scripts/time_whole.py --fast``'s sweep (K1F and K2F, real forward and
#: complex inverse alike, with the split of :func:`whole_bf16_split`; H100
#: 80GB HBM3 at 700 W).
_BF16_B1_CLUSTER = {8: 8, 16: 8, 32: 8, 64: 8, 128: 8}
#: (table slots read, bf16 data operands) of each product form
#: (``csrc/mma_bf16.cuh``): real input Fr x, Fi x; Karatsuba; 4-product.
_BF16_FORMS = {"real2": (2, 1), "kara3": (3, 3), "four4": (2, 2)}
_BF16_MAX_THREADS = 512
_SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory, bytes
#: Dynamic shared memory the ``wgmma`` stage-A kernel (``csrc/dot_bf16.cuh``:
#: S3, S2F, K3F, K3LF) may opt into on an H100: a block's 232,448 bytes less
#: its two static 8-byte barriers.  Every block size it takes is a multiple
#: of 1,024, so none lies between this and 232,448.
SMEM_MAX = _SMEM_LIMIT - 16


def _bf16_forms(complex_: bool, packed: bool) -> tuple[str, str]:
    """Stage 1's and stage 2's product forms of K1F (``packed`` False) or
    K2F."""
    second = "four4" if packed else "kara3"
    return (second if complex_ else "real2"), second


def _bf16_mode(n1: int, cluster: int) -> str:
    """How the C blocks of a row of K1F / K2F share the work
    (``csrc/whole_bf16.cuh``'s ``Layout``): "local" (n1 <= 16 or C = 1: no
    cluster, every block runs stage 1 on all columns itself), "broadcast"
    (n1 = 32: x, F1 and the twiddle multicast to the cluster, every block
    runs stage 1 on all columns) or "exchange" (n1 >= 64: stage 1 split by
    columns, Z's columns sent to the blocks of their k1).  The fastest of
    ``time_whole --fast``'s sweep at each n1 (H100 80GB HBM3, 700 W)."""
    if cluster == 1 or n1 <= 16:
        return "local"
    return "broadcast" if n1 == 32 else "exchange"


def whole_bf16_split(n1: int, cluster: int) -> int:
    """The parts V that stage 2 of K1F / K2F splits k1 into: block r takes
    the rows j of part r // V of C / V and the columns k1 of part r % V.
    The exchange takes the most that keep k1 tiles of 16, so that each
    block's Z columns go only to the blocks of their k1 (at n = 16,384, 10.5
    KB a block through distributed shared memory instead of 84 KB); the
    other modes hold all of Z in every block."""
    return min(cluster, n1 // 16) if _bf16_mode(n1, cluster) == "exchange" else 1


def whole_bf16_slices(n1: int, cluster: int) -> list[tuple[range, range, range]]:
    """What block ``r`` of a row owns in K1F / K2F: the x columns c of its
    stage 1 (all 128 but with the exchange, each block computing the same
    Z), and the rows j and columns k1 of its stage 2 (so the outputs
    ``j * n1 + k1``)."""
    v = whole_bf16_split(n1, cluster)
    w = _N2 // cluster if _bf16_mode(n1, cluster) == "exchange" else _N2
    jr, kr = _N2 * v // cluster, n1 // v
    return [(range(r * w, r * w + w) if w < _N2 else range(_N2), range(r // v * jr, (r // v + 1) * jr),
             range(r % v * kr, (r % v + 1) * kr)) for r in range(cluster)]


def _bf16_block(n1: int, cluster: int, complex_: bool, packed: bool) -> tuple[int, int]:
    """(threads, dynamic shared memory bytes) of one K1F / K2F block, as
    ``csrc/whole_bf16.cuh``'s ``Layout`` has them.  Warps: one a unit of
    stage 1 (16 rows k1 x 16 columns c) or of stage 2 (16 rows j x 16
    columns k1, 8 at n1 = 8), at least 4.  Shared memory, bf16: F1's held
    slots (n1 padded to 16), the block's rows of F2's, x's operands for its
    stage-1 columns (rows of n1p + 8; the exchange stages its Z columns
    there, rows of columns + 8), Z's for its k1 and all 128 columns (rows
    of 136; the broadcast lands x's fp32 planes there first) and the
    broadcast's fp32 twiddle (rows of 136)."""
    f1, f2 = _bf16_forms(complex_, packed)
    (s1, o1), (s2, o2) = _BF16_FORMS[f1], _BF16_FORMS[f2]
    mode, v = _bf16_mode(n1, cluster), whole_bf16_split(n1, cluster)
    n1p, ld, bcast = max(n1, 16), _N2 + 8, mode == "broadcast"
    cols = _N2 // cluster if mode == "exchange" else _N2
    jr, kr, nt2 = _N2 * v // cluster, n1 // v, 1 if n1 < 16 else 2
    units1, units2 = n1p // 16 * (cols // 16), jr // 16 * (kr // (8 * nt2))
    end = (s1 * n1p * n1p + s2 * jr * _N2
           + max(o1 * cols * (n1p + 8), o2 * n1 * (cols + 8) if mode == "exchange" else 0)
           + max(o2 * kr * ld, 2 * (2 if complex_ else 1) * n1 * _N2 if bcast else 0) + (4 * n1 * ld if bcast else 0))
    return 32 * max(units1, units2, 4), 2 * end


def whole_bf16_smem_bytes(n1: int, cluster: int, complex_: bool, packed: bool = False) -> int:
    """Dynamic shared memory of one K1F / K2F block (:func:`_bf16_block`)."""
    return _bf16_block(n1, cluster, complex_, packed)[1]


def whole_bf16_traffic(n1: int, cluster: int, complex_: bool, packed: bool = False) -> list[dict]:
    """Bytes each block of a row of K1F / K2F reads: from L2 by source (x and
    the twiddle in fp32, the tables' bf16 images; ``f1`` / ``f2`` are the bulk
    copies the block issues, a multicast one landing in every block it
    names), and from its peers' shared memory (``peers``: Z's columns of its
    k1 that other blocks computed).  With the exchange or the broadcast the
    sums over the blocks are each source's bytes once: no byte of x, F1, F2
    or the twiddle leaves L2 twice within a row; without them (n1 <= 16, or
    C = 1) every block reads x, F1 and the twiddle itself."""
    mode, v = _bf16_mode(n1, cluster), whole_bf16_split(n1, cluster)
    f1, f2 = _bf16_forms(complex_, packed)
    (s1, _), (s2, o2) = _BF16_FORMS[f1], _BF16_FORMS[f2]
    planes, n1p, shared = 2 if complex_ else 1, max(n1, 16), mode != "local"
    w = _N2 // cluster if shared else _N2  # the x and twiddle columns (broadcast: its C-th) it reads
    jr, kr = _N2 * v // cluster, n1 // v
    return [{"x": 4 * planes * n1 * w, "twiddle": 8 * n1 * w, "f1": 2 * s1 * n1p * n1p // (cluster if shared else 1),
             "f2": 2 * s2 * jr * _N2 // v, "peers": 2 * o2 * kr * (_N2 - w) if mode == "exchange" else 0}
            for _ in range(cluster)]


def _bf16_fits(n1: int, cluster: int, complex_: bool, packed: bool) -> tuple[int, int] | None:
    """(threads, smem_bytes) of a cluster whose blocks fit, else None."""
    threads, smem = _bf16_block(n1, cluster, complex_, packed)
    return (threads, smem) if threads <= _BF16_MAX_THREADS and smem <= _SMEM_LIMIT else None


@functools.lru_cache(maxsize=None)
def whole_bf16_geometry(b: int, n1: int, complex_: bool, sms: int = DEFAULT_SMS,
                        packed: bool = False) -> tuple[int, int, int]:
    """(cluster, threads, smem_bytes) of K1F (K2F with ``packed``) for B =
    ``b`` rows of n = 128 * n1 points: ``cluster`` blocks a row (a thread-block
    cluster in the broadcast and the exchange, :func:`_bf16_mode`), each of
    ``threads`` threads, one warp a unit of the larger stage.  At B = 1 the
    cluster is the swept fastest; a larger batch halves it while the grid
    holds more blocks than the card has SMs (``sms``), down to the least
    cluster whose blocks fit 512 threads and the shared memory.  Kept per
    argument tuple: a call costs a lookup."""
    if n1 not in _BF16_B1_CLUSTER:
        raise ValueError(f"whole_bf16 kernel: n1 must be a power of two in [8, 128], got {n1}")
    fits = [c for c in (1, 2, 4, 8) if _bf16_fits(n1, c, complex_, packed)]
    cluster = max(_BF16_B1_CLUSTER[n1], fits[0])
    while cluster > fits[0] and b * cluster > sms:
        cluster //= 2
    return (cluster, *_bf16_fits(n1, cluster, complex_, packed))


def _whole_bf16_cuda(kernel: str, xr, xi, tables, packed: bool):
    img1, img2, twr, twi = tables
    b, n = xr.shape
    n1 = n // _N2
    slots = 2 if packed else 4
    m1 = max(n1, 16) // 16
    _check(kernel, xr.device, {"xr": xr, "xi": xi, "twr": twr, "twi": twi},
           {"xr": (b, n1 * _N2), "xi": (b, n1 * _N2), "twr": (n1, _N2), "twi": (n1, _N2)})
    _check(kernel, xr.device, {"img1": img1, "img2": img2},
           {"img1": (slots, m1, m1, 32, 8), "img2": (slots, 8, 8, 32, 8)}, dtype=torch.bfloat16)
    cluster, threads, smem = whole_bf16_geometry(b, n1, xi is not None, sm_count(xr.device), packed)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    _launch(
        COUNTS, kernel, _build.library().gft_whole_bf16,
        _ptr(xr), _ptr(xi), _ptr(img1), _ptr(img2), _ptr(twr), _ptr(twi), _ptr(yr), _ptr(yi), b, n1,
        int(packed), cluster, threads, smem, _stream(xr.device),
    )
    return yr, yi


def _whole_bf16_cpu(xr, xi, tables):
    COUNTS["whole_transform_bf16"].plain_calls += 1
    f1r, f1i, f1s, f1d, twr, twi, f2r, f2i, f2s, f2d = tables
    return _whole_bf16_plain(xr, xi, (f1r, f1i, f1s, f1d), twr, twi, (f2r, f2i, f2s, f2d))


def _whole_packed_bf16_cpu(xr, xi, tables):
    COUNTS["whole_transform_packed_bf16"].plain_calls += 1
    return whole_transform_packed_bf16_plain(xr, xi, {"packed": tables[0], "n1": xr.shape[1] // _N2})


def _whole_bf16_cuda_split(xr, xi, tables):
    return _whole_bf16_cuda("whole_transform_bf16", xr, xi, tables, False)


def _whole_bf16_cuda_packed(xr, xi, tables):
    return _whole_bf16_cuda("whole_transform_packed_bf16", xr, xi, tables, True)


_STAGE_A_BF16_F1 = ("f1r", "f1i", "f1s", "f1d")
_TWIDDLE_FACTORS = ("two_r", "two_i", "twi_r", "twi_i")
_TWIDDLE_TABLE = ("twr", "twi")


def _stage_a_bf16_sliced(xr, xi, t: dict, r: int, ncols: int, col_tile: int):
    """Plain K3F / K3LF on the first ``r`` rows and ``ncols`` columns: the
    JAX body's dots on bf16-rounded operands, the twiddle in fp32."""
    sliced = _sliced_tables(t, r, ncols, col_tile)
    twr, twi = _stage_a_twiddle(sliced)
    pr, pi = _bf16_dots(*(sliced[k] for k in _STAGE_A_BF16_F1), xr[:, :, :ncols],
                        None if xi is None else xi[:, :, :ncols])
    return pr * twr - pi * twi, pr * twi + pi * twr


def _f1_group(kernel: str, tables) -> None:
    missing = [k for k in _STAGE_A_BF16_F1 if k not in tables]
    if missing:
        raise ValueError(f"{kernel} needs the plan's F1 group {_STAGE_A_BF16_F1}; missing {missing}")


def stage_a_bf16_plain(xr, xi, n1, n2, tables, col_tile, col_tiles=None, rows=None):
    """Plain torch version of :func:`stage_a_bf16` (K3F / K3LF)."""
    _f1_group("stage_a_bf16", tables)
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    return _stage_a_bf16_sliced(xr, xi, tables, r, ncols, col_tile)


#: K3F / K3LF's product forms (``csrc/dot_bf16.cuh``) by complex input:
#: (output rows a 64-row group, F parts a group, bf16 operands of x, staged
#: planes a group); real input X1 on S2's pair stacking, complex Kara3 (its
#: tile's columns split over two warpgroups a group).
_STAGE_A_BF16_FORMS = {False: (32, 1, 1, 1), True: (64, 3, 3, 2)}
#: The groups a block (``wgs``) that ``csrc/stage_a_bf16.cu`` instantiates.
_STAGE_A_BF16_WGS = {False: (1, 2, 3, 4), True: (1, 2)}
_BN = 64  # x columns of a wgmma tile


def _stage_a_bf16_shape(b: int, n1: int, n2: int, rows: int, ncols: int) -> None:
    """K3F / K3LF's limits (``csrc/stage_a_bf16.cu:refused``); ValueError
    for any other shape."""
    if b < 1 or n1 % 16 or not 16 <= n1 <= 512 or rows % 8 or not 8 <= rows <= n1 or n2 % 2 or ncols % 32 \
            or not 32 <= ncols <= n2:
        raise ValueError(f"stage_a_bf16 kernel needs B >= 1, n1 a multiple of 16 in [16, 512], rows a multiple of "
                         f"8 in [8, n1], n2 even and the kept columns a multiple of 32 (B={b}, n1={n1}, n2={n2}, "
                         f"rows={rows}, columns={ncols})")


def stage_a_bf16_streamed(n1: int, wgs: int, complex_: bool) -> bool:
    """Whether K3F / K3LF stream F's parts through two chunk buffers: where
    ``wgs`` groups' parts at every depth do not fit a block (complex input
    at n1 > 320), as ``csrc/stage_a_bf16.cu`` decides."""
    return stage_a_bf16_smem_bytes(n1, wgs, complex_, False) > SMEM_MAX


def stage_a_bf16_smem_bytes(n1: int, wgs: int, complex_: bool, streamed: bool | None = None) -> int:
    """Dynamic shared memory of a K3F / K3LF block of ``wgs`` groups
    (``csrc/dot_bf16.cuh:dot_smem_bytes``): the F parts of its groups, every
    64-deep chunk (two when streamed; None: as the kernel decides), two x
    chunk buffers of every operand (64 deep, 64 columns), the staging tile
    (64 rows of 72 floats a plane and group) and 1,024 bytes of
    alignment slack."""
    _, parts, ops, planes = _STAGE_A_BF16_FORMS[complex_]
    if streamed is None:
        streamed = stage_a_bf16_streamed(n1, wgs, complex_)
    chunks = 2 if streamed else -(-n1 // 64)
    return parts * chunks * 64 * wgs * 128 + 2 * ops * _BN * 128 + 64 * planes * wgs * (_BN + 8) * 4 + 1024


def stage_a_bf16_groups(rows: int, complex_: bool) -> int:
    """The 64-row groups of F1's image a launch reads for the first ``rows``
    output rows: ceil(rows / 32) on real input, ceil(rows / 64) on complex."""
    return -(-rows // _STAGE_A_BF16_FORMS[complex_][0])


def stage_a_bf16_launch_shapes(b: int, n1: int, n2: int, rows: int, ncols: int, complex_: bool,
                               sms: int = DEFAULT_SMS) -> list[tuple[int, int, int]]:
    """Every launch shape (wgs, row_blocks, grid) K3F / K3LF take for a
    (``b``, n1, n2) view, the first ``rows`` rows and ``ncols`` columns, on a
    card of ``sms`` SMs, the launch rule's pick first.  A block holds ``wgs``
    groups (:func:`stage_a_bf16_groups`), one warpgroup each (two on complex
    input), within :data:`SMEM_MAX` (resident where any block size fits,
    else streamed);
    ``row_blocks`` = ceil(groups / wgs), fewest first, each with the least
    ``wgs`` that gives that count (so the row blocks hold equal shares);
    ``grid`` = row_blocks x min(column tiles of all B signals, one and then
    two blocks an SM per row block).  Raises ValueError for a shape the
    kernel does not take."""
    _stage_a_bf16_shape(b, n1, n2, rows, ncols)
    groups = stage_a_bf16_groups(rows, complex_)
    tiles = b * -(-ncols // _BN)
    options = _STAGE_A_BF16_WGS[complex_]
    fits = [w for w in options if stage_a_bf16_smem_bytes(n1, w, complex_, False) <= SMEM_MAX]
    if not fits:
        fits = [w for w in options if stage_a_bf16_smem_bytes(n1, w, complex_, True) <= SMEM_MAX]
    shapes = []
    for row_blocks in sorted({-(-groups // w) for w in fits}):
        wgs = -(-groups // row_blocks)
        shapes += [(wgs, row_blocks, row_blocks * min(tiles, max(1, f * sms // row_blocks))) for f in (1, 2)]
    return list(dict.fromkeys(shapes))


@functools.lru_cache(maxsize=None)
def stage_a_bf16_geometry(b: int, n1: int, n2: int, rows: int, ncols: int, complex_: bool,
                          sms: int = DEFAULT_SMS) -> tuple[int, int, int]:
    """K3F / K3LF's launch shape (wgs, row_blocks, grid): the first of
    :func:`stage_a_bf16_launch_shapes`, the fewest row blocks (one at every
    shape the main path gives with n1 <= 128, so x is read once) on one
    block an SM.  Kept per argument tuple: a call costs a lookup."""
    return stage_a_bf16_launch_shapes(b, n1, n2, rows, ncols, complex_, sms)[0]


def stage_a_bf16_cover(b: int, n1: int, n2: int, rows: int, ncols: int, complex_: bool,
                       geometry: tuple[int, int, int]) -> list[tuple[int, range, list[tuple[int, int]]]]:
    """What each block of a K3F / K3LF launch owns (``csrc/dot_bf16.cuh``'s
    walk): for block i, its output rows k1 < ``rows`` (its row block's
    groups) and its (b, first column) tiles, from ``geometry`` (wgs,
    row_blocks, grid)."""
    wgs, row_blocks, grid = geometry
    gr = _STAGE_A_BF16_FORMS[complex_][0]
    per_rb, col_tiles = grid // row_blocks, -(-ncols // _BN)
    out = []
    for i in range(grid):
        rb, first = divmod(i, per_rb)
        k1 = range(rb * wgs * gr, min(rows, (rb + 1) * wgs * gr))
        tiles = [divmod(t, col_tiles) for t in range(first, b * col_tiles, per_rb)]
        out.append((i, k1, [(tb, tc * _BN) for tb, tc in tiles]))
    return out


def stage_a_bf16(xr, xi, n1: int, n2: int, tables, col_tile: int, col_tiles=None, rows=None):
    """K3F / K3LF: :func:`stage_a` as the JAX body computes it under "fast"
    (real input Fr x and Fi x, complex the Karatsuba three, x rounded to
    bf16, fp32 accumulation, the twiddle in fp32), on the tensor cores.
    ``tables``: :func:`plan.get_stage_a_plan` (factored twiddle, K3F) or a
    legacy plan with the F1 group and a materialized (n1, n2) ``twr``/``twi``
    pair (K3LF, counted as ``stage_a_legacy_bf16``); same arguments and
    result as :func:`stage_a`.  Off the CPU it needs B >= 1, n1 a multiple of
    16 up to 512, the kept columns a multiple of 32 and n2 and a factored ct
    even; another shape raises ValueError before the device is looked at.
    The launch shape comes from :func:`stage_a_bf16_geometry`, F1's image
    from :func:`bf16_images` (built once per plan)."""
    _f1_group("stage_a_bf16", tables)
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    names = _TWIDDLE_FACTORS if "two_r" in tables else _TWIDDLE_TABLE
    if xr.device.type == "cpu":
        return _OPS.stage_a_bf16(xr, xi, [tables[k] for k in (*_STAGE_A_BF16_F1, *names)], n1, n2, col_tile, r,
                                 ncols)
    _stage_a_bf16_shape(xr.shape[0], n1, n2, r, ncols)
    if "two_r" in tables and col_tile % 2:
        raise ValueError(f"stage_a_bf16 kernel needs a factored ct even (ct={col_tile})")
    _on_cpu(xr, "stage_a_bf16")  # raises for any device but CUDA
    (img,) = bf16_images(tables)
    return _OPS.stage_a_bf16(xr, xi, [img, *(tables[k] for k in names)], n1, n2, col_tile, r, ncols)


def _stage_a_bf16_cpu(xr, xi, tables, n1, n2, col_tile, rows, ncols):
    """The operator's CPU kernel: the F1 group then four twiddle factors
    (K3F) or the two planes of a table (K3LF)."""
    names = _TWIDDLE_FACTORS if len(tables) == 8 else _TWIDDLE_TABLE
    COUNTS["stage_a_bf16" if len(tables) == 8 else "stage_a_legacy_bf16"].plain_calls += 1
    t = dict(zip((*_STAGE_A_BF16_F1, *names), tables))
    return _stage_a_bf16_sliced(xr, xi, t, rows, ncols, col_tile)


def stage_a_bf16_image_shape(n1: int) -> tuple[int, int, int, int]:
    """The shape of :func:`stage_a_bf16_image` for n1."""
    chunks = -(-n1 // 64)
    return -(-n1 // _PAIR) + 3 * chunks, chunks, 64, 64


def stage_a_bf16_launch(xr, xi, tables: list, n1: int, n2: int, col_tile: int, rows: int, ncols: int,
                        geometry: tuple[int, int, int]):
    """Launch K3F ([img, two_r, two_i, twi_r, twi_i]) or K3LF ([img, twr,
    twi]) on CUDA tensors with ``geometry``, one of
    :func:`stage_a_bf16_launch_shapes` (a sweep times each)."""
    img, *tw = tables
    factored = len(tw) == 4
    b = xr.shape[0]
    if factored:
        outer, inner = (n1, n2 // col_tile), (n1, col_tile)
        shapes = dict(two_r=outer, two_i=outer, twi_r=inner, twi_i=inner)
    else:
        shapes = dict(twr=(n1, n2), twi=(n1, n2))
    _check("stage_a_bf16", xr.device, {"xr": xr, "xi": xi, **dict(zip(shapes, tw))},
           {"xr": (b, n1, n2), "xi": (b, n1, n2), **shapes})
    _check("stage_a_bf16", xr.device, {"img": img}, {"img": stage_a_bf16_image_shape(n1)}, dtype=torch.bfloat16)
    wgs, _, grid = geometry
    yr = torch.empty((b, rows, ncols), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    lib = _build.library()
    ptrs = (_ptr(xr), _ptr(xi), _ptr(img), *(_ptr(t) for t in tw), _ptr(yr), _ptr(yi))
    if factored:
        _launch(COUNTS, "stage_a_bf16", lib.gft_stage_a_bf16, *ptrs, b, n1, n2, col_tile, rows, ncols, wgs,
                grid, _stream(xr.device))
    else:
        _launch(COUNTS, "stage_a_legacy_bf16", lib.gft_stage_a_bf16_full, *ptrs, b, n1, n2, rows, ncols, wgs,
                grid, _stream(xr.device))
    return yr, yi


def _stage_a_bf16_cuda(xr, xi, tables, n1, n2, col_tile, rows, ncols):
    """The operator's CUDA kernel: [img, two_r, two_i, twi_r, twi_i] launches
    K3F, [img, twr, twi] K3LF, on :func:`stage_a_bf16_geometry`'s shape."""
    geometry = stage_a_bf16_geometry(xr.shape[0], n1, n2, rows, ncols, xi is not None, sm_count(xr.device))
    return stage_a_bf16_launch(xr, xi, tables, n1, n2, col_tile, rows, ncols, geometry)


# ── The operators ────────────────────────────────────────────────────────────
#
# Defined with ``torch.library.Library`` (a schema and one Python kernel per
# dispatch key) rather than ``torch.library.custom_op``, whose autograd
# wrapper runs Python on every call: the autograd Functions of
# ``kernels/large.py`` already sit around these operators.

_LIB = torch.library.Library("gpu_fft_tpu_torch", "DEF")
_SCHEMAS = {
    "whole_transform": ("(Tensor xr, Tensor? xi, Tensor[] tables) -> (Tensor, Tensor)",
                        _whole_transform_cpu, _whole_transform_cuda, _whole_fake),
    "whole_transform_packed": ("(Tensor xr, Tensor? xi, Tensor[] tables) -> (Tensor, Tensor)",
                               _whole_transform_packed_cpu, _whole_transform_packed_cuda, _whole_fake),
    "stage_a": ("(Tensor xr, Tensor? xi, Tensor[] tables, int n1, int n2, int col_tile, int rows, int ncols)"
                " -> (Tensor, Tensor)", _stage_a_cpu, _stage_a_cuda, _stage_a_fake),
    "whole_transform_bf16": ("(Tensor xr, Tensor? xi, Tensor[] tables) -> (Tensor, Tensor)",
                             _whole_bf16_cpu, _whole_bf16_cuda_split, _whole_fake),
    "whole_transform_packed_bf16": ("(Tensor xr, Tensor? xi, Tensor[] tables) -> (Tensor, Tensor)",
                                    _whole_packed_bf16_cpu, _whole_bf16_cuda_packed, _whole_fake),
    "stage_a_bf16": ("(Tensor xr, Tensor? xi, Tensor[] tables, int n1, int n2, int col_tile, int rows, "
                     "int ncols) -> (Tensor, Tensor)", _stage_a_bf16_cpu, _stage_a_bf16_cuda, _stage_a_fake),
    "stage_b": ("(Tensor yr, Tensor yi, Tensor[] tables, int n1, float scale) -> (Tensor, Tensor)",
                _stage_b_cpu, _stage_b_cuda, _stage_b_fake),
}
for _name, (_schema, _cpu, _cuda, _fake) in _SCHEMAS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"gpu_fft_tpu_torch::{_name}", _fake, lib=_LIB)
_OPS = torch.ops.gpu_fft_tpu_torch
