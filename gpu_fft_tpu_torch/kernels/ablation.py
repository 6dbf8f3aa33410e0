"""Wrappers of the stage-A ablation kernels, each beside its plain version.

Two Pallas kernels of the JAX package's ablation harnesses are CUDA kernels
here:

* ``stage_a_manual`` (S2, ``scripts/ablate_2e20_levers.py:stage_a_manual``):
  stage A at B = 1 on real input with a materialized twiddle: the dense
  core of ``csrc/dense_f32.cuh`` on the stacked table of
  :func:`manual_tables`, the twiddle in its epilogue
  (``csrc/stage_a_manual.cu``; column tile from :func:`manual_geometry`).
  Under ``GPU_FFT_TPU_PRECISION=fast``, where the JAX kernel's dots take
  bf16x1, it is ``stage_a_manual_bf16`` (S2F): S3's bf16 ``wgmma`` core
  (``csrc/dot_bf16.cuh``) on the same stacking's bf16 image, the twiddle in
  its epilogue (``csrc/stage_a_manual_bf16.cu``; launch shape from
  :func:`manual_bf16_geometry`);
* ``stage_a_dot`` (S3, ``scripts/ablate_mosaic_x6.py:build``): the two
  stage-A dots Yr = Fr x, Yi = Fi x in three precisions, ``f32_highest``
  (a register-tiled product on the CUDA cores, ``csrc/dense_f32.cuh``),
  ``bf16_x6`` (the 6-term bf16 ladder on ``wgmma``) and ``bf16_x1`` (one
  bf16 product) (``csrc/stage_a_dot.cu``; launch shape from
  :func:`dot_geometry`).

As in :mod:`.fused`, a wrapper runs its plain torch version for a tensor on
the CPU and launches its kernel or raises for a CUDA tensor; ``COUNTS[name]``
counts both.  Under CUDA-graph capture a wrapper counts a launch when it is
captured, not when the graph is replayed.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import (
    DEFAULT_SMS,
    SMEM_MAX,
    LaunchCount,
    _bf16_dots,
    _check,
    _fast,
    _launch,
    _on_cpu,
    _ptr,
    _stream,
    pair_stacking,
    sm_count,
    stage_a_plain,
    swizzled_image,
)

__all__ = [
    "COUNTS",
    "SMEM_MAX",
    "VARIANTS",
    "dot_geometry",
    "dot_launch",
    "dot_launch_shapes",
    "dot_smem_bytes",
    "dot_tables",
    "manual_bf16_geometry",
    "manual_bf16_launch",
    "manual_geometry",
    "manual_launch",
    "manual_launch_shapes",
    "manual_tables",
    "reset_counts",
    "split3_bf16",
    "stage_a_dot",
    "stage_a_dot_plain",
    "stage_a_manual",
    "stage_a_manual_bf16",
    "stage_a_manual_bf16_plain",
    "stage_a_manual_plain",
    "swizzled_image",
]

VARIANTS = ("f32_highest", "bf16_x6", "bf16_x1")

COUNTS = {"stage_a_manual": LaunchCount(), "stage_a_manual_bf16": LaunchCount(),
          **{f"stage_a_dot_{v}": LaunchCount() for v in VARIANTS}}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


# ── S2: stage A on a materialized twiddle, one dense product ────────────────


_PAIR = 32  # output rows a 64-row block of the stacked table holds


def manual_tables(tables: dict) -> dict:
    """``tables`` (a legacy stage-A plan: ``f1r``/``f1i`` (n1, n1), a
    materialized (n1, n2) ``twr``/``twi``) with S2's stacked table added in
    the two forms its kernels read, built once per plan as
    :func:`dot_tables` builds ``f_t`` and ``f_img``: the stacking is, for
    every 32 output rows k1, their Fr rows then their Fi rows as one 64-row
    block, so that rows 32 apart are Re and Im of one output row.
    ``f_stack`` (n1, 2 n1) fp32 is that stacking transposed, so that a
    block's 64 rows are a run of 16-byte copies (S2); ``f_img`` is its bf16
    :func:`swizzled_image`, one part (S2F).  n1 must be a multiple of 32."""
    fr, fi = tables["f1r"], tables["f1i"]
    n1 = fr.shape[0]
    if n1 % _PAIR:
        raise ValueError(f"stage_a_manual: n1={n1} is not a multiple of {_PAIR}")
    stack = pair_stacking(fr, fi).to(torch.float32)
    return {**tables, "f_stack": stack.t().contiguous(),
            "f_img": swizzled_image(stack.to(torch.bfloat16)[None])}


def manual_launch_shapes(n1: int, n2: int) -> list[int]:
    """Every column tile ``bn`` S2's kernel takes for x (n1, n2), the launch
    rule's pick first: 64, then 128 where it divides n2 (a block of ``bn``
    threads a 64-row block and a tile, one wave).  Raises ValueError for a
    shape the kernel cannot take: n1 a multiple of 32 in [32, 256], n2 of
    64."""
    _manual_shape("stage_a_manual", n1, n2)
    return [bn for bn in (64, 128) if n2 % bn == 0]


def _manual_shape(kernel: str, n1: int, n2: int) -> None:
    """S2's and S2F's shapes: n1 a multiple of 32 in [32, 256], n2 of 64."""
    if n1 % 32 or not 32 <= n1 <= 256 or n2 < 64 or n2 % 64:
        raise ValueError(
            f"{kernel} kernel needs n1 in [32, 256] a multiple of 32 and n2 a multiple "
            f"of 64 (n1={n1}, n2={n2})"
        )


def manual_geometry(n1: int, n2: int) -> int:
    """S2's column tile: the first of :func:`manual_launch_shapes`, 64.  The
    faster of the two in ``scripts/time_stage_a.py --legacy --sweep`` at
    2^20 with n1 = 128 and 256 on an H100 80GB HBM3 at 700 W (PERF.md,
    section 6): 512 blocks of 64 threads spread more evenly over 132 SMs
    than 256 of 128."""
    return manual_launch_shapes(n1, n2)[0]


def stage_a_manual_plain(x, tables: dict):
    """Plain torch version of :func:`stage_a_manual`: :func:`.fused.stage_a_plain`
    on the legacy plan, all rows and columns."""
    n1, n2 = x.shape
    yr, yi = stage_a_plain(x[None], None, n1, n2, tables, n2)
    return yr[0], yi[0]


def stage_a_manual(x, tables: dict):
    """(F1 x) * (twr + i twi) for real x (n1, n2) (JAX: the ``stage_a_manual``
    closure of ``scripts/ablate_2e20_levers.py``).

    ``tables``: a legacy stage-A plan on ``x``'s device, with ``f1r``/``f1i``
    (n1, n1) and a materialized (n1, n2) ``twr``/``twi``, and for a CUDA
    ``x`` the stacked table of :func:`manual_tables`.  Returns split-complex
    (n1, n2).  Under "fast" it is :func:`stage_a_manual_bf16` (S2F).
    """
    if _fast():
        return stage_a_manual_bf16(x, tables)
    if _on_cpu(x, "stage_a_manual"):
        COUNTS["stage_a_manual"].plain_calls += 1
        return stage_a_manual_plain(x, tables)
    return manual_launch(x, tables, manual_geometry(*x.shape))


def manual_launch(x, tables: dict, bn: int):
    """Launch S2's kernel on a CUDA ``x`` with the column tile ``bn``, one
    of :func:`manual_launch_shapes` (a sweep times each)."""
    n1, n2 = x.shape
    if "f_stack" not in tables:
        raise ValueError("stage_a_manual: the tables lack f_stack; build them with manual_tables")
    names = ("f_stack", "twr", "twi")
    shapes = {"x": (n1, n2), "f_stack": (n1, 2 * n1), "twr": (n1, n2), "twi": (n1, n2)}
    _check("stage_a_manual", x.device, {"x": x, **{k: tables[k] for k in names}}, shapes)
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    _launch(
        COUNTS, "stage_a_manual", _build.library().gft_stage_a_manual,
        _ptr(x), *(_ptr(tables[k]) for k in names), _ptr(yr), _ptr(yi), n1, n2, bn, _stream(x.device),
    )
    return yr, yi


# ── S2F: S2 under "fast", on the bf16 tensor cores ─────────────────────────


def manual_bf16_geometry(n1: int, n2: int, sms: int = DEFAULT_SMS) -> tuple:
    """S2F's launch shape (wgs, grid), the arguments its C entry takes after
    the shape: :func:`dot_geometry`'s bf16_x1 rule at B = 1 (S2F is S3's
    bf16 x1 kernel with another epilogue): at 2^20 all 256 stacked rows a
    block for n1 = 128, 256 of 512 for n1 = 256.  Raises ValueError for a
    shape S2 does not take (n1 a multiple of 32 in [32, 256], n2 of 64)."""
    _manual_shape("stage_a_manual_bf16", n1, n2)
    return dot_geometry(1, n1, n2, "bf16_x1", sms)


def stage_a_manual_bf16_plain(x, tables: dict):
    """Plain torch version of :func:`stage_a_manual_bf16`: Fr x and Fi x on
    bf16-rounded operands with fp32 sums, the table twiddle in fp32 (K3LF's
    plain version at B = 1, all rows and columns)."""
    pr, pi = _bf16_dots(tables["f1r"], tables["f1i"], None, None, x, None)
    twr, twi = tables["twr"], tables["twi"]
    return pr * twr - pi * twi, pr * twi + pi * twr


def stage_a_manual_bf16(x, tables: dict):
    """S2F: :func:`stage_a_manual` as the JAX kernel computes it under "fast"
    (its dots at bf16x1: Fr, Fi and x rounded to bf16, fp32 accumulation;
    the twiddle in fp32).  ``tables``: :func:`manual_tables` of a legacy
    plan on ``x``'s device (the CPU reads only ``f1r``, ``f1i``, ``twr``,
    ``twi``).  Off the CPU a shape S2 does not take raises ValueError before
    the device is looked at."""
    if x.device.type == "cpu":
        COUNTS["stage_a_manual_bf16"].plain_calls += 1
        return stage_a_manual_bf16_plain(x, tables)
    geometry = manual_bf16_geometry(*x.shape, sm_count(x.device))
    _on_cpu(x, "stage_a_manual_bf16")  # raises for any device but CUDA
    return manual_bf16_launch(x, tables, geometry)


def manual_bf16_launch(x, tables: dict, geometry: tuple):
    """Launch S2F on a CUDA ``x`` with ``geometry``, one of
    :func:`dot_launch_shapes` for bf16_x1 at B = 1."""
    n1, n2 = x.shape
    if "f_img" not in tables:
        raise ValueError("stage_a_manual_bf16: the tables lack f_img; build them with manual_tables")
    _check("stage_a_manual_bf16", x.device, {"x": x, "twr": tables["twr"], "twi": tables["twi"]},
           {"x": (n1, n2), "twr": (n1, n2), "twi": (n1, n2)})
    _check("stage_a_manual_bf16", x.device, {"f_img": tables["f_img"]},
           {"f_img": (2 * n1 // 64, 1, -(-n1 // 64), 64, 64)}, dtype=torch.bfloat16)
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    _launch(
        COUNTS, "stage_a_manual_bf16", _build.library().gft_stage_a_manual_bf16,
        _ptr(x), _ptr(tables["f_img"]), _ptr(tables["twr"]), _ptr(tables["twi"]), _ptr(yr), _ptr(yi), n1, n2,
        *geometry, _stream(x.device),
    )
    return yr, yi


# ── S3: the stage-A dot in three precisions ──────────────────────────────────


def split3_bf16(a: torch.Tensor):
    """Exact-sum 3-term bf16 split of an f32 tensor (hi + mid + lo ~ a); each
    rounding is to nearest even, as numpy's ``astype`` does."""
    a = a.to(torch.float32)
    t1 = a.to(torch.bfloat16)
    r1 = a - t1.float()
    t2 = r1.to(torch.bfloat16)
    r2 = r1 - t2.float()
    return t1, t2, r2.to(torch.bfloat16)


def dot_tables(fr: torch.Tensor, fi: torch.Tensor) -> dict:
    """The constant (n1, n1) LHS pair in the forms the variants read: f32
    ``fr``/``fi`` and their bf16 splits ``fr_bf16``/``fi_bf16`` (3, n1, n1),
    split once on the host side of the kernel as the JAX harness does (the
    plain versions read these); and for the kernels the stacked LHS
    [Fr; Fi]: ``f_t`` (n1, 2 n1) fp32, transposed so that a block's slice
    of it is a run of 16-byte copies, and ``f_img``, the parts stacked
    row-wise as :func:`swizzled_image` lays them out."""
    fr_bf16 = torch.stack(split3_bf16(fr)).contiguous()
    fi_bf16 = torch.stack(split3_bf16(fi)).contiguous()
    return {
        "fr": fr.contiguous(), "fi": fi.contiguous(),
        "fr_bf16": fr_bf16, "fi_bf16": fi_bf16,
        "f_t": torch.cat([fr, fi]).to(torch.float32).t().contiguous(),
        "f_img": swizzled_image(torch.cat([fr_bf16, fi_bf16], dim=1)),
    }


_BN = 64  # x columns per bf16 tile (the wgmma N)


def dot_smem_bytes(parts: int, wgs: int, n1: int) -> int:
    """Dynamic shared memory of the bf16 kernel (``csrc/stage_a_dot.cu:
    dot_smem_bytes``): the F parts of 64 * ``wgs`` stacked rows, depth
    padded to 64, two x chunk buffers (64 deep, 64 columns, every part),
    the padded fp32 staging tile and 1,024 bytes of alignment slack."""
    return (parts * -(-n1 // 64) * 64 * wgs * 128 + 2 * parts * _BN * 128
            + 64 * wgs * (_BN + 8) * 4 + 1024)


def dot_launch_shapes(b: int, n1: int, n2: int, variant: str, sms: int = DEFAULT_SMS) -> list[tuple]:
    """Every launch shape the S3 kernel of ``variant`` takes for x (``b``,
    n1, n2) on a card of ``sms`` SMs, the launch rule's pick first: the
    arguments the C entry point takes after the shape.  Both kernels take
    n1 a multiple of 32 and n2 of 64; raises ValueError for any other shape.

    ``f32_highest``: ``()``: one 64 x 64 block tile of the stacked (2 n1, n2)
    product a block, B <= 65,535 (the grid's z).

    ``bf16_x6`` / ``bf16_x1``: (wgs, grid): 64 * ``wgs`` stacked rows a
    block (4, 2 or 1 warpgroups, dividing 2 n1, the block within
    :data:`SMEM_MAX`: x6 takes n1 <= 384, x1 n1 <= 1,472), largest first,
    each with a persistent grid of row blocks times min(column tiles, one
    and then two blocks an SM per row block)."""
    _check_variant(variant)
    if n1 < 32 or n1 % 32 or n2 < _BN or n2 % _BN or b < 1:
        raise ValueError(f"stage_a_dot kernels need n1 a multiple of 32, n2 a multiple of 64 "
                         f"and B >= 1 (B={b}, n1={n1}, n2={n2})")
    if variant == "f32_highest":
        if b > 65535:
            raise ValueError(f"stage_a_dot f32 kernel needs B <= 65535 (B={b})")
        return [()]
    parts = 3 if variant == "bf16_x6" else 1
    shapes = []
    for wgs in (4, 2, 1):
        row_blocks = 2 * n1 // (64 * wgs)
        if (2 * n1) % (64 * wgs) or dot_smem_bytes(parts, wgs, n1) > SMEM_MAX:
            continue
        per_rb = (min(b * n2 // _BN, max(1, f * sms // row_blocks)) for f in (1, 2))
        shapes += [(wgs, row_blocks * p) for p in dict.fromkeys(per_rb)]
    if not shapes:
        raise ValueError(f"stage_a_dot {variant} kernel: the F parts of n1={n1} do not fit a block's "
                         f"shared memory (x6 takes n1 <= 384, x1 n1 <= 1472)")
    return shapes


def dot_geometry(b: int, n1: int, n2: int, variant: str, sms: int = DEFAULT_SMS) -> tuple:
    """The S3 kernels' launch shape: the first of :func:`dot_launch_shapes`,
    the fastest of ``scripts/time_dot.py --sweep`` at (1, 128, 8192) on an
    H100 80GB HBM3 at 700 W.  For bf16 it is the most stacked rows a block
    that fit (all 256 for x1 at n1 = 128, so x is read and split once; 128
    for x6) on one block an SM."""
    return dot_launch_shapes(b, n1, n2, variant, sms)[0]


def _x6(a, xs):
    """``_x6``'s ladder a1b1 + (a1b2 + a2b1) + (a1b3 + a2b2 + a3b1), each
    product an fp32 matmul of bf16-valued operands (exact per product)."""
    a1, a2, a3 = a
    x1, x2, x3 = xs
    return a1 @ x1 + (a1 @ x2 + a2 @ x1) + (a1 @ x3 + a2 @ x2 + a3 @ x1)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"stage_a_dot: variant {variant!r} is not one of {VARIANTS}")


def stage_a_dot_plain(x, tables: dict, variant: str):
    """Plain torch version of :func:`stage_a_dot`, with the kernel's
    rounding: bf16 parts taken with ``.to(torch.bfloat16).float()`` and each
    product an fp32 matmul (a bf16 matmul would round its output to bf16)."""
    _check_variant(variant)
    if variant == "f32_highest":
        return tables["fr"] @ x, tables["fi"] @ x
    if variant == "bf16_x1":
        xb = x.to(torch.bfloat16).float()
        return tables["fr_bf16"][0].float() @ xb, tables["fi_bf16"][0].float() @ xb
    xs = [p.float() for p in split3_bf16(x)]
    return _x6(tables["fr_bf16"].float(), xs), _x6(tables["fi_bf16"].float(), xs)


def stage_a_dot(x, tables: dict, variant: str):
    """Yr = Fr x and Yi = Fi x for x (B, n1, n2) in one of :data:`VARIANTS`
    (JAX: ``scripts/ablate_mosaic_x6.py:build``'s kernels).

    ``tables``: :func:`dot_tables` on ``x``'s device.  Returns fp32
    (B, n1, n2) twice.
    """
    _check_variant(variant)
    if _on_cpu(x, "stage_a_dot"):
        COUNTS[f"stage_a_dot_{variant}"].plain_calls += 1
        return stage_a_dot_plain(x, tables, variant)
    b, n1, n2 = x.shape
    return dot_launch(x, tables, variant, dot_geometry(b, n1, n2, variant, sm_count(x.device)))


def dot_launch(x, tables: dict, variant: str, geometry: tuple):
    """Launch the S3 kernel of ``variant`` on a CUDA ``x`` with ``geometry``,
    one of :func:`dot_launch_shapes` (a sweep times each)."""
    b, n1, n2 = x.shape
    lib = _build.library()
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    stream = _stream(x.device)
    _check("stage_a_dot", x.device, {"x": x}, {"x": (b, n1, n2)})
    kernel = f"stage_a_dot_{variant}"
    if variant == "f32_highest":
        _check("stage_a_dot", x.device, {"f_t": tables["f_t"]}, {"f_t": (n1, 2 * n1)})
        _launch(COUNTS, kernel, lib.gft_stage_a_dot_f32, _ptr(x), _ptr(tables["f_t"]), _ptr(yr), _ptr(yi),
                b, n1, n2, stream)
    else:
        img = (2 * n1 // 64, 3, -(-n1 // 64), 64, 64)
        _check("stage_a_dot", x.device, {"f_img": tables["f_img"]}, {"f_img": img}, dtype=torch.bfloat16)
        parts = 3 if variant == "bf16_x6" else 1
        _launch(COUNTS, kernel, lib.gft_stage_a_dot_bf16, _ptr(x), _ptr(tables["f_img"]), _ptr(yr), _ptr(yi),
                b, n1, n2, parts, *geometry, stream)
    return yr, yi
