"""Wrappers of the stage-A ablation kernels, each beside its plain version.

Two Pallas kernels of the JAX package's ablation harnesses are CUDA kernels
here:

* ``stage_a_manual`` (S2, ``scripts/ablate_2e20_levers.py:stage_a_manual``):
  stage A at B = 1 on real input with a materialized twiddle, F1 resident and
  the column tiles pipelined by hand (``csrc/stage_a_manual.cu``);
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
from .fused import DEFAULT_SMS, LaunchCount, _check, _on_cpu, _ptr, _stream, sm_count, stage_a_plain

__all__ = [
    "COUNTS",
    "SMEM_MAX",
    "VARIANTS",
    "dot_geometry",
    "dot_launch",
    "dot_launch_shapes",
    "dot_smem_bytes",
    "dot_tables",
    "reset_counts",
    "split3_bf16",
    "stage_a_dot",
    "stage_a_dot_plain",
    "stage_a_manual",
    "stage_a_manual_plain",
    "swizzled_image",
]

VARIANTS = ("f32_highest", "bf16_x6", "bf16_x1")

COUNTS = {"stage_a_manual": LaunchCount(), **{f"stage_a_dot_{v}": LaunchCount() for v in VARIANTS}}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


# ── S2: stage A with F1 resident and a hand-pipelined column loop ───────────


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
    (n1, n1) and a materialized (n1, n2) ``twr``/``twi``.  Returns
    split-complex (n1, n2).
    """
    count = COUNTS["stage_a_manual"]
    if _on_cpu(x, "stage_a_manual"):
        count.plain_calls += 1
        return stage_a_manual_plain(x, tables)
    n1, n2 = x.shape
    if n1 % 32 or not 32 <= n1 <= 256 or n2 % 64:
        raise ValueError(
            f"stage_a_manual kernel needs n1 in [32, 256] a multiple of 32 and n2 a multiple "
            f"of 64 (n1={n1}, n2={n2})"
        )
    names = ("f1r", "f1i", "twr", "twi")
    shapes = {"x": (n1, n2), "f1r": (n1, n1), "f1i": (n1, n1), "twr": (n1, n2), "twi": (n1, n2)}
    _check("stage_a_manual", x.device, {"x": x, **{k: tables[k] for k in names}}, shapes)
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    err = _build.library().gft_stage_a_manual(
        _ptr(x), *(_ptr(tables[k]) for k in names), _ptr(yr), _ptr(yi), n1, n2, _stream(x.device)
    )
    _build.check(err, "stage_a_manual")
    count.launches += 1
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


def swizzled_image(parts: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's shared-memory image of the stacked parts (P, M, n1):
    (ceil(M / 64), P, ceil(n1 / 64), 64, 64), per 64 rows g, part p and
    64-deep chunk c the rows r as ``wgmma``'s K-major 128-byte swizzle lays
    them out: the 16-byte word j (depths 8 j .. 8 j + 7) of row r stored at
    word j ^ (r % 8), rows past M and depths past n1 zero.  A block's parts
    of one row group are then one run of bytes, copied as it is."""
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


#: Dynamic shared memory the bf16 kernel may opt into on an H100: a
#: block's 232,448 bytes less its static 8-byte F barrier.
SMEM_MAX = 232_448 - 8
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
    if variant == "f32_highest":
        _check("stage_a_dot", x.device, {"f_t": tables["f_t"]}, {"f_t": (n1, 2 * n1)})
        err = lib.gft_stage_a_dot_f32(_ptr(x), _ptr(tables["f_t"]), _ptr(yr), _ptr(yi), b, n1, n2, stream)
    else:
        img = (2 * n1 // 64, 3, -(-n1 // 64), 64, 64)
        _check("stage_a_dot", x.device, {"f_img": tables["f_img"]}, {"f_img": img}, dtype=torch.bfloat16)
        parts = 3 if variant == "bf16_x6" else 1
        err = lib.gft_stage_a_dot_bf16(_ptr(x), _ptr(tables["f_img"]), _ptr(yr), _ptr(yi), b, n1, n2,
                                       parts, *geometry, stream)
    _build.check(err, f"stage_a_dot[{variant}]")
    COUNTS[f"stage_a_dot_{variant}"].launches += 1
    return yr, yi
