"""Wrappers of the stage-A ablation kernels, each beside its plain version.

Two Pallas kernels of the JAX package's ablation harnesses are CUDA kernels
here:

* ``stage_a_manual`` (S2, ``scripts/ablate_2e20_levers.py:stage_a_manual``):
  stage A at B = 1 on real input with a materialized twiddle, F1 resident and
  the column tiles pipelined by hand (``csrc/stage_a_manual.cu``);
* ``stage_a_dot`` (S3, ``scripts/ablate_mosaic_x6.py:build``): the two
  stage-A dots Yr = Fr x, Yi = Fi x in three precisions, ``f32_highest``
  (CUDA cores), ``bf16_x6`` (the 6-term bf16 ladder on the tensor cores) and
  ``bf16_x1`` (one bf16 product) (``csrc/stage_a_dot.cu``).

As in :mod:`.fused`, a wrapper runs its plain torch version for a tensor on
the CPU and launches its kernel or raises for a CUDA tensor; ``COUNTS[name]``
counts both.  Under CUDA-graph capture a wrapper counts a launch when it is
captured, not when the graph is replayed.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import LaunchCount, _check, _on_cpu, _ptr, _stream, stage_a_plain

__all__ = [
    "COUNTS",
    "VARIANTS",
    "dot_tables",
    "reset_counts",
    "split3_bf16",
    "stage_a_dot",
    "stage_a_dot_plain",
    "stage_a_manual",
    "stage_a_manual_plain",
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
    """The constant (n1, n1) LHS pair in both forms the variants read: f32
    ``fr``/``fi`` and their bf16 splits ``fr_bf16``/``fi_bf16`` (3, n1, n1),
    split once on the host side of the kernel as the JAX harness does."""
    return {
        "fr": fr.contiguous(), "fi": fi.contiguous(),
        "fr_bf16": torch.stack(split3_bf16(fr)).contiguous(),
        "fi_bf16": torch.stack(split3_bf16(fi)).contiguous(),
    }


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
    count = COUNTS[f"stage_a_dot_{variant}"]
    if _on_cpu(x, "stage_a_dot"):
        count.plain_calls += 1
        return stage_a_dot_plain(x, tables, variant)
    b, n1, n2 = x.shape
    lib = _build.library()
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    stream = _stream(x.device)
    if variant == "f32_highest":
        if n2 % 4:
            raise ValueError(f"stage_a_dot f32 kernel needs n2 % 4 == 0 (n2={n2})")
        shapes = {"x": (b, n1, n2), "fr": (n1, n1), "fi": (n1, n1)}
        _check("stage_a_dot", x.device, {"x": x, "fr": tables["fr"], "fi": tables["fi"]}, shapes)
        err = lib.gft_stage_a_dot_f32(
            _ptr(x), _ptr(tables["fr"]), _ptr(tables["fi"]), _ptr(yr), _ptr(yi), b, n1, n2, stream
        )
    else:
        if n1 % 32 or n2 % 64 or b > 65535:
            raise ValueError(
                f"stage_a_dot bf16 kernel needs n1 % 32 == 0, n2 % 64 == 0 and B <= 65535 "
                f"(B={b}, n1={n1}, n2={n2})"
            )
        _check("stage_a_dot", x.device, {"x": x}, {"x": (b, n1, n2)})
        split = {"fr_bf16": tables["fr_bf16"], "fi_bf16": tables["fi_bf16"]}
        shapes = {"fr_bf16": (3, n1, n1), "fi_bf16": (3, n1, n1)}
        _check("stage_a_dot", x.device, split, shapes, dtype=torch.bfloat16)
        parts = 3 if variant == "bf16_x6" else 1
        err = lib.gft_stage_a_dot_bf16(
            _ptr(x), _ptr(split["fr_bf16"]), _ptr(split["fi_bf16"]), _ptr(yr), _ptr(yi),
            b, n1, n2, parts, stream,
        )
    _build.check(err, f"stage_a_dot[{variant}]")
    count.launches += 1
    return yr, yi
