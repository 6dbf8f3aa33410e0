"""Wrappers of the hand-written Hopper kernels, each beside its plain version.

Three Pallas kernels of the JAX package sit on the transform path
(``gpu_fft_tpu/kernels/fused.py``); each is a CUDA kernel here (``csrc/``):

* ``whole_transform`` (K1) and ``whole_transform_packed`` (K2): the whole
  four-step of a B = 1 transform with 1024 <= n <= 16384 in one launch
  (``csrc/whole_transform.cu``);
* ``stage_a`` (K3): column DFT + twiddle, the first half of every staged
  transform (``csrc/stage_a.cu``).

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
    "reset_counts",
    "stage_a",
    "stage_a_plain",
    "whole_transform",
    "whole_transform_packed",
    "whole_transform_packed_plain",
    "whole_transform_plain",
]

_N2 = 128  # row length of the whole-transform (n1, 128) view


@dataclass
class LaunchCount:
    launches: int = 0
    plain_calls: int = 0


COUNTS = {
    "whole_transform": LaunchCount(),
    "whole_transform_packed": LaunchCount(),
    "stage_a": LaunchCount(),
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


def _check(kernel: str, device: torch.device, tensors: dict, shapes: dict) -> None:
    """Every tensor: fp32, contiguous, 16-byte aligned, on ``device``, and of
    the shape in ``shapes`` (a None tensor is skipped)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be float32, got {t.dtype}")
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


def _whole_args(kernel: str, xr, xi, plan: dict):
    b, n = xr.shape
    n1, n2 = plan["n1"], plan["n2"]
    if n2 != _N2 or n != n1 * n2:
        raise ValueError(f"{kernel}: x is (B, {n}), plan is n1={n1} x n2={n2}")
    if n1 < 8 or n1 & (n1 - 1):
        raise ValueError(f"{kernel}: n1 = n/128 must be a power of two >= 8, got n1={n1}")
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
        _ptr(yr), _ptr(yi), b, n1, _stream(xr.device),
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
        _ptr(xr), _ptr(xi), _ptr(plan["packed"]), _ptr(yr), _ptr(yi), b, n1, _stream(xr.device)
    )
    _build.check(err, "whole_transform_packed")
    count.launches += 1
    return yr, yi


# ── K3: stage A ──────────────────────────────────────────────────────────────


def _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows):
    """(output rows, output columns) after the JAX wrapper's checks."""
    if "two_r" not in tables:
        raise NotImplementedError(
            "stage_a: only the factored-twiddle plan layout is ported; the legacy "
            "materialized (n1, n2) twiddle is not"
        )
    if col_tile != tables["ct"]:
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


def stage_a_plain(xr, xi, n1, n2, tables, col_tile, col_tiles=None, rows=None):
    """Plain torch version of :func:`stage_a`."""
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    t = {
        "f1r": tables["f1r"][:r], "f1i": tables["f1i"][:r],
        "two_r": tables["two_r"][:r, : ncols // col_tile],
        "two_i": tables["two_i"][:r, : ncols // col_tile],
        "twi_r": tables["twi_r"][:r], "twi_i": tables["twi_i"][:r],
    }
    return stage_a_torch(
        xr[:, :, :ncols], None if xi is None else xi[:, :, :ncols], t
    )


def stage_a(xr, xi, n1: int, n2: int, tables, col_tile: int, col_tiles=None, rows=None):
    """Column DFT + twiddle over a (B, n1, n2) view (JAX: ``stage_a``).

    ``tables``: :func:`plan.get_stage_a_plan` on ``xr``'s device.
    ``col_tiles`` keeps only the first column tiles and ``rows`` only the first
    k1 rows.  Returns split-complex (B, rows or n1, col_tiles * ct or n2).
    """
    count = COUNTS["stage_a"]
    if _on_cpu(xr, "stage_a"):
        count.plain_calls += 1
        return stage_a_plain(xr, xi, n1, n2, tables, col_tile, col_tiles, rows)
    r, ncols = _stage_a_extent(n1, n2, tables, col_tile, col_tiles, rows)
    if n1 % 32 or col_tile % 4:
        raise ValueError(
            f"stage_a kernel needs n1 % 32 == 0 and ct % 4 == 0 (n1={n1}, ct={col_tile})"
        )
    b = xr.shape[0]
    names = ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i")
    outer, inner = (n1, n2 // col_tile), (n1, col_tile)
    shapes = {"xr": (b, n1, n2), "xi": (b, n1, n2), "f1r": (n1, n1), "f1i": (n1, n1),
              "two_r": outer, "two_i": outer, "twi_r": inner, "twi_i": inner}
    _check("stage_a", xr.device, {"xr": xr, "xi": xi, **{k: tables[k] for k in names}}, shapes)
    yr = torch.empty((b, r, ncols), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    lib = _build.library()
    err = lib.gft_stage_a(
        _ptr(xr), _ptr(xi), *(_ptr(tables[k]) for k in names), _ptr(yr), _ptr(yi),
        b, n1, n2, col_tile, r, ncols, _stream(xr.device),
    )
    _build.check(err, "stage_a")
    count.launches += 1
    return yr, yi
