"""Transform planning: factorization, dispatch predicates and cached tables.

A plan holds the f64-generated f32 DFT and twiddle tables for one
(n, direction[, scale]) and is cached as numpy arrays, exactly as in the JAX
package (``gpu_fft_tpu/plan.py``): the plan functions here produce bit-identical
arrays.  :func:`on_device` keeps a second cache of the same plan as torch
tensors per (plan, device), so a transform never uploads its tables twice.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .config import DIRECT_MAX, FUSED_MAX, MAX_N
from .kernels.tables import dft_matrix_ext, twiddle_table
from .tuning import get_tuning

__all__ = [
    "FusedPlan",
    "balanced_split",
    "clear_device_cache",
    "from_jax_plan",
    "get_fused_plan",
    "get_irfft_direct_k128_plan",
    "get_irfft_direct_plan",
    "get_irfft_plan",
    "get_stage_a_plan",
    "get_stage_b_irfft_plan",
    "get_whole_packed_plan",
    "get_whole_plan",
    "on_device",
]


# ── Dispatch predicates (shared by kernels/large.py:transform_any) ───────────


def wide_split_applies(b: int, n: int) -> bool:
    """Wide batches use the full-lane n2 = 128 split."""
    t = get_tuning()
    return b >= t.wide_batch_min and t.wide_n_min <= n <= t.wide_n_max


def use_folded_layout(b: int, n: int) -> bool:
    """Digit reversal folded into the final contraction's output order,
    except at single/double-signal big n."""
    t = get_tuning()
    return n <= t.folded_n_max or b >= t.folded_batch_min


def half_spectrum_applies(n: int) -> bool:
    """Real input computes only the k1 <= n1/2 spectrum half and mirrors the
    rest (Hermitian symmetry, either sign)."""
    return n >= get_tuning().half_spectrum_min


def irfft_half_applies(n: int) -> bool:
    """Real-output inverses fold the conjugate half of the input spectrum
    before the matmuls: the k1 > n1/2 grid columns are conjugate
    k2-reversals of the kept ones, so out = Re(sum over k1 <= n1/2)."""
    return n >= get_tuning().irfft_half_min


def irfft_half_staged_applies(n: int) -> bool:
    """Staged real-output inverses run stage A on the first column tiles
    only (the rest are conjugate mirrors) and fold stage B per row."""
    return n >= get_tuning().irfft_half_staged_min


def whole_kernel_applies(b: int, n: int) -> bool:
    """Whether a (b, n) fused-size transform runs as ONE whole-transform
    kernel launch (kernels/fused.py:whole_transform[_packed])."""
    t = get_tuning()
    return (
        t.whole_n_min <= n <= t.whole_n_max
        and b <= t.whole_batch_max
        and n % 128 == 0
        and n >= 1024
    )


def fused_split(n: int, b: int) -> tuple[int, int]:
    """The (n1, n2) factorization a (b, n) fused transform will use."""
    if wide_split_applies(b, n):
        return max(2, n // 128), min(128, n // 2)
    return balanced_split(n)


def balanced_split(n: int) -> tuple[int, int]:
    """Split power-of-two n into (n1, n2), n1 <= n2, n1 * n2 = n."""
    if n & (n - 1):
        raise ValueError(f"balanced_split requires a power of two, got {n}")
    m = n.bit_length() - 1
    n1 = 1 << (m // 2)
    return n1, n // n1


# ── Fused plans (n <= FUSED_MAX) ─────────────────────────────────────────────


@dataclass(frozen=True)
class FusedPlan:
    """Tables for one fused transform of length ``n``.

    ``kind`` is ``direct`` (X = x @ F_n, n <= DIRECT_MAX) or ``fourstep``
    (n = n1 * n2, two contractions around a pointwise twiddle).  ``sign`` is
    -1 forward, +1 inverse (unnormalized unless a scale was folded in).
    """

    n: int
    sign: int
    kind: str
    n1: int
    n2: int
    tables: dict[str, Any] = field(compare=False, hash=False)


@functools.lru_cache(maxsize=None)
def get_fused_plan(n: int, sign: int, wide: bool = False, scale: float | None = None) -> FusedPlan:
    """``wide=True`` selects the n2 = 128 split; ``scale`` folds into the
    LAST contraction's table (exact for the power-of-two scales used)."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"fused plans require power-of-two n >= 2, got {n}")
    if n > FUSED_MAX:
        raise ValueError(f"n={n} exceeds FUSED_MAX={FUSED_MAX}; use the large-N path")
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")

    k = np.float32(1.0) if scale is None else np.float32(scale)

    if n <= DIRECT_MAX:
        fr, fi, fs, fd = dft_matrix_ext(n, sign)
        tables = {"fr": fr * k, "fi": fi * k, "fs": fs * k, "fd": fd * k}
        return FusedPlan(n=n, sign=sign, kind="direct", n1=n, n2=1, tables=tables)

    if wide and n >= 256:
        n1, n2 = max(2, n // 128), min(128, n // 2)
    else:
        n1, n2 = balanced_split(n)
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    f2r, f2i, f2s, f2d = dft_matrix_ext(n2, sign)
    # Twiddle oriented (n2, n1): applied to the intermediate indexed [c, k1].
    twr, twi = twiddle_table(n2, n1, n, sign)
    tables = {
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "f2r": f2r * k, "f2i": f2i * k, "f2s": f2s * k, "f2d": f2d * k,
        "twr": twr, "twi": twi,
    }
    return FusedPlan(n=n, sign=sign, kind="fourstep", n1=n1, n2=n2, tables=tables)


# ── Real-output inverse plans (Hermitian fold) ───────────────────────────────


@functools.lru_cache(maxsize=None)
def get_irfft_plan(n: int, scale: float | None = None, split: tuple[int, int] | None = None) -> dict:
    """Tables for the real-output Hermitian-fold inverse at fused sizes
    (``kernels/fused_torch.py:fused_irfft``), all sign +1:

    * ``g2*``: the (n2, n2) DFT contracting k2 -> m2 (Karatsuba keys too);
    * ``twr/twi``: (h1, n2) twiddle w_n^(k1 m2), h1 = n1/2 + 1;
    * ``w1r/w1i``: (n1/2, n1) last stage w_n1^(m1 k1) with the fold weights
      c_0 = 1, c_k1 = 2 and ``scale`` folded in;
    * ``alt``: (n1,) scale * (-1)^m1, the Nyquist column's real factor.

    ``split`` overrides the balanced (n1, n2); n1 is the FOLD digit (the
    minor digit of the flat index).  The staged stage-B fold passes
    (128, n2/128) (:func:`get_stage_b_irfft_plan`).
    """
    if n & (n - 1) or n < 16:
        raise ValueError(f"irfft plans require power-of-two n >= 16, got {n}")
    if n > FUSED_MAX:
        raise ValueError(f"n={n} exceeds FUSED_MAX={FUSED_MAX}")
    if split is None:
        n1, n2 = balanced_split(n)
    else:
        n1, n2 = split
        if n1 * n2 != n or n1 < 4 or n1 & (n1 - 1) or n2 & (n2 - 1):
            raise ValueError(f"bad irfft split {split} for n={n}")
    h1 = n1 // 2 + 1
    k = 1.0 if scale is None else float(scale)
    g2r, g2i, g2s, g2d = dft_matrix_ext(n2, +1)
    twr, twi = twiddle_table(h1, n2, n, +1)
    half = n1 // 2
    red = np.mod(np.outer(np.arange(half, dtype=np.int64), np.arange(n1, dtype=np.int64)), n1)
    ang = (2.0 * np.pi / n1) * red.astype(np.float64)
    c = np.full((half, 1), 2.0 * k)
    c[0] = k
    w1r = (np.cos(ang) * c).astype(np.float32)
    w1i = (np.sin(ang) * c).astype(np.float32)
    alt = (k * (-1.0) ** np.arange(n1, dtype=np.float64)).astype(np.float32)
    return {
        "n1": n1, "n2": n2, "h1": h1,
        "g2r": g2r, "g2i": g2i, "g2s": g2s, "g2d": g2d,
        "twr": twr, "twi": twi, "w1r": w1r, "w1i": w1i, "alt": alt,
    }


@functools.lru_cache(maxsize=None)
def get_irfft_direct_plan(n: int, scale: float | None = None) -> dict:
    """Tables for the direct real-output inverse from the one-sided
    h = n/2 + 1 bins (n <= DIRECT_MAX): x = xr @ cr + xi @ ci with
    cr[k, m] = s c_k cos(2 pi k m / n), ci[k, m] = -s c_k sin(2 pi k m / n),
    c_0 = c_{n/2} = 1, else 2.  The k = 0 and n/2 sin rows are exactly zero
    (angles reduced mod n in int64), so DC/Nyquist imaginary parts are
    ignored with no masking pass."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"direct irfft plans require power-of-two n >= 2, got {n}")
    if n > DIRECT_MAX:
        raise ValueError(f"n={n} exceeds DIRECT_MAX={DIRECT_MAX}; use the fold path")
    h = n // 2 + 1
    s = 1.0 if scale is None else float(scale)
    red = np.mod(np.outer(np.arange(h, dtype=np.int64), np.arange(n, dtype=np.int64)), n)
    ang = (2.0 * np.pi / n) * red.astype(np.float64)
    c = np.full((h, 1), 2.0 * s)
    c[0] = s
    c[-1] = s
    cr = (np.cos(ang) * c).astype(np.float32)
    ci = (-np.sin(ang) * c).astype(np.float32)
    return {"n": n, "h": h, "cr": cr, "ci": ci}


@functools.lru_cache(maxsize=None)
def get_irfft_direct_k128_plan(n: int, scale: float | None = None) -> dict:
    """:func:`get_irfft_direct_plan` split into the first h - 1 = n/2 rows
    (``cr``, ``ci``) and the Nyquist row ``alt`` = s (-1)^m, added as a
    broadcast: x = xr[:, :-1] @ cr + xi[:, :-1] @ ci + xr[:, -1:] * alt."""
    base = get_irfft_direct_plan(n, scale)
    h = base["h"]
    return {
        "n": n,
        "h": h,
        "cr": np.ascontiguousarray(base["cr"][: h - 1]),
        "ci": np.ascontiguousarray(base["ci"][: h - 1]),
        "alt": np.ascontiguousarray(base["cr"][h - 1 : h]),
    }


# ── Whole-transform plans (kernels K1 and K2) ────────────────────────────────


@functools.lru_cache(maxsize=None)
def get_whole_plan(n: int, sign: int, scale: float | None = None) -> dict:
    """Tables for the whole-transform kernel: x viewed (n1, 128) = [a, c];
    ``f1*`` (n1, n1); ``twr/twi`` (n1, 128) = [k1, c]; ``f2*`` (128, 128)
    with ``scale`` folded in.  Output Y[j, k1] flattens to natural order
    (k = k1 + n1*j)."""
    if n % 128 or n < 1024:
        raise ValueError(f"whole-kernel plans need n = 128*k >= 1024, got {n}")
    if n > FUSED_MAX:
        raise ValueError(f"n={n} exceeds FUSED_MAX={FUSED_MAX}")
    n2 = 128
    n1 = n // n2
    k = np.float32(1.0) if scale is None else np.float32(scale)
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    f2r, f2i, f2s, f2d = dft_matrix_ext(n2, sign)
    twr, twi = twiddle_table(n1, n2, n, sign)
    return {
        "n1": n1, "n2": n2,
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "f2r": f2r * k, "f2i": f2i * k, "f2s": f2s * k, "f2d": f2d * k,
        "twr": twr, "twi": twi,
    }


@functools.lru_cache(maxsize=None)
def get_whole_packed_plan(n: int, sign: int, scale: float | None = None) -> dict:
    """Every whole-transform table in ONE (4*n1 + 256, 128) f32 buffer:

    * rows [0, 2n1): ``[F1r; F1i]``, columns [0, n1) live;
    * rows [2n1, 4n1): ``[TWr; TWi]``;
    * rows [4n1, 4n1 + 256): ``[F2r; F2i]`` with ``scale`` folded in.

    The F1 stack must fit the 128 columns, so n1 <= 128 (n <= 16384).  The
    JAX plan checks only n <= FUSED_MAX and fails with a broadcast error
    above 16384; this one rejects those sizes by name.
    """
    if n % 128 or n < 1024:
        raise ValueError(f"whole-kernel plans need n = 128*k >= 1024, got {n}")
    if n > 128 * 128:
        raise ValueError(
            f"packed whole-kernel plans need n1 = n/128 <= 128 (n <= 16384) so that "
            f"[F1r; F1i] fits the buffer's 128 columns, got n={n} (n1={n // 128})"
        )
    n2 = 128
    n1 = n // n2
    k = np.float32(1.0) if scale is None else np.float32(scale)
    f1r, f1i, _, _ = dft_matrix_ext(n1, sign)
    f2r, f2i, _, _ = dft_matrix_ext(n2, sign)
    twr, twi = twiddle_table(n1, n2, n, sign)
    f1_stack = np.zeros((2 * n1, 128), np.float32)
    f1_stack[:n1, :n1] = f1r
    f1_stack[n1:, :n1] = f1i
    packed = np.concatenate([f1_stack, twr, twi, f2r * k, f2i * k], axis=0).astype(np.float32)
    return {"n1": n1, "n2": n2, "packed": packed}


# ── Staged plans (n > FUSED_MAX; kernel K3 carries stage A) ──────────────────


def stage_b_plannable(n2: int) -> bool:
    """True when stage B runs as the four-step with the digit reversal folded
    into the final contraction (m2 = 128 row split); forced-small configs fall
    back to the recursive stage B."""
    return n2 % 128 == 0 and n2 >= 256


def stage_a_col_tile(n1: int, n2: int) -> int:
    """Default stage-A column tile, clamped to n2."""
    return min(256 if n1 >= 512 else 512, n2)


def stage_a_ct_full_range(n: int) -> int:
    """Column tile for full-range stage A (forward and complex inverse):
    wider once n2 is large."""
    n1 = _stage_a_n1(n)
    n2 = n // n1
    t = get_tuning()
    if n1 < 512 and n2 >= t.stage_a_wide_ct_n2_min:
        return min(t.stage_a_wide_ct, n2)
    return stage_a_col_tile(n1, n2)


def stage_a_real_rows(n1: int) -> int:
    """Stage-A rows a real input needs: its output is conjugate-symmetric over
    k1 and the half-spectrum stage B reads only k1 <= n1/2, so the first
    ceil-to-8(n1/2 + 1) rows (72 of 128, 136 of 256)."""
    return -(-(n1 // 2 + 1) // 8) * 8


def _stage_a_n1(n: int) -> int:
    n1 = min(get_tuning().stage_a_n1, n // 2)
    # Keep n2 a fused size (n1 grows past 128 only above n = 2^23).
    while n // n1 > FUSED_MAX:
        n1 *= 2
    return n1


@functools.lru_cache(maxsize=None)
def get_stage_a_plan(n: int, sign: int, ct: int | None = None) -> dict[str, Any]:
    """Tables for the staged path: the (n1, n1) column DFT ``f1*``, the
    stage-A twiddle W_n^(k1*c) FACTORED over the column tile ct as
    ``two`` (n1, n2/ct) = W_n^(k1*j*ct) times ``twi`` (n1, ct) = W_n^(k1*cc),
    and ``stage_b`` — the row four-step's tables (m2 = 128) or None."""
    if n <= FUSED_MAX:
        raise ValueError(f"n={n} fits a fused plan; the staged path is not needed")
    if n > MAX_N:
        raise ValueError(f"n={n} exceeds MAX_N={MAX_N}")
    n1 = _stage_a_n1(n)
    n2 = n // n1
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    if ct is None:
        ct = stage_a_col_tile(n1, n2)
    elif not 1 <= ct <= n2 or n2 % ct:
        raise ValueError(f"ct={ct} must divide n2={n2}")
    two_r, two_i = twiddle_table(n1, n2 // ct, n // ct, sign)
    twi_r, twi_i = twiddle_table(n1, ct, n, sign)
    plan: dict[str, Any] = {
        "n1": n1,
        "n2": n2,
        "ct": ct,
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "two_r": two_r, "two_i": two_i,
        "twi_r": twi_r, "twi_i": twi_i,
        "stage_b": None,
    }
    if stage_b_plannable(n2):
        m1, m2 = n2 // 128, 128
        g1r, g1i, g1s, g1d = dft_matrix_ext(m1, sign)
        g2r, g2i, g2s, g2d = dft_matrix_ext(m2, sign)
        btwr, btwi = twiddle_table(m2, m1, n2, sign)
        plan["stage_b"] = {
            "m1": m1, "m2": m2,
            "f1r": g1r, "f1i": g1i, "f1s": g1s, "f1d": g1d,
            "f2r": g2r, "f2i": g2i, "f2s": g2s, "f2d": g2d,
            "twr": btwr, "twi": btwi,
        }
    return plan


def get_stage_b_irfft_plan(n: int, scale: float | None = None) -> dict | None:
    """Per-row Hermitian-fold tables for the staged real-output inverse.

    After stage A + twiddle of a Hermitian spectrum's inverse, each k1 row
    of the (B, n1, n2) intermediate is itself Hermitian over n2
    (Z[k1, n2 - c] = conj(Z[k1, c])): the stage-A twiddle
    w_n^(k1 (n2 - c)) = w_n1^k1 conj(w_n^(k1 c)) cancels the phase that
    S[k1, n2 - c] = conj(w_n1^k1 S[k1, c]) carries.  So stage B is the fused
    fold per row, :func:`get_irfft_plan` at n2 with split (128, n2/128), the
    fold digit on the row's minor digit.  None where stage B is not
    plannable (forced-small configurations).
    """
    n1 = _stage_a_n1(n)
    n2 = n // n1
    if not stage_b_plannable(n2) or n2 < 16:
        return None
    return get_irfft_plan(n2, scale=scale, split=(128, n2 // 128))


# ── Plans across packages and devices ────────────────────────────────────────


def _map_arrays(obj, fn):
    """Apply ``fn`` to every array in a plan dict (recursing into ``stage_b``)."""
    if isinstance(obj, dict):
        return {k: _map_arrays(v, fn) for k, v in obj.items()}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return fn(obj)
    return obj


def from_jax_plan(p):
    """The port's plan from a JAX-package plan: a ``gpu_fft_tpu.plan.FusedPlan``
    or a plan dict.  Arrays come across as numpy copies, scalars unchanged."""
    if hasattr(p, "tables") and hasattr(p, "kind"):
        return FusedPlan(
            n=p.n, sign=p.sign, kind=p.kind, n1=p.n1, n2=p.n2,
            tables=_map_arrays(dict(p.tables), np.array),
        )
    return _map_arrays(dict(p), np.array)


def on_device(make_plan, *args, device) -> Any:
    """``make_plan(*args)`` (a cached plan function above) with every table as a
    torch tensor on ``device``; cached per (make_plan, args, device)."""
    return _on_device(make_plan, args, torch.device(device))


def clear_device_cache() -> None:
    """Drop every plan :func:`on_device` holds.  A caller that patches a plan
    builder (the ablation harnesses) clears the builder's own cache and this
    one, so no transform keeps computing from the old tables."""
    _on_device.cache_clear()


@functools.lru_cache(maxsize=None)
def _on_device(make_plan, args: tuple, device: torch.device):
    plan = make_plan(*args)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if isinstance(plan, FusedPlan):
        return dataclasses.replace(plan, tables=_map_arrays(plan.tables, upload))
    return _map_arrays(plan, upload)
