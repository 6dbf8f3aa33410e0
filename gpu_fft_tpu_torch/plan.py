"""Transform planning: factorization, the route and cached tables.

:func:`route` decides what a (B, n) transform runs; the dispatch
(``kernels/large.py``), :func:`describe_plan` and the cost model read it.

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
from typing import Any, NamedTuple

import numpy as np
import torch

from . import config
from .config import DIRECT_MAX, FUSED_MAX, MAX_N
from .kernels.tables import dft_matrix_ext, twiddle_table
from .tuning import get_tuning

__all__ = [
    "FusedPlan",
    "Route",
    "axis0_applies",
    "balanced_split",
    "clear_device_cache",
    "describe_plan",
    "from_jax_plan",
    "get_fused_plan",
    "get_irfft_direct_k128_plan",
    "get_irfft_direct_plan",
    "get_irfft_plan",
    "get_pack_tables",
    "get_rfft_direct_packed_plan",
    "get_stage_a_plan",
    "get_stage_b_irfft_plan",
    "get_stage_b_twiddle",
    "get_whole_packed_plan",
    "get_whole_plan",
    "on_device",
    "rfft_pack_applies",
    "route",
    "stage_b_kernel_applies",
]


# ── Dispatch predicates (read by route) ──────────────────────────────────────


def wide_split_applies(b: int, n: int) -> bool:
    """Wide batches use the full-lane n2 = 128 split."""
    t = get_tuning()
    return b >= t.wide_batch_min and t.wide_n_min <= n <= t.wide_n_max


def use_folded_layout(b: int, n: int) -> bool:
    """Digit reversal folded into the final contraction's output order,
    except at single/double-signal big n."""
    t = get_tuning()
    return n <= t.folded_n_max or b >= t.folded_batch_min


# The two gate-closed engines' thresholds: 1 << 62, closed, as on every
# JAX tuning row.  No tuning row opens them; a measurement or a test opens
# one by patching the constant for its length (``unittest.mock.patch.object``).
RFFT_PACK_MIN = 1 << 62
AXIS0_H_MIN = 1 << 62


def rfft_pack_applies(b: int, n: int) -> bool:
    """Real input runs as ONE n/2-point complex transform of
    z = x[0::2] + i x[1::2] and an O(n) recombination
    (``kernels/large.py:_real_packed_fft``): half the transform's work.
    From :data:`RFFT_PACK_MIN`, closed."""
    return n >= RFFT_PACK_MIN


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


def axis0_applies(h: int, w: int) -> bool:
    """Whether the column pass of an (h, w) 2-D transform runs in place over
    axis 0 (``kernels/fused_torch.py:transform_axis0``) instead of
    transpose, row transform, transpose back: a power-of-two H from
    :data:`AXIS0_H_MIN` (closed) up to the engine's FUSED_MAX, and
    H > W/2, the JAX predicate's shape rule."""
    return AXIS0_H_MIN <= h <= FUSED_MAX and h & (h - 1) == 0 and h > w // 2


#: The band under "fast": K1F / K2F (``csrc/whole_bf16.cuh``) serve
#: n1 = n/128 <= 128 and were swept at B = 1 only, so there the band stays
#: the v5e one, B = 1 and n <= 16,384.
WHOLE_FAST_N_MAX = 1 << 14
WHOLE_FAST_BATCH_MAX = 1


def whole_kernel_applies(b: int, n: int) -> bool:
    """Whether a (b, n) fused-size transform runs as ONE whole-transform
    kernel launch (kernels/fused.py:whole_transform[_packed]): the tuning
    row's band, under "fast" (read at call time) K1F / K2F's."""
    t = get_tuning()
    if n < max(t.whole_n_min, 1024) or n % 128:
        return False
    if config.PRECISION == "fast":
        return n <= WHOLE_FAST_N_MAX and b <= WHOLE_FAST_BATCH_MAX
    return n <= t.whole_n_max and b <= t.whole_batch_max and b * n <= t.whole_samples_max


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


@functools.lru_cache(maxsize=None)
def get_pack_tables(n: int) -> tuple:
    """``(wr, wi)``: W_n^k for k < n/2 (f64-generated f32), the packed real
    forward's recombination twiddle (``kernels/large.py:_real_packed_fft``)."""
    from .kernels.tables import unit_roots

    return unit_roots(n // 2, n, -1)


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
def get_rfft_direct_packed_plan(n: int, scale: float | None = None) -> dict:
    """One (n, n) table for the direct real forward,
    T = [C (n, h) | S[:, 1:h-1] (n, h - 2)], h = n/2 + 1, with
    C[m, k] = s cos(2 pi m k / n) and S[m, k] = -s sin(2 pi m k / n): x @ T
    holds Re X[0..h) in its first h columns and Im X[1..h-1) in the rest
    (the k = 0 and n/2 sin columns are zero).  ``kernels/fused_torch.py:
    rfft_direct_packed`` and ``rfft_packed_psd`` read it."""
    if n & (n - 1) or n < 8:
        raise ValueError(f"packed rfft plans require power-of-two n >= 8, got {n}")
    if n > DIRECT_MAX:
        raise ValueError(f"n={n} exceeds DIRECT_MAX={DIRECT_MAX}")
    h = n // 2 + 1
    s = 1.0 if scale is None else float(scale)
    red = np.mod(np.outer(np.arange(n, dtype=np.int64), np.arange(h, dtype=np.int64)), n)
    ang = (2.0 * np.pi / n) * red.astype(np.float64)
    c = (np.cos(ang) * s).astype(np.float32)
    sn = (-np.sin(ang) * s).astype(np.float32)
    return {"n": n, "h": h, "t": np.concatenate([c, sn[:, 1 : h - 1]], axis=1)}


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


def stage_b_kernel_applies(n2: int) -> bool:
    """Whether a complex stage B of rows n2 runs as ONE launch of K4
    (kernels/fused.py:stage_b_kernel) rather than the torch contractions:
    "full" precision (read at call time), the row four-step's m2 = 128 split,
    m1 = n2 / 128 a power of two in [8, 512] (n2 = 1,024 ... 65,536: every
    staged n from 2^17 to MAX_N with the default n1)."""
    return config.PRECISION == "full" and stage_b_plannable(n2) and 1024 <= n2 <= FUSED_MAX


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


# ── The route: what a transform runs ─────────────────────────────────────────

#: A route's kernels by ``kernels/fused.py:COUNTS`` name (F: the bf16 form).
KERNELS = {
    "K1": "whole_transform",
    "K2": "whole_transform_packed",
    "K1F": "whole_transform_bf16",
    "K2F": "whole_transform_packed_bf16",
    "K3": "stage_a",
    "K3F": "stage_a_bf16",
    "K4": "stage_b",
}


class Route(NamedTuple):
    """What one (B, n) transform runs (:func:`route`): its ``path``, the
    ``gft.engine.*`` ``spans`` it opens in order, the ``kernel`` of the
    whole transform or of stage A (None where torch runs), ``split``,
    ``layout`` and ``wide`` as :func:`describe_plan` names them, the staged
    path's ``stage_b`` (``K4``, ``torch``, ``half`` or ``recursive``) and
    the ``inner`` route of a nested transform (the packed n/2 one, the
    recursive rows)."""

    path: str
    spans: tuple
    kernel: str | None = None
    split: tuple | None = None
    layout: str | None = None
    wide: bool = False
    stage_b: str | None = None
    inner: Route | None = None

    @property
    def kernels(self) -> tuple:
        """The kernels one call launches, in order (:data:`KERNELS` keys)."""
        own = (self.kernel,) if self.kernel else ()
        own += ("K4",) if self.stage_b == "K4" else ()
        return own + (self.inner.kernels if self.inner else ())


_STAGED = ("gft.engine.stage_a", "gft.engine.stage_b")
_STAGE_A_KERNEL = {"full": "K3", "fast": "K3F"}  # none under "high"


def route(b: int, n: int, *, real_input: bool = False, sign: int = -1, real_output: bool = False,
          one_sided: bool = False) -> Route:
    """The route of ``kernels/large.py:transform_any`` on a (b, n) batch, or
    with ``real_output`` of ``inverse_real`` (``one_sided``:
    ``inverse_real_half``), from the predicates above (their one caller on
    the dispatch path), the tuning row and the precision mode, read at call
    time: under "high" no kernel runs (the JAX package's kernels have no
    bf16x3 form), under "fast" the kernels take their bf16 forms."""
    mode = config.PRECISION
    if real_output:
        if one_sided and n <= DIRECT_MAX:
            k128 = n >= 256 and get_tuning().irfft_direct_k128
            return Route("irfft_direct_k128" if k128 else "irfft_direct", ("gft.engine.irfft_direct",))
        if 16 <= n <= FUSED_MAX and irfft_half_applies(n):
            return Route("irfft_fold", ("gft.engine.irfft_fold",), split=balanced_split(n))
        if n > FUSED_MAX and irfft_half_staged_applies(n):
            n1 = _stage_a_n1(n)
            if stage_b_plannable(n // n1):  # the per-row fold's tables (get_stage_b_irfft_plan)
                return Route("irfft_fold_staged", _STAGED, _STAGE_A_KERNEL.get(mode), (n1, n // n1))
        return route(b, n, sign=+1)  # the complex inverse, its real part kept
    if real_input and sign == -1 and n >= 8 and rfft_pack_applies(b, n):
        inner = route(b, n // 2)
        return Route("packed_real", ("gft.engine.packed_real",) + inner.spans, split=inner.split, inner=inner)
    if n > FUSED_MAX:
        return staged_route(b, n, real_input=real_input)
    if whole_kernel_applies(b, n) and mode != "high":
        kernel = ("K2" if n <= get_tuning().whole_packed_n_max else "K1") + ("F" if mode == "fast" else "")
        return Route("whole", ("gft.engine.whole",), kernel, (n // 128, 128))
    if n <= DIRECT_MAX:
        return Route("direct", ("gft.engine.direct",), split=(n, 1), wide=wide_split_applies(b, n))
    if real_input and half_spectrum_applies(n):
        return Route("fourstep", ("gft.engine.fourstep_half",), split=balanced_split(n), layout="half-spectrum")
    if use_folded_layout(b, n):
        return Route("fourstep", ("gft.engine.fourstep_folded",), split=fused_split(n, b), layout="folded",
                     wide=wide_split_applies(b, n))
    return Route("fourstep", ("gft.engine.fourstep",), split=fused_split(n, b), layout="transpose",
                 wide=wide_split_applies(b, n))


def staged_route(b: int, n: int, *, real_input: bool) -> Route:
    """:func:`route` past FUSED_MAX, which the staged body takes for its own
    inputs (a backward's cotangent may be real where the input was not)."""
    n1 = _stage_a_n1(n)
    n2 = n // n1
    kernel = _STAGE_A_KERNEL.get(config.PRECISION)
    if not stage_b_plannable(n2):
        inner = route(b * n1, n2)
        return Route("staged", _STAGED + inner.spans, kernel, (n1, n2), "folded", stage_b="recursive", inner=inner)
    if real_input and half_spectrum_applies(n):
        return Route("staged", _STAGED, kernel, (n1, n2), "half-spectrum", stage_b="half")
    return Route("staged", _STAGED, kernel, (n1, n2), "folded", stage_b="K4" if stage_b_kernel_applies(n2) else "torch")


def describe_plan(n: int, batch: int = 1, real_input: bool = True) -> dict:
    """Explain how a (batch, n) transform will dispatch: a view of
    :func:`route` in the call's precision mode (JAX:
    ``gpu_fft_tpu.plan.describe_plan``, which says ``fourstep`` where the
    port names the whole-transform band's kernel).

    >>> describe_plan(256)["path"]
    'direct'
    >>> p = describe_plan(1024); (p["path"], p["kernel"])
    ('whole', 'whole_transform_packed')
    >>> describe_plan(4096)["kernel"], describe_plan(4096, batch=2)["path"]
    ('whole_transform', 'whole')
    >>> p = describe_plan(65536, batch=16); (p["path"], p["split"])
    ('whole', (512, 128))
    >>> p = describe_plan(65536, batch=2048); (p["layout"], p["split"])
    ('half-spectrum', (256, 256))
    >>> p = describe_plan(65536, batch=2048, real_input=False); p["layout"]
    'folded'
    >>> p = describe_plan(1 << 20); (p["path"], p["split"], p["stage_b_split"])
    ('staged', (128, 8192), (64, 128))
    >>> p["engine"], describe_plan(1 << 20, real_input=False)["engine"]
    ('K3 stage_a + torch stage B', 'K3 stage_a + K4 stage_b')
    """
    if n < 2 or n & (n - 1):
        raise ValueError(f"describe_plan requires power-of-two n >= 2, got {n}")
    if n > MAX_N:
        raise ValueError(f"n={n} exceeds MAX_N={MAX_N}")
    r = route(batch, n, real_input=real_input)
    out: dict = {"n": n, "batch": batch, "real_input": real_input, "precision": config.PRECISION, "path": r.path,
                 "split": r.split, "layout": r.layout}
    if r.path == "whole":
        out.update(engine=f"{r.kernel}, one launch", kernel=KERNELS[r.kernel])
    elif r.path == "direct":
        out["engine"] = "torch matmul"
    elif r.path == "fourstep":
        out.update(engine="torch four-step", wide=r.wide)
    elif r.path == "staged":
        stage_a = f"{r.kernel} {KERNELS[r.kernel]}" if r.kernel else "torch stage_a"
        out.update(engine=stage_a + (" + K4 stage_b" if r.stage_b == "K4" else " + torch stage B"),
                   stage_b_split=None if r.stage_b == "recursive" else (r.split[1] // 128, 128))
    else:  # packed_real
        out["engine"] = f"one {n // 2}-point complex transform"
    return out


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


@functools.lru_cache(maxsize=None)
def get_stage_b_twiddle(n2: int, sign: int) -> dict:
    """Stage B's row twiddle w_n2^(k c) laid out (m1, 128) = [k, c], as K4
    reads it, coalesced along c (:func:`get_stage_a_plan`'s ``stage_b``
    holds the same values (128, m1) for the torch contractions)."""
    twr, twi = twiddle_table(n2 // 128, 128, n2, sign)
    return {"twr": twr, "twi": twi}


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
    """Apply ``fn`` to every array in a plan dict (recursing into ``stage_b``)
    or tuple."""
    if isinstance(obj, dict):
        return {k: _map_arrays(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_map_arrays(v, fn) for v in obj)
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
