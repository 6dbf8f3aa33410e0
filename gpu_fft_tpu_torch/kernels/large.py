"""The transform dispatch: any power-of-two n from 2 to MAX_N, batched rows.

Port of ``gpu_fft_tpu/kernels/large.py:transform_any`` and ``_staged``.  The
engine is picked by (B, n) with the same predicates as the JAX package
(plan.py, tuning.py):

* B = 1, 1024 <= n <= 16384: the whole transform in ONE kernel launch —
  the packed-table variant (K2) up to ``whole_packed_n_max``, else K1;
* other n <= FUSED_MAX: the direct DFT or the four-step, as torch
  contractions (kernels/fused_torch.py);
* n > FUSED_MAX: staged — the stage-A kernel (K3) over the (n1, n2) view,
  then the row four-step with the digit reversal folded into its output
  order (or, for forced-small plans, a recursive row transform).

:func:`inverse_real` and :func:`inverse_real_half` (``gpu_fft_tpu/kernels/
large.py``) are the real-output inverses: the Hermitian fold at
n >= ``irfft_half_min`` (fused) and n >= ``irfft_half_staged_min`` (K3 on
half the column tiles, then the per-row fold), else ``transform_any`` with
the imaginary part dropped (K1/K2 in their band); the direct folded tables
at n <= DIRECT_MAX.
"""

from __future__ import annotations

import torch

from ..config import DIRECT_MAX, FUSED_MAX
from ..plan import (
    get_fused_plan,
    get_irfft_direct_k128_plan,
    get_irfft_direct_plan,
    get_irfft_plan,
    get_stage_a_plan,
    get_stage_b_irfft_plan,
    get_whole_packed_plan,
    get_whole_plan,
    half_spectrum_applies,
    irfft_half_applies,
    irfft_half_staged_applies,
    on_device,
    stage_a_ct_full_range,
    stage_a_real_rows,
    use_folded_layout,
    whole_kernel_applies,
    wide_split_applies,
)
from ..tuning import get_tuning
from .fused import stage_a, whole_transform, whole_transform_packed
from .fused_torch import (
    fused_fft,
    fused_fft_folded,
    fused_fft_half,
    fused_irfft,
    irfft_direct_half,
    irfft_direct_half_k128,
    irfft_fold_columns,
    stage_b,
    stage_b_half,
    stage_b_irfft_from_half,
)

__all__ = ["inverse_real", "inverse_real_half", "transform_any"]


def transform_any(xr, xi, n: int, sign: int, scale: float | None = None):
    """Split-complex transform of each row of a (B, n) fp32 batch.

    ``xi`` may be None (real input).  Unnormalized unless ``scale`` is given
    (1/n for a normalized inverse): at fused sizes it is folded into the last
    table, at staged sizes applied after.  Natural output order, on the
    input's device.
    """
    dev = xr.device
    if n <= FUSED_MAX:
        b = xr.shape[0]
        if whole_kernel_applies(b, n):
            if n <= get_tuning().whole_packed_n_max:
                plan = on_device(get_whole_packed_plan, n, sign, scale, device=dev)
                return whole_transform_packed(xr, xi, plan)
            return whole_transform(xr, xi, on_device(get_whole_plan, n, sign, scale, device=dev))
        if xi is None and half_spectrum_applies(n):
            plan = on_device(get_fused_plan, n, sign, False, scale, device=dev)
            if plan.kind == "fourstep":
                return fused_fft_half(xr, plan)
        plan = on_device(get_fused_plan, n, sign, wide_split_applies(b, n), scale, device=dev)
        if plan.kind == "fourstep" and use_folded_layout(b, n):
            return fused_fft_folded(xr, xi, plan)
        return fused_fft(xr, xi, plan)

    if scale is not None:
        yr, yi = transform_any(xr, xi, n, sign)
        return yr * scale, yi * scale
    return _staged(xr, xi, n, sign)


def _staged(xr, xi, n: int, sign: int):
    """The staged (n > FUSED_MAX) body of :func:`transform_any`."""
    b = xr.shape[0]
    plan = on_device(get_stage_a_plan, n, sign, stage_a_ct_full_range(n), device=xr.device)
    n1, n2 = plan["n1"], plan["n2"]
    half = xi is None and half_spectrum_applies(n) and plan["stage_b"] is not None
    half_rows = stage_a_real_rows(n1) if half else None
    x3r = xr.reshape(b, n1, n2)
    x3i = None if xi is None else xi.reshape(b, n1, n2)
    yr, yi = stage_a(x3r, x3i, n1, n2, plan, plan["ct"], rows=half_rows)

    if plan["stage_b"] is not None:
        if half:
            return stage_b_half(yr, yi, n1, n2, plan["stage_b"])
        return stage_b(yr, yi, n1, n2, plan["stage_b"])

    # Forced-small plans: row transforms of length n2, then the digit reversal
    # (flat k = k1 + n1 * k2).
    rr, ri = transform_any(yr.reshape(b * n1, n2), yi.reshape(b * n1, n2), n2, sign)
    out_r = rr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    out_i = ri.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    return out_r, out_i


def inverse_real(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse of a HERMITIAN (B, n) spectrum.

    From ``irfft_half_min`` to FUSED_MAX the conjugate half of the input is
    folded before the contractions (:func:`fused_irfft`).  From
    ``irfft_half_staged_min`` the staged inverse runs K3 on only the first
    ceil((n2/2 + 1) / ct) column tiles of the (n1, n2) view, at the plan's
    default tile (the post-twiddle output is conjugate-symmetric over
    columns), rebuilds the rest by flips (:func:`irfft_fold_columns`) and
    folds stage B per row.  Elsewhere :func:`transform_any` with the
    imaginary part dropped.  Unnormalized unless ``scale`` is given; at the
    fold sizes it lives in the tables.  Correct only for Hermitian input.
    """
    dev = xr.device
    if 16 <= n <= FUSED_MAX and irfft_half_applies(n):
        return fused_irfft(xr, xi, on_device(get_irfft_plan, n, scale, None, device=dev))
    if n > FUSED_MAX and irfft_half_staged_applies(n):
        bt = on_device(get_stage_b_irfft_plan, n, scale, device=dev)
        if bt is not None:
            b = xr.shape[0]
            plan = on_device(get_stage_a_plan, n, +1, None, device=dev)
            n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
            tiles = -(-(n2 // 2 + 1) // ct)
            yr, yi = stage_a(
                xr.reshape(b, n1, n2), xi.reshape(b, n1, n2), n1, n2, plan, ct, col_tiles=tiles
            )
            return stage_b_irfft_from_half(*irfft_fold_columns(yr, yi, bt), bt)
    yr, _ = transform_any(xr, xi, n, +1, scale=scale)
    return yr


def inverse_real_half(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse from the ONE-SIDED (B, h = n/2 + 1) spectrum.

    At n <= DIRECT_MAX two real products against the folded tables
    (:func:`irfft_direct_half`, or the K = n/2 form at n >= 256 where
    ``irfft_direct_k128``).  Above, the Hermitian mirror
    X[n - k] = conj(X[k]) is rebuilt (two flips and two concatenations) and
    :func:`inverse_real` runs.  DC/Nyquist imaginary parts are ignored on
    every path (numpy ``irfft`` semantics).
    """
    h = n // 2 + 1
    if xr.shape[-1] != h:
        raise ValueError(f"inverse_real_half expects {h} bins for n={n}, got {xr.shape[-1]}")
    dev = xr.device
    if n <= DIRECT_MAX:
        if n >= 256 and get_tuning().irfft_direct_k128:
            return irfft_direct_half_k128(xr, xi, on_device(get_irfft_direct_k128_plan, n, scale, device=dev))
        return irfft_direct_half(xr, xi, on_device(get_irfft_direct_plan, n, scale, device=dev))
    mid_i = xi[:, 1 : h - 1]
    zero = xi.new_zeros(xi.shape[0], 1)
    full_r = torch.cat([xr, torch.flip(xr[:, 1 : h - 1], (1,))], dim=1)
    full_i = torch.cat([zero, mid_i, zero, -torch.flip(mid_i, (1,))], dim=1)
    return inverse_real(full_r, full_i, n, scale=scale)
