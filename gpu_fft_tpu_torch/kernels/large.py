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
"""

from __future__ import annotations

from ..config import FUSED_MAX
from ..plan import (
    get_fused_plan,
    get_stage_a_plan,
    get_whole_packed_plan,
    get_whole_plan,
    half_spectrum_applies,
    on_device,
    stage_a_ct_full_range,
    stage_a_real_rows,
    use_folded_layout,
    whole_kernel_applies,
    wide_split_applies,
)
from ..tuning import get_tuning
from .fused import stage_a, whole_transform, whole_transform_packed
from .fused_torch import fused_fft, fused_fft_folded, fused_fft_half, stage_b, stage_b_half

__all__ = ["transform_any"]


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
