"""Fused-size transforms and stage B of the staged path, as plain torch ops.

The JAX package writes these engines as jnp einsums and leaves them to XLA
(``gpu_fft_tpu/kernels/fused_jnp.py``); no Pallas kernel stands behind them,
so here they are torch.matmul / torch.einsum contractions against the plan's
tables.  Every function takes split-complex fp32 tensors and returns the
spectrum in natural order, on the input's device.
"""

from __future__ import annotations

import torch

from ..config import KARATSUBA
from ..plan import FusedPlan

__all__ = [
    "fused_fft",
    "fused_fft_folded",
    "fused_fft_half",
    "stage_a_torch",
    "stage_b",
    "stage_b_half",
]


def _ceinsum(eq, ar, ai, t, prefix):
    """Split-complex einsum against the table group ``prefix`` (Karatsuba
    3-product form when KARATSUBA, else the 4-product form)."""
    if KARATSUBA:
        k1 = torch.einsum(eq, ar + ai, t[prefix + "r"])
        k2 = torch.einsum(eq, ar, t[prefix + "d"])
        k3 = torch.einsum(eq, ai, t[prefix + "s"])
        return k1 - k3, k1 + k2
    rr = torch.einsum(eq, ar, t[prefix + "r"])
    ii = torch.einsum(eq, ai, t[prefix + "i"])
    ri = torch.einsum(eq, ar, t[prefix + "i"])
    ir = torch.einsum(eq, ai, t[prefix + "r"])
    return rr - ii, ri + ir


def _cmatmul(ar, ai, t, prefix):
    """Split-complex (rows, k) @ (k, m) against the table group ``prefix``."""
    if KARATSUBA:
        k1 = (ar + ai) @ t[prefix + "r"]
        k2 = ar @ t[prefix + "d"]
        k3 = ai @ t[prefix + "s"]
        return k1 - k3, k1 + k2
    fr, fi = t[prefix + "r"], t[prefix + "i"]
    return ar @ fr - ai @ fi, ar @ fi + ai @ fr


def fused_fft(xr, xi, plan: FusedPlan):
    """Direct or transpose-form four-step transform of each (B, n) row;
    ``xi`` may be None (real input)."""
    b, n = xr.shape
    assert n == plan.n, (n, plan.n)
    t = plan.tables
    if plan.kind == "direct":
        if xi is None:
            return xr @ t["fr"], xr @ t["fi"]
        return _cmatmul(xr, xi, t, "f")

    n1, n2 = plan.n1, plan.n2
    xtr = xr.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    if xi is None:
        pr = xtr @ t["f1r"]
        pi = xtr @ t["f1i"]
    else:
        xti = xi.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
        pr, pi = _cmatmul(xtr, xti, t, "f1")
    p3r = pr.reshape(b, n2, n1)
    p3i = pi.reshape(b, n2, n1)
    zr = p3r * t["twr"] - p3i * t["twi"]
    zi = p3r * t["twi"] + p3i * t["twr"]
    qr = zr.transpose(1, 2).reshape(b * n1, n2)
    qi = zi.transpose(1, 2).reshape(b * n1, n2)
    rr, ri = _cmatmul(qr, qi, t, "f2")
    yr = rr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    yi = ri.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    return yr, yi


def fused_fft_folded(xr, xi, plan: FusedPlan):
    """Four-step with the digit reversal folded into the final contraction's
    output order ('bck,cJ->bJk'): no explicit transposes."""
    b, n = xr.shape
    assert n == plan.n and plan.kind == "fourstep", (n, plan.n, plan.kind)
    n1, n2 = plan.n1, plan.n2
    t = plan.tables
    x3 = xr.reshape(b, n1, n2)  # [b, a, c]
    if xi is None:
        pr = torch.einsum("bac,ak->bck", x3, t["f1r"])
        pi = torch.einsum("bac,ak->bck", x3, t["f1i"])
    else:
        pr, pi = _ceinsum("bac,ak->bck", x3, xi.reshape(b, n1, n2), t, "f1")
    twr, twi = t["twr"], t["twi"]  # (n2, n1) = [c, k1]
    zr = pr * twr - pi * twi
    zi = pr * twi + pi * twr
    rr, ri = _ceinsum("bck,cJ->bJk", zr, zi, t, "f2")
    return rr.reshape(b, n), ri.reshape(b, n)


def _hermitian_mirror(sr, si, n1: int, axis: int):
    """Full (.., n1, ..) spectra from the computed k1 in [0, n1/2] half.

    With flat index k = k1 + n1*j, X[n-k] = conj(X[k]) maps k1 -> n1-k1 and
    reverses every j digit, so the missing half is the conjugate of the
    computed rows [1, h) reversed over all non-batch axes.
    """
    h = n1 // 2 + 1
    rev_axes = tuple(range(1, sr.dim()))
    tail_r = torch.flip(sr.narrow(axis, 1, h - 1), rev_axes)
    tail_i = -torch.flip(si.narrow(axis, 1, h - 1), rev_axes)
    return (
        torch.cat([sr.narrow(axis, 0, h - 1), tail_r], axis),
        torch.cat([si.narrow(axis, 0, h - 1), tail_i], axis),
    )


def fused_fft_half(xr, plan: FusedPlan):
    """Real-input four-step that computes only k1 <= n1/2 and mirrors the rest."""
    b, n = xr.shape
    assert plan.kind == "fourstep", plan.kind
    n1, n2 = plan.n1, plan.n2
    t = plan.tables
    h = n1 // 2 + 1
    xtr = xr.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    pr = xtr @ t["f1r"][:, :h]
    pi = xtr @ t["f1i"][:, :h]
    p3r = pr.reshape(b, n2, h)
    p3i = pi.reshape(b, n2, h)
    twr = t["twr"][:, :h]
    twi = t["twi"][:, :h]
    zr = p3r * twr - p3i * twi
    zi = p3r * twi + p3i * twr
    qr = zr.transpose(1, 2).reshape(b * h, n2)
    qi = zi.transpose(1, 2).reshape(b * h, n2)
    rr, ri = _cmatmul(qr, qi, t, "f2")
    f_r, f_i = _hermitian_mirror(rr.reshape(b, h, n2), ri.reshape(b, h, n2), n1, axis=1)
    yr = f_r.transpose(1, 2).reshape(b, n)
    yi = f_i.transpose(1, 2).reshape(b, n)
    return yr, yi


def stage_b(yr, yi, n1: int, n2: int, t: dict):
    """Stage B of the staged path: row transforms of length n2 = m1*m2 with
    the global digit reversal folded into the final contraction
    ('bkcj,cJ->bJjk').  ``yr, yi``: (B, n1, n2) stage-A output."""
    b = yr.shape[0]
    m1, m2 = t["m1"], t["m2"]
    zr = yr.reshape(b, n1, m1, m2)
    zi = yi.reshape(b, n1, m1, m2)
    pr, pi = _ceinsum("bkac,aj->bkcj", zr, zi, t, "f1")
    twr, twi = t["twr"], t["twi"]  # (m2, m1) = [a2, j1]
    wr = pr * twr - pi * twi
    wi = pr * twi + pi * twr
    rr, ri = _ceinsum("bkcj,cJ->bJjk", wr, wi, t, "f2")
    n = n1 * n2
    return rr.reshape(b, n), ri.reshape(b, n)


def stage_b_half(yr, yi, n1: int, n2: int, t: dict):
    """Real-input stage B: rows k1 <= n1/2 only, then the Hermitian mirror
    and one half-sized digit-reversal transpose."""
    b = yr.shape[0]
    h = n1 // 2 + 1
    m1, m2 = t["m1"], t["m2"]
    zr = yr[:, :h, :].reshape(b, h, m1, m2)
    zi = yi[:, :h, :].reshape(b, h, m1, m2)
    pr, pi = _ceinsum("bkac,aj->bkcj", zr, zi, t, "f1")
    twr, twi = t["twr"], t["twi"]
    wr = pr * twr - pi * twi
    wi = pr * twi + pi * twr
    s_r, s_i = _ceinsum("bkcj,cJ->bkjJ", wr, wi, t, "f2")  # (b, h, m1, m2)
    f_r, f_i = _hermitian_mirror(s_r, s_i, n1, axis=1)  # (b, n1, m1, m2)
    n = n1 * n2
    out_r = f_r.permute(0, 3, 2, 1).reshape(b, n)
    out_i = f_i.permute(0, 3, 2, 1).reshape(b, n)
    return out_r, out_i


def stage_a_torch(x3r, x3i, plan: dict):
    """Column DFT + twiddle of the staged path over (B, n1, n2) views, with
    the factored twiddle rebuilt in full: Y[b, k1, c] = (sum_a F1[k1, a]
    x[b, a, c]) * two[k1, c // ct] * twi[k1, c % ct].  ``x3i`` may be None."""
    f1r, f1i = plan["f1r"], plan["f1i"]
    n1 = f1r.shape[0]
    o_r = plan["two_r"][:, :, None]  # (n1, n2/ct, 1)
    o_i = plan["two_i"][:, :, None]
    i_r = plan["twi_r"][:, None, :]  # (n1, 1, ct)
    i_i = plan["twi_i"][:, None, :]
    n2 = plan["two_r"].shape[1] * plan["twi_r"].shape[1]
    twr = (o_r * i_r - o_i * i_i).reshape(n1, n2)
    twi = (o_r * i_i + o_i * i_r).reshape(n1, n2)
    pr = torch.einsum("ka,bac->bkc", f1r, x3r)
    pi = torch.einsum("ka,bac->bkc", f1i, x3r)
    if x3i is not None:
        pr = pr - torch.einsum("ka,bac->bkc", f1i, x3i)
        pi = pi + torch.einsum("ka,bac->bkc", f1r, x3i)
    return pr * twr - pi * twi, pr * twi + pi * twr
