"""Fused-size transforms and stage B of the staged path, as plain torch ops.

The JAX package writes these engines as jnp einsums and leaves them to XLA
(``gpu_fft_tpu/kernels/fused_jnp.py``); no Pallas kernel stands behind them,
so here they are torch.matmul / torch.einsum contractions against the plan's
tables.  Every function takes split-complex fp32 tensors and returns the
spectrum, or for the real-output inverses the real signal, in natural
order, on the input's device.

Every product goes through :func:`_mm` or :func:`_contract`, which take
the product of ``config.matmul_precision()`` at call time, as the JAX
engines take ``precision=_prec()``: fp32 under "full"; under "high" bf16x3
(each operand split a = hi + lo in bf16, hi*hi + hi*lo + lo*hi summed in
fp32, one product over the stacked depth [hi | hi | lo] x [hi; lo; hi]);
under "fast" bf16x1 (the operands rounded to bf16, fp32 accumulation).  On
the card a bf16 product is ``torch.mm(..., out_dtype=torch.float32)``; on
the CPU, which has no such product, an fp32 product of the bf16-valued
operands, which is the same number: a product of two bf16 values is exact
in fp32.  No product comes back as bf16.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

from .. import config
from ..config import KARATSUBA
from ..plan import FusedPlan

__all__ = [
    "fused_fft",
    "fused_fft_folded",
    "fused_fft_half",
    "fused_irfft",
    "fused_irfft_half",
    "irfft_direct_half",
    "irfft_direct_half_k128",
    "irfft_fold_columns",
    "rfft_direct_packed",
    "rfft_packed_psd",
    "stage_a_torch",
    "stage_a_torch_transpose",
    "stage_b",
    "stage_b_half",
    "stage_b_irfft",
    "stage_b_irfft_from_half",
    "transform_axis0",
]


def _bf16_operands(a, b, mode: str):
    """(A, B) whose product is the ``mode`` product of ``a`` (R, K) and
    ``b`` (K, M): the bf16 roundings, or for bf16x3 the stacked parts
    [a_hi | a_hi | a_lo] and [b_hi; b_lo; b_hi]."""
    a_hi, b_hi = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if mode == "bf16x1":
        return a_hi, b_hi
    a_lo = (a - a_hi.float()).to(torch.bfloat16)
    b_lo = (b - b_hi.float()).to(torch.bfloat16)
    return torch.cat([a_hi, a_hi, a_lo], dim=1), torch.cat([b_hi, b_lo, b_hi], dim=0)


def _bf16_product(a, b, mode: str):
    """The fp32 result of the ``mode`` product of fp32 ``a`` (R, K) and
    ``b`` (K, M)."""
    big_a, big_b = _bf16_operands(a, b, mode)
    if big_a.device.type == "cuda":
        return torch.mm(big_a, big_b, out_dtype=torch.float32)
    return big_a.float() @ big_b.float()


class _Product(torch.autograd.Function):
    """A bf16x3 / bf16x1 product whose gradients and tangents are products
    of the same mode, as JAX transposes a dot at its precision."""

    @staticmethod
    def forward(a, b, mode):
        return _bf16_product(a, b, mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, ctx.mode = inputs
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _mm(g, b.t(), ctx.mode) if ctx.needs_input_grad[0] else None
        gb = _mm(a.t(), g, ctx.mode) if ctx.needs_input_grad[1] else None
        return ga, gb, None

    @staticmethod
    def jvp(ctx, ta, tb, _):
        a, b = ctx.saved_tensors
        out = None if ta is None else _mm(ta, b, ctx.mode)
        if tb is not None:
            out = _mm(a, tb, ctx.mode) if out is None else out + _mm(a, tb, ctx.mode)
        return out


def _tracked(*ts) -> bool:
    """Whether reverse-mode autograd records these tensors or they carry a
    forward-mode tangent (``torch.func`` transforms show as one or the
    other); None entries are skipped."""
    grad = torch.is_grad_enabled()
    return any(t is not None and ((grad and t.requires_grad) or forward_ad.unpack_dual(t).tangent is not None)
               for t in ts)


def _mm(a, b, mode: str | None = None):
    """``a @ b`` for 2-D fp32 operands, in ``mode`` (default: the current
    ``config.matmul_precision()``)."""
    mode = config.matmul_precision() if mode is None else mode
    if mode == "fp32":
        return a @ b
    return _Product.apply(a, b, mode) if _tracked(a, b) else _bf16_product(a, b, mode)


def _contract(eq: str, x, y):
    """``torch.einsum(eq, x, y)`` in the current mode, for an equation that
    contracts exactly one index and shares no other: under "high" and
    "fast" the operands are laid out as one 2-D product (:func:`_mm`) and
    the result is permuted to the output order."""
    mode = config.matmul_precision()
    if mode == "fp32":
        return torch.einsum(eq, x, y)
    ins, out = eq.split("->")
    sx, sy = ins.split(",")
    (k,) = [c for c in sx if c in sy]
    fx = [c for c in sx if c != k]
    fy = [c for c in sy if c != k]
    depth = x.shape[sx.index(k)]
    a = x.permute([sx.index(c) for c in fx] + [sx.index(k)]).reshape(-1, depth)
    b = y.permute([sy.index(k)] + [sy.index(c) for c in fy]).reshape(depth, -1)
    z = _mm(a, b, mode).reshape([x.shape[sx.index(c)] for c in fx] + [y.shape[sy.index(c)] for c in fy])
    return z.permute([(fx + fy).index(c) for c in out])


def _ceinsum(eq, ar, ai, t, prefix):
    """Split-complex einsum against the table group ``prefix`` (Karatsuba
    3-product form when KARATSUBA, else the 4-product form)."""
    if KARATSUBA:
        k1 = _contract(eq, ar + ai, t[prefix + "r"])
        k2 = _contract(eq, ar, t[prefix + "d"])
        k3 = _contract(eq, ai, t[prefix + "s"])
        return k1 - k3, k1 + k2
    rr = _contract(eq, ar, t[prefix + "r"])
    ii = _contract(eq, ai, t[prefix + "i"])
    ri = _contract(eq, ar, t[prefix + "i"])
    ir = _contract(eq, ai, t[prefix + "r"])
    return rr - ii, ri + ir


def _cmatmul(ar, ai, t, prefix):
    """Split-complex (rows, k) @ (k, m) against the table group ``prefix``."""
    if KARATSUBA:
        k1 = _mm(ar + ai, t[prefix + "r"])
        k2 = _mm(ar, t[prefix + "d"])
        k3 = _mm(ai, t[prefix + "s"])
        return k1 - k3, k1 + k2
    fr, fi = t[prefix + "r"], t[prefix + "i"]
    return _mm(ar, fr) - _mm(ai, fi), _mm(ar, fi) + _mm(ai, fr)


def fused_fft(xr, xi, plan: FusedPlan):
    """Direct or transpose-form four-step transform of each (B, n) row;
    ``xi`` may be None (real input)."""
    b, n = xr.shape
    assert n == plan.n, (n, plan.n)
    t = plan.tables
    if plan.kind == "direct":
        if xi is None:
            return _mm(xr, t["fr"]), _mm(xr, t["fi"])
        return _cmatmul(xr, xi, t, "f")

    n1, n2 = plan.n1, plan.n2
    xtr = xr.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    if xi is None:
        pr = _mm(xtr, t["f1r"])
        pi = _mm(xtr, t["f1i"])
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
        pr = _contract("bac,ak->bck", x3, t["f1r"])
        pi = _contract("bac,ak->bck", x3, t["f1i"])
    else:
        pr, pi = _ceinsum("bac,ak->bck", x3, xi.reshape(b, n1, n2), t, "f1")
    twr, twi = t["twr"], t["twi"]  # (n2, n1) = [c, k1]
    zr = pr * twr - pi * twi
    zi = pr * twi + pi * twr
    rr, ri = _ceinsum("bck,cJ->bJk", zr, zi, t, "f2")
    return rr.reshape(b, n), ri.reshape(b, n)


def transform_axis0(xr, xi, n: int, sign: int, scale: float | None = None):
    """Length-n transform along axis -2 of (..., n, w) tensors, in place of
    transpose, row transform, transpose back: the column pass of a 2-D
    transform (``ops/fft2d.py``, where ``plan.axis0_applies``).

    The four-step's contractions with the width a free trailing axis,
    'bacw,ak->bckw' then 'bckw,cJ->bJkw' (the digit reversal folded into
    the output order), on the row engines' tables
    (``plan.get_fused_plan(n, sign, wide=False, scale)``; a direct plan is
    one contraction, F being symmetric).  ``xi`` may be None (real input).
    Unnormalized unless ``scale``; power-of-two n <= FUSED_MAX.
    """
    from ..plan import get_fused_plan, on_device

    lead = xr.shape[:-2]
    h, w = xr.shape[-2], xr.shape[-1]
    assert h == n, (h, n)
    x3r = xr.reshape(-1, h, w)
    x3i = None if xi is None else xi.reshape(-1, h, w)
    plan = on_device(get_fused_plan, n, sign, False, scale, device=xr.device)
    t = plan.tables
    if plan.kind == "direct":
        if x3i is None:
            yr = _contract("bhw,hk->bkw", x3r, t["fr"])
            yi = _contract("bhw,hk->bkw", x3r, t["fi"])
        else:
            yr, yi = _ceinsum("bhw,hk->bkw", x3r, x3i, t, "f")
        return yr.reshape(*lead, h, w), yi.reshape(*lead, h, w)
    n1, n2 = plan.n1, plan.n2
    x4r = x3r.reshape(-1, n1, n2, w)
    if x3i is None:
        pr = _contract("bacw,ak->bckw", x4r, t["f1r"])
        pi = _contract("bacw,ak->bckw", x4r, t["f1i"])
    else:
        pr, pi = _ceinsum("bacw,ak->bckw", x4r, x3i.reshape(-1, n1, n2, w), t, "f1")
    twr = t["twr"][None, :, :, None]  # (n2, n1) = [c, k]
    twi = t["twi"][None, :, :, None]
    zr = pr * twr - pi * twi
    zi = pr * twi + pi * twr
    rr, ri = _ceinsum("bckw,cJ->bJkw", zr, zi, t, "f2")
    return rr.reshape(*lead, h, w), ri.reshape(*lead, h, w)


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
    pr = _mm(xtr, t["f1r"][:, :h])
    pi = _mm(xtr, t["f1i"][:, :h])
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


# ── Real output: the Hermitian-fold inverses ─────────────────────────────────


def fused_irfft(xr, xi, plan: dict):
    """Real-output inverse of a full (B, n) Hermitian spectrum, folded.

    With the spectrum as an (n2, n1) grid (flat k = k1 + n1*k2), column
    n1 - k1 is the conjugate k2-reversal of column k1, so

        x[m1*n2 + m2] = Re(sum_{k1 <= n1/2} c_k1 w_n1^(m1 k1) w_n^(m2 k1) G[k1, m2]),
        G[k1, m2] = sum_k2 X[k1 + n1*k2] w_n2^(m2 k2),

    with c and the scale in the tables (``plan.get_irfft_plan``): stage 1
    contracts only the h1 = n1/2 + 1 kept columns, stage 2 is real, and its
    output order is the natural one.  Only the kept columns of ``xr, xi``
    are read.  Correct only for a Hermitian input.  Returns (B, n) real.
    """
    b, n = xr.shape
    n1, n2, h1 = plan["n1"], plan["n2"], plan["h1"]
    assert n == n1 * n2, (n, n1, n2)
    gr = xr.reshape(b, n2, n1)[:, :, :h1]  # [b, k2, k1]
    gi = xi.reshape(b, n2, n1)[:, :, :h1]
    return _irfft_fold_core(gr, gi, plan)


def fused_irfft_half(xr, xi, plan: dict):
    """Real-output inverse straight from the ONE-SIDED (B, h = n/2 + 1)
    spectrum: :func:`fused_irfft`'s (B, n2, h1) fold grid
    g[k2, k1] = X[k1 + n1 k2] built from the given bins rather than from a
    full Hermitian mirror.  With L[k2, k1] = X[k1 + n1 k2], k2 < n2/2:

    * rows k2 < n2/2: g = L[:, :h1];
    * rows k2 >= n2/2, k1 >= 1: conj(X[(n1 - k1) + n1 (n2 - 1 - k2)]), a
      flip over (k2, k1) of L's k1 >= n1/2 half, conjugated;
    * rows k2 > n2/2, k1 = 0: conj(L[n2 - k2, 0]), flipped block starts;
      k2 = n2/2, k1 = 0 is the Nyquist bin X[n/2].

    DC / Nyquist imaginary parts are ignored (numpy ``irfft``).  ``plan``:
    ``plan.get_irfft_plan``.  Returns the (B, n) real signal.
    """
    b = xr.shape[0]
    n1, n2, h1 = plan["n1"], plan["n2"], plan["h1"]
    half = n1 * n2 // 2
    assert xr.shape[-1] == half + 1, (tuple(xr.shape), n1 * n2)
    zero = xi.new_zeros(b, 1)
    xi = torch.cat([zero, xi[:, 1:half], zero], dim=1)
    lr = xr[:, :half].reshape(b, n2 // 2, n1)
    li = xi[:, :half].reshape(b, n2 // 2, n1)
    hi_r = torch.flip(lr[:, :, n1 // 2 :], (1, 2))
    hi_i = -torch.flip(li[:, :, n1 // 2 :], (1, 2))
    q0_r = torch.cat([xr[:, half:], torch.flip(lr[:, 1:, 0], (1,))], dim=1)[..., None]
    q0_i = torch.cat([xi[:, half:], -torch.flip(li[:, 1:, 0], (1,))], dim=1)[..., None]
    gr = torch.cat([lr[:, :, :h1], torch.cat([q0_r, hi_r], dim=2)], dim=1)
    gi = torch.cat([li[:, :, :h1], torch.cat([q0_i, hi_i], dim=2)], dim=1)
    return _irfft_fold_core(gr, gi, plan)


def _irfft_fold_core(gr, gi, plan: dict):
    """The fold's contractions on the (B, n2, h1) grid of kept columns."""
    b = gr.shape[0]
    n1, n2 = plan["n1"], plan["n2"]
    # Stage 1: contract k2 -> m2 over the kept k1 columns.
    gr_m, gi_m = _ceinsum("bck,cm->bkm", gr, gi, plan, "g2")  # (b, h1, n2)
    twr, twi = plan["twr"], plan["twi"]  # (h1, n2) = [k1, m2]
    zr = gr_m * twr - gi_m * twi
    zi = gr_m * twi + gi_m * twr
    # Stage 2: contract k1 in [0, n1/2), real part only, natural order out.
    half = n1 // 2
    out = _contract("bkm,kM->bMm", zr[:, :half], plan["w1r"]) - _contract(
        "bkm,kM->bMm", zi[:, :half], plan["w1i"]
    )
    # The Nyquist column k1 = n1/2: its stage-2 factor is scale * (-1)^m1.
    out = out + plan["alt"][None, :, None] * zr[:, half, :][:, None, :]
    return out.reshape(b, n1 * n2)


def irfft_direct_half(xr, xi, plan: dict):
    """Direct real-output inverse from the one-sided (B, h) spectrum: two
    real products against the folded tables (``plan.get_irfft_direct_plan``;
    their zero sin rows ignore DC/Nyquist imaginary parts)."""
    return _mm(xr, plan["cr"]) + _mm(xi, plan["ci"])


def rfft_direct_packed(x, plan: dict):
    """Direct real forward as ONE product against the packed (n, n) table
    (``plan.get_rfft_direct_packed_plan``).  Returns the packed (B, n)
    product (columns [0, h) = Re X, [h, n) = Im X[1..h-1)) and the
    one-sided pair (fr, fi), (B, h) each."""
    out = _mm(x, plan["t"])
    h = plan["h"]
    zero = out.new_zeros(out.shape[0], 1)
    return out, out[:, :h], torch.cat([zero, out[:, h:], zero], dim=1)


def rfft_packed_psd(x, plan: dict):
    """One-sided |X|^2 from the packed product: re^2 from columns [0, h),
    im^2 of bins 1 .. h-2 from columns [h, n), added by an index-add on a
    copy (no unpacking)."""
    out = _mm(x, plan["t"])
    h = plan["h"]
    sq = out * out
    bins = torch.arange(1, h - 1, device=out.device)
    return sq[:, :h].index_add(1, bins, sq[:, h:])


def irfft_direct_half_k128(xr, xi, plan: dict):
    """:func:`irfft_direct_half` contracting K = n/2 and adding the Nyquist
    row as a broadcast (``plan.get_irfft_direct_k128_plan``)."""
    return _mm(xr[:, :-1], plan["cr"]) + _mm(xi[:, :-1], plan["ci"]) + xr[:, -1:] * plan["alt"]


def stage_b_irfft(yr, yi, n1: int, t: dict):
    """Real-output stage B of the staged inverse from the FULL (B, n1, n2)
    stage-A output: each k1 row is Hermitian over n2
    (``plan.get_stage_b_irfft_plan``), so the fused fold runs per row with
    the fold digit Q = 128 on the row's minor digit.  Returns (B, n) real."""
    q, p = t["n1"], t["n2"]
    b = yr.shape[0]
    gr = yr.reshape(b, n1, p, q)[..., : t["h1"]]  # [b, K, p, q]
    gi = yi.reshape(b, n1, p, q)[..., : t["h1"]]
    return stage_b_irfft_from_half(gr, gi, t)


def irfft_fold_columns(zr, zi, t: dict):
    """The fold's (B, n1, P, h) input from HALF the stage-A columns.

    ``zr, zi``: (B, n1, W), the first W >= n2/2 + 1 post-twiddle stage-A
    columns.  The rest are conjugate mirrors, Z[k1, n2 - c] = conj(Z[k1, c]),
    so the p >= P/2 blocks of g[p, q] = Z[p*Q + q], q <= Q/2, are flips of
    the computed range:

    * q in [1, Q/2]: g[p, q] = conj(Z[(P-1-p)*Q + (Q-q)]), a flip over
      (p, q) of the computed blocks' upper-q half;
    * q = 0: g[p, 0] = conj(Z[(P-p)*Q]), a flip of the block starts
      p'' = 1 .. P/2, the last of which is column n2/2 itself.

    Each flip and concatenation is a copy on the card.
    """
    b, n1 = zr.shape[0], zr.shape[1]
    q, p, h = t["n1"], t["n2"], t["h1"]
    ph = p // 2
    assert zr.shape[2] >= ph * q + 1, (zr.shape, p, q)
    blk_r = zr[:, :, : ph * q].reshape(b, n1, ph, q)
    blk_i = zi[:, :, : ph * q].reshape(b, n1, ph, q)
    # p >= P/2, q in [1, Q/2]: flip over (p', q') of the q' in (Q/2, Q) half.
    hi_r = torch.flip(blk_r[..., q - h + 1 :], (2, 3))
    hi_i = -torch.flip(blk_i[..., q - h + 1 :], (2, 3))
    # p >= P/2, q = 0: block starts p'' = 1 .. P/2, flipped.
    q0_r = torch.cat([blk_r[:, :, 1:, 0], zr[:, :, ph * q : ph * q + 1]], dim=2)
    q0_i = torch.cat([blk_i[:, :, 1:, 0], zi[:, :, ph * q : ph * q + 1]], dim=2)
    q0_r = torch.flip(q0_r, (2,))[..., None]
    q0_i = -torch.flip(q0_i, (2,))[..., None]
    gr = torch.cat([blk_r[..., :h], torch.cat([q0_r, hi_r], dim=3)], dim=2)
    gi = torch.cat([blk_i[..., :h], torch.cat([q0_i, hi_i], dim=3)], dim=2)
    return gr, gi


def stage_b_irfft_from_half(gr, gi, t: dict):
    """The per-row fold on a (B, n1, P, h) input (:func:`stage_b_irfft`,
    :func:`irfft_fold_columns`).  Returns the (B, n) real signal, natural
    order."""
    b, n1 = gr.shape[0], gr.shape[1]
    q, p = t["n1"], t["n2"]
    # Stage 1: contract the major row digit p -> m over the kept half.
    gr_m, gi_m = _ceinsum("bKpq,pm->bKqm", gr, gi, t, "g2")  # (b, n1, h, P)
    twr, twi = t["twr"], t["twi"]  # (h, P) = [q, m]
    zr = gr_m * twr - gi_m * twi
    zi = gr_m * twi + gi_m * twr
    # Stage 2: contract q in [0, Q/2), real part only; [b, M, m, K] is the
    # global natural order k = K + n1 * (M * P + m).
    half = q // 2
    out = _contract("bKqm,qM->bMmK", zr[:, :, :half], t["w1r"]) - _contract(
        "bKqm,qM->bMmK", zi[:, :, :half], t["w1i"]
    )
    # Nyquist (q = Q/2): the real factor scale * (-1)^M times the (b, m, K) slice.
    nyq = zr[:, :, half, :].permute(0, 2, 1)
    out = out + t["alt"][None, :, None, None] * nyq[:, None]
    return out.reshape(b, n1 * p * q)


def _stage_a_twiddle(plan: dict):
    """The stage-A twiddle W (n1, n2) of a plan: the factored one rebuilt in
    full, two[k1, c // ct] * twi[k1, c % ct] (the production plan), or a
    legacy materialized ``twr``/``twi`` pair."""
    if "two_r" not in plan:
        return plan["twr"], plan["twi"]
    n1 = plan["f1r"].shape[0]
    o_r = plan["two_r"][:, :, None]  # (n1, n2/ct, 1)
    o_i = plan["two_i"][:, :, None]
    i_r = plan["twi_r"][:, None, :]  # (n1, 1, ct)
    i_i = plan["twi_i"][:, None, :]
    n2 = plan["two_r"].shape[1] * plan["twi_r"].shape[1]
    return (o_r * i_r - o_i * i_i).reshape(n1, n2), (o_r * i_i + o_i * i_r).reshape(n1, n2)


def stage_a_torch(x3r, x3i, plan: dict):
    """Column DFT + twiddle of the staged path over (B, n1, n2) views:
    Y[b, k1, c] = (sum_a F1[k1, a] x[b, a, c]) * W[k1, c].  ``x3i`` may be
    None.  W: :func:`_stage_a_twiddle`."""
    f1r, f1i = plan["f1r"], plan["f1i"]
    twr, twi = _stage_a_twiddle(plan)
    pr = _contract("ka,bac->bkc", f1r, x3r)
    pi = _contract("ka,bac->bkc", f1i, x3r)
    if x3i is not None:
        pr = pr - _contract("ka,bac->bkc", f1i, x3i)
        pi = pi + _contract("ka,bac->bkc", f1r, x3i)
    return pr * twr - pi * twi, pr * twi + pi * twr


def stage_a_torch_transpose(gr, gi, plan: dict):
    """The transpose (real-form adjoint) of stage A on a complex input:
    x-bar[b, a, c] = sum_k1 conj(F1[k1, a]) * conj(W[k1, c]) * g[b, k1, c].

    ``plan``: the whole stage-A plan (all n1 rows, all column tiles);
    ``gr, gi``: the (B, rows, cols) cotangent of a call that kept the first
    ``rows`` rows and ``cols`` columns, zero-padded here back to (B, n1, n2)
    (the dropped outputs take no part).  Returns the (B, n1, n2) pair; a real
    input's gradient is its real part.  The autodiff rule of the staged
    fold's K3 call (``kernels/large.py:_StageAFold``), where the JAX package
    transposes its einsum engine ``stage_a_jnp``."""
    f1r, f1i = plan["f1r"], plan["f1i"]
    twr, twi = _stage_a_twiddle(plan)
    n1, n2 = twr.shape
    pad = (0, n2 - gr.shape[2], 0, n1 - gr.shape[1])
    gr = torch.nn.functional.pad(gr, pad)
    gi = torch.nn.functional.pad(gi, pad)
    hr = gr * twr + gi * twi  # conj(W) * g
    hi = gi * twr - gr * twi
    xr = _contract("ka,bkc->bac", f1r, hr) + _contract("ka,bkc->bac", f1i, hi)
    xi = _contract("ka,bkc->bac", f1r, hi) - _contract("ka,bkc->bac", f1i, hr)
    return xr, xi
