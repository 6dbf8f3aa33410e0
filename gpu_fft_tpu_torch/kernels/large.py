"""The transform dispatch: any power-of-two n from 2 to MAX_N, batched rows.

Port of ``gpu_fft_tpu/kernels/large.py:transform_any`` and ``_staged``.  What
a (B, n) call runs is decided in one place, ``plan.route`` (shown by
``plan.describe_plan``); each function here takes the route once and runs
the engine it names, in the span it names.  :func:`inverse_real` and
:func:`inverse_real_half` are the real-output inverses.

Autodiff (``gpu_fft_tpu/kernels/large.py``'s seams): the kernels fill their
outputs through ctypes, which autograd cannot see, so each kernel call on
these paths sits inside a ``torch.autograd.Function`` whose backward and
forward-mode rules run the same dispatch again:

* :class:`_WholeTransform` (K1/K2 in the band) and :class:`_StagedTransform`
  (the whole staged body: K3 and stage B, K4 or torch).  A transform is a
  symmetric complex-linear map (F^T = F), so its real-form transpose is
  conj . T . conj: the backward is the Function itself on the conjugated
  cotangent, the JVP the Function on the tangent.  Both call ``apply``, so
  the backward graph is differentiable again (Hessian-vector products).
* :class:`_StageAFold` (K3 on the first column tiles in
  :func:`inverse_real`'s staged fold): the JVP is K3 on the tangent, the
  backward the written-out transpose ``stage_a_torch_transpose``.

None saves a tensor: each map is linear, so a rule needs only its key
(n, sign, scale, and K1/K2's route; n, the kept column tiles and the
route).  A call whose inputs no autodiff mode sees runs the wrapped body
straight (``_through``), since ``apply`` costs host time.  On the CPU the
same rules run over the plain versions.  ``vmap`` is not supported (nor in
the JAX package at staged sizes): fold extra axes into B.

Profiler spans (``utils/profiling.py:span``): the body of each dispatch
function is ``gft.dispatch`` (a recursive call nests), and each engine runs
in the ``gft.engine.*`` span its route names.  Plans are looked up in
dispatch, outside the engine's span.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..plan import (
    get_fused_plan,
    get_irfft_direct_k128_plan,
    get_irfft_direct_plan,
    get_irfft_plan,
    get_pack_tables,
    get_stage_a_plan,
    get_stage_b_irfft_plan,
    get_stage_b_twiddle,
    get_whole_packed_plan,
    get_whole_plan,
    on_device,
    route,
    stage_a_ct_full_range,
    stage_a_real_rows,
    staged_route,
)
from ..utils.profiling import span
from .fused import stage_a, stage_b_kernel, whole_transform, whole_transform_packed
from .fused_torch import (
    _tracked,
    fused_fft,
    fused_fft_folded,
    fused_fft_half,
    fused_irfft,
    irfft_direct_half,
    irfft_direct_half_k128,
    irfft_fold_columns,
    stage_a_torch,
    stage_a_torch_transpose,
    stage_b,
    stage_b_half,
    stage_b_irfft_from_half,
)

__all__ = ["inverse_real", "inverse_real_half", "transform_any"]


def transform_any(xr, xi, n: int, sign: int, scale: float | None = None):
    """Split-complex transform of each row of a (B, n) fp32 batch.

    ``xi`` may be None (real input).  Unnormalized unless ``scale`` is given
    (1/n for a normalized inverse): at fused sizes it is folded into the last
    table; at staged sizes the staged body applies it, in K4's store where
    the route runs K4 and as a multiply after any other stage B.  Natural
    output order, on the input's device.
    """
    with span("gft.dispatch"):
        r = route(xr.shape[0], n, real_input=xi is None, sign=sign)
        if r.path == "whole":
            return _through(_WholeTransform, _whole, xr, xi, (n, sign, scale, r))
        if r.path == "packed_real":
            with span(r.spans[0]):
                return _real_packed_fft(xr, n, scale)
        if r.path == "staged":
            return _through(_StagedTransform, _staged, xr, xi, (n, sign, scale))
        plan = on_device(get_fused_plan, n, sign, r.wide, scale, device=xr.device)
        with span(r.spans[0]):
            if r.layout == "half-spectrum":
                return fused_fft_half(xr, plan)
            if r.layout == "folded":
                return fused_fft_folded(xr, xi, plan)
            return fused_fft(xr, xi, plan)


# ── Autodiff seams ───────────────────────────────────────────────────────────


def _through(function, body, xr, xi, key):
    """``function.apply`` where an autodiff mode can see the inputs, else the
    ``body`` it wraps, straight: ``apply`` costs host time on every call."""
    return function.apply(xr, xi, key) if _tracked(xr, xi) else body(xr, xi, key)


def _whole(xr, xi, key):
    """K1 or K2 (the route's kernel) on the rows of a (B, n) batch in the
    band, ``key`` = (n, sign, scale, route)."""
    n, sign, scale, r = key
    # The kernels read rows densely; a strided view (a 2-D pass's columns,
    # a frame's segments) is copied once, as the torch engines' first
    # contraction would.
    xr, xi = _contiguous(xr), _contiguous(xi)
    packed = r.kernel in ("K2", "K2F")
    plan = on_device(get_whole_packed_plan if packed else get_whole_plan, n, sign, scale, device=xr.device)
    with span(r.spans[0]):
        return (whole_transform_packed if packed else whole_transform)(xr, xi, plan)


def _stage_a_fold(x3r, x3i, key):
    """Stage A with the inverse plan (default tile) on the first ``tiles``
    column tiles of a (B, n1, n2) view, ``key`` = (n, tiles, route): K3,
    or the torch product where the route names no kernel."""
    n, tiles, r = key
    plan = on_device(get_stage_a_plan, n, +1, None, device=x3r.device)
    if r.kernel is None:
        yr, yi = stage_a_torch(x3r, x3i, plan)
        cols = tiles * plan["ct"]
        return yr[:, :, :cols], yi[:, :, :cols]
    return stage_a(x3r, x3i, plan["n1"], plan["n2"], plan, plan["ct"], col_tiles=tiles)


def _contiguous(t):
    """A cotangent or tangent as a kernel takes it: contiguous (``y.sum()``
    hands back a stride-0 tensor); None stays None."""
    return None if t is None else t.contiguous()


def _complex_linear(apply, ar, ai):
    """``apply(ar + i ai)`` for a complex-linear ``apply(re, im)`` whose
    imaginary part may be None; a None ``ar`` is zero: T(i a) = i T(a)."""
    if ar is None:
        if ai is None:
            return None, None
        yr, yi = apply(_contiguous(ai), None)
        return -yi, yr
    return apply(_contiguous(ar), _contiguous(ai))


def _self_transpose(apply, real_input: bool, gr, gi):
    """Real-form transpose of a symmetric complex-linear map T (F^T = F):
    x-bar = conj(T(conj(g))); for real input only its real part."""
    tr, ti = _complex_linear(apply, gr, None if gi is None else -gi)
    if real_input:
        return tr, None
    return tr, None if ti is None else -ti


class _WholeTransform(torch.autograd.Function):
    """K1 (``whole_transform``) or K2 (``whole_transform_packed``) on a (B, n)
    batch in the band, ``key`` = (n, sign, scale, route): the scale folded
    into the plan is real, so the transpose carries it unchanged."""

    @staticmethod
    def forward(xr, xi, key):
        return _whole(xr, xi, key)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.key = inputs[2]
        ctx.real_input = inputs[1] is None
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gr, gi):
        def apply(a, b):
            return _WholeTransform.apply(a, b, ctx.key)

        return (*_self_transpose(apply, ctx.real_input, gr, gi), None)

    @staticmethod
    def jvp(ctx, txr, txi, _):
        return _complex_linear(lambda a, b: _WholeTransform.apply(a, b, ctx.key), txr, txi)


class _StagedTransform(torch.autograd.Function):
    """The staged body :func:`_staged` (K3 and stage B), ``key`` = (n, sign,
    scale): the scale is real, so the transpose carries it unchanged."""

    @staticmethod
    def forward(xr, xi, key):
        return _staged(xr, xi, key)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.key = inputs[2]
        ctx.real_input = inputs[1] is None
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gr, gi):
        def apply(a, b):
            return _StagedTransform.apply(a, b, ctx.key)

        return (*_self_transpose(apply, ctx.real_input, gr, gi), None)

    @staticmethod
    def jvp(ctx, txr, txi, _):
        return _complex_linear(lambda a, b: _StagedTransform.apply(a, b, ctx.key), txr, txi)


class _StageAFold(torch.autograd.Function):
    """K3 over a (B, n1, n2) view with the inverse plan (sign +1, default
    tile), the first ``tiles`` column tiles kept: ``key`` = (n, tiles,
    route).  The JVP is K3 on the tangent; the backward the transpose
    ``stage_a_torch_transpose`` (the JAX package transposes its einsum
    engine there), whose torch ops autograd differentiates again."""

    @staticmethod
    def forward(x3r, x3i, key):
        return _stage_a_fold(x3r, x3i, key)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.key = inputs[2]
        ctx.real_input = inputs[1] is None
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gr, gi):
        if gr is None and gi is None:
            return None, None, None
        gr = torch.zeros_like(gi) if gr is None else gr
        gi = torch.zeros_like(gr) if gi is None else gi
        plan = on_device(get_stage_a_plan, ctx.key[0], +1, None, device=gr.device)
        xr, xi = stage_a_torch_transpose(gr, gi, plan)
        return xr, None if ctx.real_input else xi, None

    @staticmethod
    def jvp(ctx, txr, txi, _):
        return _complex_linear(lambda a, b: _StageAFold.apply(a, b, ctx.key), txr, txi)


def _staged(xr, xi, key):
    """The staged body of :func:`transform_any`, ``key`` = (n, sign, scale),
    on its own inputs' route (``plan.staged_route``).  K4 applies the scale
    in its store; after any other stage B the scale is a multiply."""
    n, sign, scale = key
    b = xr.shape[0]
    dev = xr.device
    r = staged_route(b, n, real_input=xi is None)
    plan = on_device(get_stage_a_plan, n, sign, stage_a_ct_full_range(n), device=dev)
    n1, n2 = r.split
    tw = on_device(get_stage_b_twiddle, n2, sign, device=dev) if r.stage_b == "K4" else None
    x3r = xr.reshape(b, n1, n2)
    x3i = None if xi is None else xi.reshape(b, n1, n2)
    with span(r.spans[0]):
        if r.kernel is None:
            yr, yi = stage_a_torch(x3r, x3i, plan)
        else:
            half_rows = stage_a_real_rows(n1) if r.layout == "half-spectrum" else None
            yr, yi = stage_a(x3r, x3i, n1, n2, plan, plan["ct"], rows=half_rows)

    with span(r.spans[1]):
        if r.stage_b == "K4":  # K3's output is contiguous; the plain stage A's is not
            return stage_b_kernel(yr.contiguous(), yi.contiguous(), n1, n2, plan["stage_b"], tw, scale)
        if r.stage_b == "recursive":
            # Row transforms of length n2, then the digit reversal (flat
            # k = k1 + n1 * k2).
            rr, ri = transform_any(yr.reshape(b * n1, n2), yi.reshape(b * n1, n2), n2, sign)
            out_r = rr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
            out_i = ri.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
        else:
            engine = stage_b_half if r.stage_b == "half" else stage_b
            out_r, out_i = engine(yr, yi, n1, n2, plan["stage_b"])
    if scale is None:
        return out_r, out_i
    return out_r * scale, out_i * scale


@functools.lru_cache(maxsize=None)
def _pack_twiddle(n: int, scale: float | None) -> dict:
    """The packed forward's twiddle W_n^k, k < n/2, times ``hs`` = (1/2)
    scale, in f32 as the JAX package folds it at trace time."""
    hs = np.float32(0.5 if scale is None else 0.5 * scale)
    wr, wi = get_pack_tables(n)
    return {"wr": wr * hs, "wi": wi * hs, "hs": float(hs)}


def _real_packed_fft(xr, n: int, scale):
    """Length-n real forward transform as ONE length-n/2 complex transform
    and an O(n) recombination (``gpu_fft_tpu/kernels/large.py:
    _real_packed_fft``).

    z[j] = x[2j] + i x[2j+1], Z = FFT_{n/2}(z) through :func:`transform_any`
    (K1 or K3 and their autograd seams where n/2 falls in their range), then
    with Z'[k] = conj(Z[(n/2 - k) mod n/2]):

        E[k] = (Z[k] + Z'[k]) / 2,  O[k] = -i (Z[k] - Z'[k]) / 2,
        X[k] = E[k] + W_n^k O[k],   X[k + n/2] = E[k] - W_n^k O[k].

    The even / odd split is two strided slices made contiguous (the JAX
    package's permutation matmul exists to avoid lane shuffles on the TPU),
    the mirror a flip and a roll by one.  ``scale`` folds into the 1/2 and
    the twiddle (:func:`_pack_twiddle`).  Every step is a torch op or an
    autograd seam, so gradients flow through the split and the epilogue.
    """
    h = n // 2
    zr = xr[:, 0::2].contiguous()
    zi = xr[:, 1::2].contiguous()
    Zr, Zi = transform_any(zr, zi, h, -1)
    Zr_m = torch.roll(torch.flip(Zr, (-1,)), 1, -1)
    Zi_m = torch.roll(torch.flip(Zi, (-1,)), 1, -1)
    w = on_device(_pack_twiddle, n, scale, device=xr.device)
    wr, wi, hs = w["wr"], w["wi"], w["hs"]
    er = (Zr + Zr_m) * hs
    ei = (Zi - Zi_m) * hs
    o2r = Zi + Zi_m  # 2 Re(O); the 1/2 is in the twiddle
    o2i = Zr_m - Zr  # 2 Im(O)
    tr = wr * o2r - wi * o2i
    ti = wr * o2i + wi * o2r
    return torch.cat([er + tr, er - tr], dim=1), torch.cat([ei + ti, ei - ti], dim=1)


def inverse_real(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse of a HERMITIAN (B, n) spectrum, on its route.

    The fused fold folds the conjugate half of the input before the
    contractions (:func:`fused_irfft`).  The staged fold runs stage A on
    only the first ceil((n2/2 + 1) / ct) column tiles of the (n1, n2) view,
    at the plan's default tile (the post-twiddle output is
    conjugate-symmetric over columns), rebuilds the rest by flips
    (:func:`irfft_fold_columns`) and folds stage B per row.  Elsewhere
    :func:`transform_any` with the imaginary part dropped.  Unnormalized
    unless ``scale`` is given; at the fold sizes it lives in the tables.
    Correct only for Hermitian input.
    """
    with span("gft.dispatch"):
        dev = xr.device
        r = route(xr.shape[0], n, real_output=True)
        if r.path == "irfft_fold":
            plan = on_device(get_irfft_plan, n, scale, None, device=dev)
            with span(r.spans[0]):
                return fused_irfft(xr, xi, plan)
        if r.path == "irfft_fold_staged":
            bt = on_device(get_stage_b_irfft_plan, n, scale, device=dev)
            b = xr.shape[0]
            plan = on_device(get_stage_a_plan, n, +1, None, device=dev)
            n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
            tiles = -(-(n2 // 2 + 1) // ct)
            with span(r.spans[0]):
                yr, yi = _through(_StageAFold, _stage_a_fold, xr.reshape(b, n1, n2),
                                  xi.reshape(b, n1, n2), (n, tiles, r))
            with span(r.spans[1]):
                return stage_b_irfft_from_half(*irfft_fold_columns(yr, yi, bt), bt)
        yr, _ = transform_any(xr, xi, n, +1, scale=scale)
        return yr


def inverse_real_half(xr, xi, n: int, scale: float | None = None):
    """Real-output inverse from the ONE-SIDED (B, h = n/2 + 1) spectrum.

    At n <= DIRECT_MAX two real products against the folded tables
    (:func:`irfft_direct_half`, or the K = n/2 form on the route's
    ``irfft_direct_k128``).  Above, the Hermitian mirror
    X[n - k] = conj(X[k]) is rebuilt (two flips and two concatenations) and
    :func:`inverse_real` runs.  DC/Nyquist imaginary parts are ignored on
    every path (numpy ``irfft`` semantics).
    """
    with span("gft.dispatch"):
        h = n // 2 + 1
        if xr.shape[-1] != h:
            raise ValueError(f"inverse_real_half expects {h} bins for n={n}, got {xr.shape[-1]}")
        dev = xr.device
        r = route(xr.shape[0], n, real_output=True, one_sided=True)
        if r.path == "irfft_direct_k128":
            plan = on_device(get_irfft_direct_k128_plan, n, scale, device=dev)
            with span(r.spans[0]):
                return irfft_direct_half_k128(xr, xi, plan)
        if r.path == "irfft_direct":
            plan = on_device(get_irfft_direct_plan, n, scale, device=dev)
            with span(r.spans[0]):
                return irfft_direct_half(xr, xi, plan)
        mid_i = xi[:, 1 : h - 1]
        zero = xi.new_zeros(xi.shape[0], 1)
        full_r = torch.cat([xr, torch.flip(xr[:, 1 : h - 1], (1,))], dim=1)
        full_i = torch.cat([zero, mid_i, zero, -torch.flip(mid_i, (1,))], dim=1)
        return inverse_real(full_r, full_i, n, scale=scale)
