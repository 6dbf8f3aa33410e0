"""Autodiff through the port's transforms against the JAX package's, on the CPU.

The kernels sit behind three ``torch.autograd.Function``s
(``gpu_fft_tpu_torch/kernels/large.py``): ``_WholeTransform`` (K1/K2 in
the B = 1 band), ``_StagedTransform`` (K3 and stage B) and ``_StageAFold``
(K3 in the staged irfft fold).  On the CPU their rules run over the plain
versions, so these tests exercise the formulas the card runs.  The same
seeded inputs go through ``jax.grad`` / ``jax.vjp`` / ``jax.jvp`` of the JAX
package (Pallas in interpret mode); gate: max |port - JAX| <= 1e-5 max |JAX|.
The identities need no reference: Parseval (d/dx sum |X|^2 = 2 n x), the
dot test <L v, w> = <v, L^T w> (inner products in float64) and the
Hessian-vector product H v = 2 n v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import gpu_fft_tpu as gf
import gpu_fft_tpu.kernels.large as jlarge
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.kernels.large as tlarge
from gpu_fft_tpu_torch import plan as P
from gpu_fft_tpu_torch.kernels.fused_torch import stage_a_torch_transpose

RTOL = 1e-5
SIZES = [512, 1024, 4096, 1 << 17]  # direct (torch), K2, K1, staged (K3)
CASES = [(n, sign, cplx) for n in SIZES for sign in (-1, 1) for cplx in (False, True)]
IRFFT_SIZES = [1 << 17, 1 << 18]  # the full staged inverse; the staged fold (K3 on half the tiles)
IRFFT_DEVICE_N = 1 << 17  # irfft_device: its mirror, then inverse_real


def _close(got, want, rtol=RTOL):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= rtol * scale, f"max|d| {err:.3e} > {rtol} * {scale:.3e}"


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


def _power(yr, yi, lib):
    return lib.sum(yr**2 + yi**2)


@pytest.fixture(scope="module")
def jax_ad():
    """The JAX package's grad / vjp / jvp per case, computed once."""
    out = {}
    for n in SIZES:
        (x,) = _arrays(n, (1, n))
        out[("grad", n)] = np.asarray(jax.grad(lambda v: _power(*gf.fft_device(v), jnp))(jnp.asarray(x)))
    for n, sign, cplx in CASES:
        a, b, wr, wi, ta, tb = _arrays(n + sign + 7 * cplx, *[(1, n)] * 6)
        args = (jnp.asarray(a), jnp.asarray(b)) if cplx else (jnp.asarray(a),)
        fn = (lambda p, q: jlarge.transform_any(p, q, n, sign)) if cplx else (
            lambda p: jlarge.transform_any(p, None, n, sign))
        _, vjp = jax.vjp(fn, *args)
        tangents = (jnp.asarray(ta), jnp.asarray(tb))[: len(args)]
        _, tan = jax.jvp(fn, args, tangents)
        out[("vjp", n, sign, cplx)] = [np.asarray(g) for g in vjp((jnp.asarray(wr), jnp.asarray(wi)))]
        out[("jvp", n, sign, cplx)] = [np.asarray(t) for t in tan]
    for n in IRFFT_SIZES:
        a, b, w, ta, tb = _arrays(n + 3, *[(1, n)] * 5)
        fn = lambda p, q: jlarge.inverse_real(p, q, n, 1.0 / n)  # noqa: E731
        _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
        out[("inverse_real_vjp", n)] = [np.asarray(g) for g in vjp(jnp.asarray(w))]
        _, tan = jax.jvp(fn, (jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(ta), jnp.asarray(tb)))
        out[("inverse_real_jvp", n)] = np.asarray(tan)
    n, h = IRFFT_DEVICE_N, IRFFT_DEVICE_N // 2 + 1
    sr, si, w = _arrays(n + 5, (1, h), (1, h), (1, n))
    _, vjp = jax.vjp(lambda p, q: gf.irfft_device(p, q), jnp.asarray(sr), jnp.asarray(si))
    out["irfft_vjp"] = [np.asarray(g) for g in vjp(jnp.asarray(w))]
    return out


@pytest.mark.parametrize("n", SIZES)
def test_grad_matches_jax(jax_ad, n):
    (x,) = _arrays(n, (1, n))
    xt = _t(x, True)
    (g,) = torch.autograd.grad(_power(*gt.fft_device(xt), torch), xt)
    _close([g.numpy()], [jax_ad[("grad", n)]])


@pytest.mark.parametrize("n,sign,cplx", CASES)
def test_vjp_and_jvp_match_jax(jax_ad, n, sign, cplx):
    a, b, wr, wi, ta, tb = _arrays(n + sign + 7 * cplx, *[(1, n)] * 6)
    ins = [_t(a, True), _t(b, True)] if cplx else [_t(a, True)]
    out = tlarge.transform_any(ins[0], ins[1] if cplx else None, n, sign)
    grads = torch.autograd.grad(out, ins, grad_outputs=(_t(wr), _t(wi)))
    _close([g.numpy() for g in grads], jax_ad[("vjp", n, sign, cplx)])

    def fn(*xs):
        return tlarge.transform_any(xs[0], xs[1] if cplx else None, n, sign)

    prim = tuple(_t(v) for v in (a, b)[: len(ins)])
    _, tan = torch.func.jvp(fn, prim, tuple(_t(v) for v in (ta, tb)[: len(ins)]))
    _close([t.numpy() for t in tan], jax_ad[("jvp", n, sign, cplx)])


@pytest.mark.parametrize("n", IRFFT_SIZES)
def test_inverse_real_matches_jax(jax_ad, n):
    a, b, w, ta, tb = _arrays(n + 3, *[(1, n)] * 5)
    at, bt = _t(a, True), _t(b, True)
    y = tlarge.inverse_real(at, bt, n, 1.0 / n)
    grads = torch.autograd.grad(y, (at, bt), grad_outputs=_t(w))
    _close([g.numpy() for g in grads], jax_ad[("inverse_real_vjp", n)])
    _, tan = torch.func.jvp(lambda p, q: tlarge.inverse_real(p, q, n, 1.0 / n), (_t(a), _t(b)),
                            (_t(ta), _t(tb)))
    _close([tan.numpy()], [jax_ad[("inverse_real_jvp", n)]])


def test_irfft_device_vjp_matches_jax(jax_ad):
    n, h = IRFFT_DEVICE_N, IRFFT_DEVICE_N // 2 + 1
    sr, si, w = _arrays(n + 5, (1, h), (1, h), (1, n))
    srt, sit = _t(sr, True), _t(si, True)
    grads = torch.autograd.grad(gt.irfft_device(srt, sit), (srt, sit), grad_outputs=_t(w))
    _close([g.numpy() for g in grads], jax_ad["irfft_vjp"])


@pytest.mark.parametrize("n", SIZES)
def test_parseval_gradient(n):
    (x,) = _arrays(n + 11, (1, n))
    xt = _t(x, True)
    (g,) = torch.autograd.grad(_power(*gt.fft_device(xt), torch), xt)
    assert float((g - 2 * n * xt.detach()).abs().max()) / (2 * n) < 5e-6


@pytest.mark.parametrize("n", SIZES)
def test_hessian_vector_product(n):
    """The backward calls the Functions' own apply, so it differentiates
    again: the Parseval loss's Hessian is 2 n I."""
    x, v = _arrays(n + 13, (1, n), (1, n))
    xt, vt = _t(x, True), _t(v)
    (g,) = torch.autograd.grad(_power(*gt.fft_device(xt), torch), xt, create_graph=True)
    (hv,) = torch.autograd.grad((g * vt).sum(), xt)
    assert float((hv - 2 * n * vt).abs().max()) / (2 * n * float(vt.abs().max())) < 5e-6


@pytest.mark.parametrize("n", SIZES)
def test_forward_mode(n):
    """torch.func.jvp and forward_ad on the Parseval loss: the loss is a
    homogeneous quadratic, so its derivative along x is twice the loss."""
    (x,) = _arrays(n + 17, (1, n))

    def loss(v):
        return _power(*gt.fft_device(v), torch)

    out, tan = torch.func.jvp(loss, (_t(x),), (_t(x),))
    assert abs(float(tan) / float(out) - 2.0) < 1e-4
    with forward_ad.dual_level():
        dual = loss(forward_ad.make_dual(_t(x), _t(x)))
        assert abs(float(forward_ad.unpack_dual(dual).tangent) / float(dual) - 2.0) < 1e-4


def _dot_test(fn, ins, outs, seed, tol=1e-4):
    v = _arrays(seed, *ins)
    w = _arrays(seed + 1, *outs)
    vt = [_t(a, True) for a in v]
    out = fn(*vt)
    out = out if isinstance(out, tuple) else (out,)
    lhs = sum(float(np.vdot(o.detach().numpy().astype(np.float64), ww.astype(np.float64)))
              for o, ww in zip(out, w))
    back = torch.autograd.grad(out, vt, grad_outputs=[_t(a) for a in w])
    rhs = sum(float(np.vdot(b.numpy().astype(np.float64), vv.astype(np.float64)))
              for b, vv in zip(back, v))
    assert abs(lhs - rhs) / max(1.0, abs(lhs)) < tol, (lhs, rhs)


@pytest.mark.parametrize("n", SIZES)
def test_dot_tests(n):
    _dot_test(lambda a: gt.fft_device(a), [(2, n)], [(2, n), (2, n)], n)
    _dot_test(lambda a: gt.fft_device(a), [(1, n)], [(1, n), (1, n)], n + 1)
    for sign in (-1, 1):
        _dot_test(lambda a, b: tlarge.transform_any(a, b, n, sign), [(1, n), (1, n)],
                  [(1, n), (1, n)], n + sign)
    _dot_test(lambda a, b: tlarge.inverse_real(a, b, n), [(1, n), (1, n)], [(1, n)], n + 5)


def test_dot_test_through_the_staged_fold():
    n = 1 << 18
    _dot_test(lambda a, b: tlarge.inverse_real(a, b, n), [(1, n), (1, n)], [(1, n)], 3)


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("n,kernel,function", [
    (1024, "whole_transform_packed", "_WholeTransformBackward"),
    (4096, "whole_transform", "_WholeTransformBackward"),
    (1 << 17, "stage_a", "_StagedTransformBackward"),
])
@pytest.mark.parametrize("cplx", [False, True])
def test_band_output_carries_the_function_and_backward_runs_the_kernel(n, kernel, function, cplx):
    """Each band's output has the port's Function as its grad_fn, and a grad
    runs the band's kernel twice, forward and backward (on the CPU its plain
    version: the card launches the kernel there).  A staged grad also runs
    K4 (``stage_b``) on each complex stage B: the backward's, and for
    complex input the forward's."""
    a, b = _arrays(n, (1, n), (1, n))
    ins = [_t(a, True), _t(b, True)] if cplx else [_t(a, True)]
    K.reset_counts()
    yr, yi = tlarge.transform_any(ins[0], ins[1] if cplx else None, n, -1)
    assert type(yr.grad_fn).__name__ == type(yi.grad_fn).__name__ == function
    torch.autograd.grad(_power(yr, yi, torch), ins)
    assert K.COUNTS[kernel].plain_calls == 2 and K.COUNTS[kernel].launches == 0
    k4 = (2 if cplx else 1) if kernel == "stage_a" else 0
    assert K.COUNTS["stage_b"].plain_calls == k4
    assert sum(c.plain_calls for c in K.COUNTS.values()) == 2 + k4


def test_staged_fold_carries_its_function():
    n = 1 << 18
    a, b = _arrays(n, (1, n), (1, n))
    at, bt = _t(a, True), _t(b, True)
    K.reset_counts()
    y = tlarge.inverse_real(at, bt, n)
    assert "_StageAFoldBackward" in _graph_nodes(y)
    torch.autograd.grad(y.sum(), (at, bt))
    # Forward only: the fold's backward is the torch transpose, not K3.
    assert K.COUNTS["stage_a"].plain_calls == 1


@pytest.mark.parametrize("n", [1024, 4096, 1 << 17])
def test_stride0_and_absent_cotangents(n):
    """``y.sum()`` hands back an expanded (stride-0) cotangent; a loss of
    one output leaves the other's cotangent absent (None, not zeros)."""
    (x,) = _arrays(n + 19, (1, n))
    xt = _t(x, True)
    yr, yi = gt.fft_device(xt)
    (g_sum,) = torch.autograd.grad(yr.sum() + yi.sum(), xt)
    ones = torch.ones(1, n)
    yr, yi = gt.fft_device(xt)
    (g_ref,) = torch.autograd.grad((yr, yi), xt, grad_outputs=(ones, ones))
    assert torch.equal(g_sum, g_ref)
    for part in (0, 1):
        out = gt.fft_device(xt)
        (g_one,) = torch.autograd.grad((out[part] ** 2).sum(), xt)
        out = gt.fft_device(xt)
        zero = torch.zeros(1, n)
        cots = (2 * out[0].detach(), zero) if part == 0 else (zero, 2 * out[1].detach())
        (g_zero,) = torch.autograd.grad(out, xt, grad_outputs=cots)
        _close([g_one.numpy()], [g_zero.numpy()], rtol=1e-6)


def _stage_a_inputs(n1, n2, ct, seed):
    rng = np.random.default_rng(seed)
    plan = P.on_device(P.get_stage_a_plan, n1 * n2, 1, ct, device="cpu")
    assert (plan["n1"], plan["n2"]) == (n1, n2)
    xr, xi = (torch.from_numpy(rng.standard_normal((2, n1, n2)).astype(np.float32)) for _ in "ri")
    return plan, xr, xi


@pytest.mark.parametrize("n,ct,rows,tiles", [
    (1 << 17, 512, None, None), (1 << 17, 512, None, 1), (1 << 17, 256, 72, 3), (1 << 18, 512, 16, 3),
])
@pytest.mark.parametrize("real", [False, True])
def test_stage_a_torch_transpose_is_the_vjp(n, ct, rows, tiles, real):
    """The written-out transpose against torch.func.vjp of the plain stage A
    (``kernels/fused.py:stage_a_plain``), rows and column tiles dropped."""
    plan0 = P.get_stage_a_plan(n, 1, ct)
    n1, n2 = plan0["n1"], plan0["n2"]
    plan, xr, xi = _stage_a_inputs(n1, n2, ct, n + (rows or 0))

    def sa(a, b):
        return K.stage_a_plain(a, None if real else b, n1, n2, plan, ct, col_tiles=tiles, rows=rows)

    out, vjp = torch.func.vjp(sa, xr, xi)
    gr, gi = (torch.randn_like(o) for o in out)
    want_r, want_i = vjp((gr, gi))
    got_r, got_i = stage_a_torch_transpose(gr, gi, plan)
    _close([got_r.numpy()], [want_r.numpy()])
    if not real:
        _close([got_i.numpy()], [want_i.numpy()])


@pytest.mark.parametrize("n", [1024, 1 << 17])
def test_functorch_transforms_and_untracked_calls(n):
    """torch.func.grad / vjp reach the Functions; a call no autodiff mode
    sees runs the kernel body straight (no Function, the same numbers)."""
    (x,) = _arrays(n + 23, (1, n))
    xt = _t(x, True)
    (want,) = torch.autograd.grad(_power(*gt.fft_device(xt), torch), xt)
    got = torch.func.grad(lambda v: _power(*gt.fft_device(v), torch))(_t(x))
    _close([got.numpy()], [want.numpy()], rtol=1e-6)
    out, vjp = torch.func.vjp(gt.fft_device, _t(x))
    (g,) = vjp(tuple(2 * o for o in out))
    _close([g.numpy()], [want.numpy()], rtol=1e-6)
    plain = gt.fft_device(_t(x))
    tracked = gt.fft_device(xt)
    assert plain[0].grad_fn is None and tracked[0].grad_fn is not None
    with torch.no_grad():
        assert gt.fft_device(xt)[0].grad_fn is None
    assert torch.equal(plain[0], tracked[0].detach()) and torch.equal(plain[1], tracked[1].detach())
