"""Kernels of the PyTorch port on a CUDA card, against their plain versions.

Marked ``cuda``: they skip where no card is present and run on one with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest loads jax, which the port's
machine need not have).  This file imports no jax.

Gate: max |kernel - plain| <= 1e-5 * max |plain| (both fp32, TF32 off).
"""

import numpy as np
import pytest
import torch

import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.ablation as A
import gpu_fft_tpu_torch.kernels.engines as E
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.kernels.probes as Pr
import gpu_fft_tpu_torch.plan as P
from gpu_fft_tpu_torch.config import apply_precision
from gpu_fft_tpu_torch.scripts.ablate_large import make_plan as legacy_plan
from gpu_fft_tpu_torch.utils.profiling import chained_step_stats
from gpu_fft_tpu_torch.utils.roofline import compiled_stats

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision()
    return torch.device("cuda")


def _close(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    assert err <= RTOL * scale, f"max|d| {err:.3e} > {RTOL} * {scale:.3e}"


def _signal(kind, b, n, g, dev):
    """(b, n) input: normal noise, a constant (DC), or an impulse at 1."""
    if kind == "randn":
        return torch.randn(b, n, device=dev, generator=g)
    x = torch.ones(b, n, device=dev) if kind == "dc" else torch.zeros(b, n, device=dev)
    if kind == "impulse":
        x[:, 1] = 1.0
    return x


@pytest.mark.parametrize(
    "name,n",
    [("whole_transform", n) for n in (1024, 2048, 4096, 8192, 16384, 32768, 65536)]
    + [("whole_transform_packed", n) for n in (1024, 2048, 4096, 8192, 16384)],
)
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
def test_whole_kernel(dev, name, n, b, complex_, signal):
    """Against the plain version (1e-5) and numpy in float64 (5 log2(n) eps)."""
    make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
    sign, scale = (1, 1.0 / n) if complex_ else (-1, None)
    plan = P.on_device(make_plan, n, sign, scale, device=dev)
    g = torch.Generator(device=dev).manual_seed(n + b)
    xr = _signal(signal, b, n, g, dev)
    xi = 0.5 * _signal(signal, b, n, g, dev) if complex_ else None
    K.reset_counts()
    got = getattr(K, name)(xr, xi, plan)
    assert K.COUNTS[name].launches == 1 and K.COUNTS[name].plain_calls == 0
    _close(got, getattr(K, name + "_plain")(xr, xi, plan))
    x = xr.cpu().double().numpy() + (0 if xi is None else 1j * xi.cpu().double().numpy())
    ref = np.fft.ifft(x, axis=-1) if complex_ else np.fft.fft(x, axis=-1)
    err = max(np.abs(got[0].cpu().numpy() - ref.real).max(), np.abs(got[1].cpu().numpy() - ref.imag).max())
    assert err <= 5 * np.log2(n) * np.finfo(np.float32).eps * np.abs(ref).max()


def _stage_a_plan(n, ct, digit, dev):
    """The factored stage-A plan at ``n`` (ct None: the shipped one).  With
    a ``digit``, ``plan._stage_a_n1`` is patched to it as
    ``scripts/calibrate_chip.py`` does, the plan caches cleared before and
    after, and the digit restored."""
    orig = P._stage_a_n1
    if digit:
        P._stage_a_n1 = lambda n, d=digit: d
        P.get_stage_a_plan.cache_clear()
        P.clear_device_cache()
    try:
        ct = P.stage_a_ct_full_range(n) if ct is None else ct
        return P.on_device(P.get_stage_a_plan, n, -1, ct, device=dev)
    finally:
        if digit:
            P._stage_a_n1 = orig
            P.get_stage_a_plan.cache_clear()
            P.clear_device_cache()


# (n, ct or None for the shipped one, n1 forced or None): the shipped plans,
# every ct the L4 lever of ablate_2e20_levers sets at 2^18, and the digit
# calibrate_chip tries there.
STAGE_A_SHAPES = [(1 << 17, None, None), *((1 << 18, ct, None) for ct in (512, 1024, 2048)),
                  (1 << 18, None, 256), (1 << 20, None, None), (1 << 22, None, None)]


@pytest.mark.parametrize("n,ct,digit", STAGE_A_SHAPES)
@pytest.mark.parametrize("kind", ["real_rows", "complex", "complex_col_tiles1"])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
def test_stage_a_kernel(dev, n, ct, digit, kind, signal):
    """Against the plain version (1e-5) and, for the DC and impulse inputs,
    numpy in float64 (5 log2(n) eps)."""
    plan = _stage_a_plan(n, ct, digit, dev)
    n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
    rows = P.stage_a_real_rows(n1) if kind == "real_rows" else None
    tiles = 1 if kind == "complex_col_tiles1" else None
    g = torch.Generator(device=dev).manual_seed(1)
    xr = _signal(signal, 2, n, g, dev).reshape(2, n1, n2)
    xi = 0.5 * _signal(signal, 2, n, g, dev).reshape(2, n1, n2) if kind != "real_rows" else None
    K.reset_counts()
    got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows)
    assert K.COUNTS["stage_a"].launches == 1 and K.COUNTS["stage_a"].plain_calls == 0
    _close(got, K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows))
    if signal == "randn":
        return
    r, ncols = got[0].shape[1:]
    x = xr.cpu().double().numpy() + (0 if xi is None else 1j * xi.cpu().double().numpy())
    k1c = np.arange(r)[:, None] * np.arange(ncols)[None, :] % n
    ref = np.fft.fft(x, axis=1)[:, :r, :ncols] * np.exp(-2j * np.pi * k1c / n)
    err = max(np.abs(got[0].cpu().numpy() - ref.real).max(), np.abs(got[1].cpu().numpy() - ref.imag).max())
    assert err <= 5 * np.log2(n) * np.finfo(np.float32).eps * np.abs(ref).max()


@pytest.mark.parametrize("n", [1 << 18, 1 << 20, 1 << 22, 1 << 24])
@pytest.mark.parametrize("ct", [512, 1024, 2048])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
def test_stage_a_kernel_irfft_col_tiles(dev, n, ct, signal):
    """K3 as the staged real-output inverse runs it: complex input, sign +1,
    all rows, the first ceil((n2/2 + 1) / ct) column tiles (ct = 512 the
    path's; n1 = 256 at 2^24).  Against the plain version (1e-5) and, for
    the DC and impulse inputs, numpy in float64 (5 log2(n) eps)."""
    plan = P.on_device(P.get_stage_a_plan, n, 1, ct, device=dev)
    n1, n2 = plan["n1"], plan["n2"]
    tiles = -(-(n2 // 2 + 1) // ct)  # all of them at 2^18 for ct >= 1,024
    assert tiles * ct > n2 // 2
    g = torch.Generator(device=dev).manual_seed(2)
    xr = _signal(signal, 1, n, g, dev).reshape(1, n1, n2)
    xi = 0.5 * _signal(signal, 1, n, g, dev).reshape(1, n1, n2)
    K.reset_counts()
    got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles)
    assert K.COUNTS["stage_a"].launches == 1 and got[0].shape == (1, n1, tiles * ct)
    _close(got, K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles))
    if signal == "randn":
        return
    ncols = tiles * ct
    x = xr[:, :, :ncols].cpu().double().numpy() + 1j * xi[:, :, :ncols].cpu().double().numpy()
    k1c = np.arange(n1)[:, None] * np.arange(ncols)[None, :] % n
    ref = np.fft.ifft(x, axis=1) * n1 * np.exp(2j * np.pi * k1c / n)
    err = max(np.abs(got[0].cpu().numpy() - ref.real).max(), np.abs(got[1].cpu().numpy() - ref.imag).max())
    assert err <= 5 * np.log2(n) * np.finfo(np.float32).eps * np.abs(ref).max()


# (b, n) of the real-output path and the kernel it launches there.
IRFFT_CASES = [(1, 256, None), (1, 1024, "whole_transform_packed"), (1, 4096, "whole_transform"),
               (1, 16384, "whole_transform"), (1, 65536, None), (1, 1 << 17, "stage_a"),
               (1, 1 << 18, "stage_a"), (1, 1 << 20, "stage_a"), (1, 1 << 22, "stage_a"),
               (16, 65536, None), (64, 4096, None)]


@pytest.mark.parametrize("b,n,kernel", IRFFT_CASES)
def test_irfft_on_card(dev, b, n, kernel):
    """rfft_device against numpy's rfft, irfft_device against numpy's irfft
    (float64) and torch.fft.irfft, within 5 log2(n) eps, and the kernel the
    dispatch sends the inverse to (or none)."""
    rng = np.random.default_rng(n + b)
    x = rng.standard_normal((b, n)).astype(np.float32)
    gate = 5 * np.log2(n) * np.finfo(np.float32).eps
    fr, fi = gt.rfft_device(torch.from_numpy(x).to(dev))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = max(np.abs(fr.cpu().numpy() - ref.real).max(), np.abs(fi.cpu().numpy() - ref.imag).max())
    assert err <= gate * np.abs(ref).max()
    sr, si = ref.real.astype(np.float32), ref.imag.astype(np.float32)
    sr_t, si_t = torch.from_numpy(sr).to(dev), torch.from_numpy(si).to(dev)
    K.reset_counts()
    y = gt.irfft_device(sr_t, si_t)
    ran = {k for k, c in K.COUNTS.items() if c.launches}
    assert ran == ({kernel} if kernel else set()) and all(c.plain_calls == 0 for c in K.COUNTS.values())
    want = np.fft.irfft(sr.astype(np.float64) + 1j * si.astype(np.float64), n=n, axis=-1)
    peak = np.abs(want).max()
    assert np.abs(y.cpu().numpy() - want).max() <= gate * peak
    vref = torch.fft.irfft(torch.complex(sr_t, si_t), n=n, dim=-1)
    assert float((y - vref).abs().max()) <= gate * peak
    if b == 1:
        yh = gt.irfft(sr[0], si[0], device="cuda")
        assert np.abs(yh - want[0]).max() <= gate * peak


@pytest.mark.parametrize(
    "n,n1,complex_,tiles,rows",
    [(1 << 17, 16, False, None, None), (1 << 17, 16, True, None, 16),
     (1 << 17, 128, False, None, 72), (1 << 17, 128, True, 1, None),
     (1 << 20, 128, False, None, None), (1 << 20, 256, True, 2, 136),
     (1 << 22, 128, False, None, 72)],
)
def test_stage_a_legacy_kernel(dev, n, n1, complex_, tiles, rows):
    """Against the plain version (1e-5) and numpy in float64: the exact
    column DFT times the exact twiddle, within 5 log2(n1) eps of its peak."""
    plan = P.on_device(legacy_plan, n, n1, -1, device=dev)
    n2 = plan["n2"]
    ct = P.stage_a_col_tile(n1, n2)
    g = torch.Generator(device=dev).manual_seed(n1)
    xr = torch.randn(1, n1, n2, device=dev, generator=g)
    xi = torch.randn(1, n1, n2, device=dev, generator=g) if complex_ else None
    K.reset_counts()
    got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows)
    assert K.COUNTS["stage_a_legacy"].launches == 1 and K.COUNTS["stage_a"].launches == 0
    _close(got, K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows))
    r, ncols = got[0].shape[1:]
    x = xr[0, :, :ncols].cpu().double().numpy()
    if complex_:
        x = x + 1j * xi[0, :, :ncols].cpu().double().numpy()
    k1c = np.arange(r)[:, None] * np.arange(ncols)[None, :] % n
    ref = np.fft.fft(x, axis=0)[:r] * np.exp(-2j * np.pi * k1c / n)
    err = max(np.abs(got[0][0].cpu().numpy() - ref.real).max(), np.abs(got[1][0].cpu().numpy() - ref.imag).max())
    assert err <= 5 * np.log2(n1) * np.finfo(np.float32).eps * np.abs(ref).max()


@pytest.mark.parametrize("n,n1", [(1 << 17, 128), (1 << 20, 128), (1 << 20, 256), (1 << 17, 32), (1 << 13, 128)])
def test_stage_a_manual_kernel(dev, n, n1):
    """Every column tile the rule considers (the shipped one first), against
    the plain version; 2^13 at n1 = 128 is the narrowest tile, n2 = 64."""
    plan = A.manual_tables(P.on_device(legacy_plan, n, n1, -1, device=dev))
    x = torch.randn(n1, plan["n2"], device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    want = A.stage_a_manual_plain(x, plan)
    A.reset_counts()
    _close(A.stage_a_manual(x, plan), want)
    assert A.COUNTS["stage_a_manual"].launches == 1
    for bn in A.manual_launch_shapes(n1, plan["n2"]):
        _close(A.manual_launch(x, plan, bn), want)


def test_stage_a_manual_needs_its_stacked_table(dev):
    plan = P.on_device(legacy_plan, 1 << 17, 128, -1, device=dev)
    A.reset_counts()
    with pytest.raises(ValueError, match="f_stack"):
        A.stage_a_manual(torch.zeros(128, plan["n2"], device=dev), plan)
    assert A.COUNTS["stage_a_manual"].launches == 0


_DOT_SHAPES = [(1, 128, 8192), (1, 32, 256), (2, 64, 512), (1, 256, 8192), (3, 128, 1024),
               (1, 64, 64), (2, 96, 192), (1, 384, 128)]


@pytest.mark.parametrize(
    "variant,b,n1,n2",
    [(v, *s) for s in _DOT_SHAPES for v in A.VARIANTS]
    + [("bf16_x1", 1, 640, 128), ("bf16_x1", 1, 1472, 64), ("f32_highest", 1, 1472, 64)],
)
def test_stage_a_dot_kernel(dev, variant, b, n1, n2):
    """Against the plain version (1e-5) and numpy in float64: f32 and
    bf16_x6 within 5 log2(n1) eps, bf16_x1 between 1e-4 and 1e-2 (about
    three digits), as the CPU ladder test holds the plain versions.  The
    shapes reach every launch shape the rule picks: the harness's, n1 = 256
    (x6's F parts on 64 rows a block), a batch of 3, the narrowest tile
    (n2 = 64), a last depth chunk of 32 (n1 = 96), x6's largest n1 (384),
    x1 on 128 rows a block (n1 = 640) and x1's largest n1 (1,472)."""
    g = torch.Generator(device=dev).manual_seed(n1 + n2)
    fr = torch.randn(n1, n1, device=dev, generator=g) / n1
    fi = torch.randn(n1, n1, device=dev, generator=g) / n1
    x = torch.randn(b, n1, n2, device=dev, generator=g)
    tables = A.dot_tables(fr, fi)
    A.reset_counts()
    got = A.stage_a_dot(x, tables, variant)
    assert A.COUNTS[f"stage_a_dot_{variant}"].launches == 1
    _close(got, A.stage_a_dot_plain(x, tables, variant))
    xd = x.cpu().double().numpy()
    ref = [np.einsum("mk,bkn->bmn", f.cpu().double().numpy(), xd) for f in (fr, fi)]
    peak = max(np.abs(r).max() for r in ref)
    err = max(np.abs(g_.cpu().numpy() - r).max() for g_, r in zip(got, ref)) / peak
    if variant == "bf16_x1":
        assert 1e-4 < err < 1e-2, err
    else:
        assert err <= 5 * np.log2(n1) * np.finfo(np.float32).eps, err


@pytest.mark.parametrize("variant", A.VARIANTS)
def test_stage_a_dot_refuses_before_the_launch(dev, variant):
    """A shape outside the kernels' contract raises ValueError and launches
    nothing (n2 = 96 is not a multiple of 64)."""
    tables = A.dot_tables(torch.ones(32, 32, device=dev), torch.ones(32, 32, device=dev))
    A.reset_counts()
    with pytest.raises(ValueError, match="multiple of 64"):
        A.stage_a_dot(torch.ones(1, 32, 96, device=dev), tables, variant)
    assert A.COUNTS[f"stage_a_dot_{variant}"].launches == 0


@pytest.mark.parametrize("n", [2048, 4096, 16384, 32768, 65536])  # n2 = 64, 64, 128, 256, 256
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
def test_fused_fft_lm_kernel(dev, n, b, signal):
    """Against the plain version (1e-5) and numpy in float64 (5 log2(n) eps)."""
    t = P.on_device(E.lm_tables, n, -1, device=dev)
    x = _signal(signal, b, n, torch.Generator(device=dev).manual_seed(n + b), dev)
    E.reset_counts()
    got = E.fused_fft_lm(x, t)
    assert E.COUNTS["fused_fft_lm"].launches == 1 and E.COUNTS["fused_fft_lm"].plain_calls == 0
    _close(got, E.fused_fft_lm_plain(x, t))
    ref = np.fft.fft(x.cpu().double().numpy(), axis=-1)
    gate = 5 * np.log2(n) * np.finfo(np.float32).eps
    err = max(np.abs(got[0].cpu().numpy() - ref.real).max(), np.abs(got[1].cpu().numpy() - ref.imag).max())
    assert err <= gate * np.abs(ref).max()


@pytest.mark.parametrize("k", Pr.PROBE_KS)
def test_operand_probe_kernel(dev, k):
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(8, 128, device=dev, generator=g)
    tables = [torch.randn(128, 128, device=dev, generator=g) for _ in range(k)]
    Pr.reset_counts()
    got = Pr.operand_probe(x, tables)
    assert Pr.COUNTS["operand_probe"].launches == 1
    assert torch.equal(got, Pr.operand_probe_plain(x, tables))


def test_copy_min_kernel(dev):
    x = torch.randn(8, 128, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    Pr.reset_counts()
    got = Pr.copy_min(x)
    assert Pr.COUNTS["copy_min"].launches == 1
    assert torch.equal(got, Pr.copy_min_plain(x))


def test_compiled_stats_counts_the_own_kernels(dev):
    plan = P.on_device(P.get_whole_plan, 4096, -1, None, device=dev)
    stats = compiled_stats(lambda z: K.whole_transform(z, None, plan)[0] * 0.5, torch.ones(1, 4096, device=dev))
    assert stats["n_kernels"] == 2 and stats["own_kernels"] == {"whole_transform": 1}, stats
    assert len(stats["kernel_names"]) == 1 and "whole_kernel" not in stats["kernel_names"][0]


def test_chained_step_stats_times_a_graph(dev):
    plan = A.manual_tables(P.on_device(legacy_plan, 1 << 17, 128, -1, device=dev))
    x = torch.randn(128, plan["n2"], device=dev)
    A.reset_counts()
    st = chained_step_stats(lambda z: A.stage_a_manual(z, plan)[0], x, k1=2, k2=12, reps=2,
                            min_span_s=0.002)
    assert st.median_s > 0 and st.span >= 10
    assert A.COUNTS["stage_a_manual"].launches >= 14  # warm-up + captures


@pytest.mark.parametrize("n", [1024, 4096, 1 << 17])
def test_roundtrip_on_card(dev, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    re, im = gt.fft(x, device="cuda")
    ref = np.fft.fft(x.astype(np.float64))
    gate = 5 * np.log2(n) * np.finfo(np.float32).eps
    assert max(np.abs(re - ref.real).max(), np.abs(im - ref.imag).max()) <= gate * np.abs(ref).max()
    assert np.abs(gt.ifft(re, im, device="cuda")[:n] - x).max() <= gate * np.abs(x).max()


def test_wrapper_rejects_bad_tables(dev):
    plan = P.on_device(P.get_whole_plan, 4096, -1, None, device=dev)
    x = torch.zeros(1, 4096, device=dev)
    bad = dict(plan, f1r=plan["f1r"].t())  # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.whole_transform(x, None, bad)
    with pytest.raises(ValueError, match="on cpu"):
        K.whole_transform(x, None, P.on_device(P.get_whole_plan, 4096, -1, None, device="cpu"))


# ── Autodiff and the analysis path on the card ───────────────────────────────

GRAD_BANDS = [(1024, "whole_transform_packed"), (4096, "whole_transform"), (1 << 20, "stage_a")]


@pytest.mark.parametrize("n,kernel", GRAD_BANDS)
def test_fft_device_output_carries_a_grad_fn(dev, n, kernel):
    """The kernels fill their outputs through ctypes; behind the autograd
    Functions the result still joins the graph, and the backward launches
    the band's kernel again (no plain version, no CPU)."""
    x = torch.randn(1, n, device=dev, requires_grad=True)
    K.reset_counts()
    yr, yi = gt.fft_device(x)
    assert yr.grad_fn is not None and yi.grad_fn is not None
    (g,) = torch.autograd.grad((yr**2 + yi**2).sum(), x)
    assert K.COUNTS[kernel].launches == 2
    assert all(c.plain_calls == 0 for c in K.COUNTS.values())
    gate = 2 * 5 * np.log2(n) * np.finfo(np.float32).eps
    assert float((g - 2 * n * x).abs().max()) <= gate * 2 * n * float(x.abs().max())


@pytest.mark.parametrize("n,kernel", GRAD_BANDS)
def test_stride0_cotangent_is_accepted(dev, n, kernel):
    x = torch.randn(1, n, device=dev, requires_grad=True)
    yr, yi = gt.fft_device(x)
    K.reset_counts()
    (yr.sum() + yi.sum()).backward()
    assert K.COUNTS[kernel].launches == 1 and x.grad is not None
    # d/dx sum(Re Fx + Im Fx) = Re(F^T 1) + Im(F^T 1) = n e_0 (F^T = F).
    ref = torch.fft.fft(torch.ones(n, dtype=torch.complex64, device=dev))
    want = (ref.real + ref.imag)[None]
    assert float((x.grad - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_staged_fold_gradient_on_card(dev):
    """irfft_device at 2^20: K3 on the fold's tiles forward, the torch
    transpose backward; a dot test in float64."""
    n = 1 << 20
    h = n // 2 + 1
    sr, si = (torch.randn(1, h, device=dev, requires_grad=True) for _ in "ri")
    w = torch.randn(1, n, device=dev)
    K.reset_counts()
    y = gt.irfft_device(sr, si)
    assert K.COUNTS["stage_a"].launches == 1
    gr, gi = torch.autograd.grad(y, (sr, si), grad_outputs=w)
    vr, vi = torch.randn(1, h, device=dev), torch.randn(1, h, device=dev)
    lhs = float((gt.irfft_device(vr, vi).double() * w.double()).sum())
    rhs = float((gr.double() * vr.double()).sum() + (gi.double() * vi.double()).sum())
    assert abs(lhs - rhs) / max(1.0, abs(lhs)) <= 1e-4


def test_welch_and_stft_roundtrip_on_card(dev):
    import scipy.signal

    x = np.random.default_rng(5).standard_normal(1 << 16).astype(np.float32)
    f, p = gt.welch(x, nperseg=1024, device="cuda")
    _, ref = scipy.signal.welch(x.astype(np.float64), nperseg=1024)
    assert np.abs(p - ref).max() <= 1e-4 * np.abs(ref).max()
    r, i = gt.stft_device(torch.from_numpy(x).to(dev), 1024, 256)
    y = gt.istft_device(r, i, 256, length=x.size).cpu().numpy()
    gate = 5 * np.log2(1024) * np.finfo(np.float32).eps * np.abs(x).max()
    assert np.abs(y[1024:-1024] - x[1024:-1024]).max() <= gate


@pytest.mark.parametrize("name,shape", [("welch", (1, 1 << 16)), ("stft_roundtrip", (1, 16384))])
def test_analysis_steps_chain_in_cuda_graphs(dev, name, shape):
    """The analysis steps are capturable: their tables are cached on the
    device by the warm-up call, so a captured step uploads nothing."""
    from gpu_fft_tpu_torch.utils import profiling

    step = profiling.welch_step(256) if name == "welch" else profiling.stft_roundtrip_step(256, 64)
    x = torch.randn(*shape, device=dev)
    st = chained_step_stats(step, x, k1=2, k2=12, reps=2, min_span_s=0.002)
    assert st.median_s > 0
    assert bool(torch.isfinite(step(x)).all())


# ── The filtering path ───────────────────────────────────────────────────────


def _launches():
    return {k: (c.launches, c.plain_calls) for k, c in K.COUNTS.items()}


def test_firstream_step_launches_k1_twice(dev):
    """FIRStream at chunk 4,096 with 257 taps: m = 8,192, one K1 forward and
    one K1 inverse a step, no plain version; the output against scipy's
    lfilter (2e-3 of max(1, max|ref|))."""
    import scipy.signal

    h = gt.firwin(257, 0.3).astype(np.float32)
    stream = gt.FIRStream(h, chunk=4096, device="cuda")
    x = np.random.default_rng(1).standard_normal(3 * 4096).astype(np.float32)
    st, outs = stream.init(), []
    for i in range(3):
        K.reset_counts()
        st, y = stream.step(st, torch.from_numpy(x[i * 4096:(i + 1) * 4096]).to(dev))
        got = _launches()
        assert got["whole_transform"] == (2, 0) and got["stage_a"] == (0, 0), got
        outs.append(y.cpu().numpy())
    ref = scipy.signal.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))
    assert np.abs(np.concatenate(outs) - ref).max() <= 2e-3 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("call,want", [
    ("fft_convolve_device 2^20 * 4097", {"stage_a": 3}),
    ("hilbert_device 2^20", {"stage_a": 2}),
    ("dct_device 2^20", {"stage_a": 1}),
    ("idct_device 2^20", {"stage_a": 1}),
    ("czt_device 2^16", {"stage_a": 2}),
    ("czt_device 1000", {"whole_transform": 2}),
    ("fht_device 2^20", {"stage_a": 2}),
    ("oaconvolve_device (8, 2^20) * 1025", {"whole_transform": 1}),
])
def test_filtering_calls_launch_the_expected_kernels(dev, call, want):
    """The K1/K2/K3 launches of each call where the dispatch sends it, and no
    plain version on the card."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1 << 20
    fns = {
        "fft_convolve_device 2^20 * 4097": lambda: gt.fft_convolve_device(
            torch.randn(1, n, device=dev, generator=g), torch.randn(1, 4097, device=dev, generator=g)),
        "hilbert_device 2^20": lambda: gt.hilbert_device(torch.randn(n, device=dev, generator=g)),
        "dct_device 2^20": lambda: gt.dct_device(torch.randn(1, n, device=dev, generator=g), 2, "ortho"),
        "idct_device 2^20": lambda: gt.idct_device(torch.randn(1, n, device=dev, generator=g), 2, "ortho"),
        "czt_device 2^16": lambda: gt.czt_device(torch.randn(1 << 16, device=dev, generator=g)),
        "czt_device 1000": lambda: gt.czt_device(torch.randn(1000, device=dev, generator=g)),
        "fht_device 2^20": lambda: gt.fht_device(torch.randn(n, device=dev, generator=g), 12.8 / n, 0.5),
        "oaconvolve_device (8, 2^20) * 1025": lambda: gt.oaconvolve_device(
            torch.randn(8, n, device=dev, generator=g), torch.from_numpy(gt.firwin(1025, 0.2).astype(np.float32)).to(dev)),
    }
    fns[call]()  # plans and tables made on the first call
    torch.cuda.synchronize()
    K.reset_counts()
    fns[call]()
    torch.cuda.synchronize()
    got = _launches()
    assert all(p == 0 for _, p in got.values()), got
    assert {k: v[0] for k, v in got.items() if v[0]} == want, got


def test_lfilter_state_products_run_without_tf32(dev):
    """lfilter_device pins TF32 off before its state products (a TF32
    product leaves ~1e-3 state error) and meets test_iir.py's 2e-4 gate at
    (4, 2^16) with a Butterworth order 4."""
    import scipy.signal

    b, a = scipy.signal.butter(4, 0.2)
    x = np.random.default_rng(2).standard_normal((4, 1 << 16)).astype(np.float32)
    zi = np.tile(scipy.signal.lfilter_zi(b, a), (4, 1)) * x[:, :1]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y, zf = gt.lfilter_device(b, a, torch.from_numpy(x).to(dev), zi=torch.from_numpy(zi.astype(np.float32)).to(dev))
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        apply_precision()
    ry, rzf = scipy.signal.lfilter(b, a, x.astype(np.float64), zi=zi)
    assert np.abs(y.cpu().numpy() - ry).max() <= 2e-4 * max(1.0, np.abs(ry).max())
    assert np.abs(zf.cpu().numpy() - rzf).max() <= 2e-4 * max(1.0, np.abs(rzf).max())


@pytest.mark.parametrize("name,shape", [("dct_roundtrip", (4, 4096)), ("hilbert", (1, 1 << 16)),
                                        ("oaconvolve", (2, 1 << 16)), ("firstream", (1, 256 + 4096)),
                                        ("resample", (1, 1 << 16)), ("lfilter", (2, 8192))])
def test_filtering_steps_chain_in_cuda_graphs(dev, name, shape):
    """The six filtering steps are capturable (tables cached by the warm-up
    call) and stay finite along the chain."""
    import scipy.signal

    from gpu_fft_tpu_torch.utils import profiling

    step = {
        "dct_roundtrip": profiling.dct_roundtrip_step,
        "hilbert": profiling.hilbert_step,
        "oaconvolve": lambda: profiling.oaconvolve_step(shape[1], gt.firwin(257, 0.3)),
        "firstream": lambda: profiling.firstream_step(4096, 257),
        "resample": lambda: profiling.resample_step(shape[1], shape[1] // 2),
        "lfilter": lambda: profiling.lfilter_step(*scipy.signal.butter(4, 0.2)),
    }[name]()
    x = torch.randn(*shape, device=dev)
    st = chained_step_stats(step, x, k1=2, k2=12, reps=2, min_span_s=0.002)
    assert st.median_s > 0
    assert bool(torch.isfinite(step(x)).all())
