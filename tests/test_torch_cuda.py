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


WHOLE_SIZES = [("whole_transform", n) for n in (1024, 2048, 4096, 8192, 16384, 32768, 65536)] + [
    ("whole_transform_packed", n) for n in (1024, 2048, 4096, 8192, 16384)
]


# B = 1, 2, 3 at every size; B = 16 and 194 (a whole-band batch, Welch's
# 194 segments) at 1,024, 16,384 and 65,536.
@pytest.mark.parametrize(
    "name,n,b",
    [(name, n, b) for name, n in WHOLE_SIZES for b in (1, 2, 3)]
    + [(name, n, b) for name, n in WHOLE_SIZES if n in (1024, 16384, 65536) for b in (16, 194)],
)
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
               (16, 65536, None), (64, 4096, "whole_transform")]


@pytest.mark.parametrize("b,n,kernel", IRFFT_CASES)
def test_irfft_on_card(dev, b, n, kernel):
    """rfft_device against numpy's rfft, irfft_device against numpy's irfft
    (float64) and torch.fft.irfft, within 5 log2(n) eps, and the kernel the
    dispatch sends the inverse to (or none); a staged size below the staged
    fold's gate runs the complex inverse, K3 and then K4."""
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
    k4 = {"stage_b"} if n > 65536 and not P.irfft_half_staged_applies(n) else set()
    assert ran == ({kernel} | k4 if kernel else set()) and all(c.plain_calls == 0 for c in K.COUNTS.values())
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


# K4 at every n2 of the staged path: n = 2^17 ... 2^23 (n1 = 128) and 2^24
# (n1 = 256), at B = 1, 3 and 64 where B n <= 2^26.
STAGE_B_CASES = [(b, n) for n in (1 << e for e in range(17, 25)) for b in (1, 3, 64) if b * n <= 1 << 26]


@pytest.mark.parametrize("b,n", STAGE_B_CASES)
@pytest.mark.parametrize("sign,scaled", [(-1, False), (1, False), (1, True)])
def test_stage_b_kernel(dev, b, n, sign, scaled):
    """K4 on stage A's (B, n1, n2) layout: one launch, no plain call; against
    its plain version (the torch ``stage_b`` times the scale, 1e-5) and each
    row's DFT in float64 stored at k1 + n1 k2 (5 log2(n) eps of max|ref|)."""
    plan = P.on_device(P.get_stage_a_plan, n, sign, None, device=dev)
    n1, n2, t = plan["n1"], plan["n2"], plan["stage_b"]
    tw = P.on_device(P.get_stage_b_twiddle, n2, sign, device=dev)
    g = torch.Generator(device=dev).manual_seed(n + b)
    yr, yi = (torch.randn(b, n1, n2, device=dev, generator=g) for _ in "ri")
    scale = 1.0 / n if scaled else None
    K.reset_counts()
    got = K.stage_b_kernel(yr, yi, n1, n2, t, tw, scale)
    torch.cuda.synchronize()
    assert (K.COUNTS["stage_b"].launches, K.COUNTS["stage_b"].plain_calls) == (1, 0)
    _close(got, K.stage_b_kernel_plain(yr, yi, n1, n2, t, tw, scale))
    z = torch.complex(yr.double(), yi.double())
    ref = (torch.fft.fft(z) if sign < 0 else torch.fft.ifft(z) * n2) * (scale or 1.0)
    ref = ref.transpose(1, 2).reshape(b, n)
    err = max(float((got[0] - ref.real).abs().max()), float((got[1] - ref.imag).abs().max()))
    assert err <= 5 * np.log2(n) * np.finfo(np.float32).eps * float(ref.abs().max())


@pytest.mark.parametrize("b,n", [(1, 1 << 17), (2, 1 << 20), (1, 1 << 24)])
def test_staged_complex_call_runs_k4_once_with_the_scale_in_its_store(dev, b, n):
    """A complex staged transform under "full": K3 then K4, one launch each;
    with ``scale`` = 1/n (a power of two) the result is the unscaled one
    times 1/n bit for bit; against torch.fft.ifft (5 log2(n) eps)."""
    from gpu_fft_tpu_torch.kernels.large import transform_any

    g = torch.Generator(device=dev).manual_seed(b + n)
    xr, xi = (torch.randn(b, n, device=dev, generator=g) for _ in "ri")
    transform_any(xr, xi, n, 1, scale=1.0 / n)
    torch.cuda.synchronize()
    K.reset_counts()
    sr, si = transform_any(xr, xi, n, 1, scale=1.0 / n)
    torch.cuda.synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in K.COUNTS.items() if c.launches or c.plain_calls}
    assert got == {"stage_a": (1, 0), "stage_b": (1, 0)}, got
    ur, ui = transform_any(xr, xi, n, 1)
    assert torch.equal(sr, ur * (1.0 / n)) and torch.equal(si, ui * (1.0 / n))
    ref = torch.fft.ifft(torch.complex(xr, xi).to(torch.complex128))
    err = max(float((sr - ref.real).abs().max()), float((si - ref.imag).abs().max()))
    assert err <= 5 * np.log2(n) * np.finfo(np.float32).eps * float(ref.abs().max())


def test_ifft_device_gradcheck_runs_k4_in_the_backward(dev):
    """``gradcheck`` (fast mode: one random projection each way) of
    ``ifft_device`` at 2^17: the map is linear, so a unit step is exact but
    for fp32 rounding; its backward runs the staged body again, K4 included."""
    g = torch.Generator(device=dev).manual_seed(17)
    xr, xi = (torch.randn(1, 1 << 17, device=dev, generator=g).requires_grad_() for _ in "ri")
    K.reset_counts()
    assert torch.autograd.gradcheck(lambda a, b: gt.ifft_device(a, b), (xr, xi), eps=1.0, atol=1e-5, rtol=1e-3,
                                    fast_mode=True)
    assert K.COUNTS["stage_b"].launches >= 3 and K.COUNTS["stage_b"].plain_calls == 0
    K.reset_counts()
    yr, yi = gt.ifft_device(xr, xi)
    torch.autograd.grad((yr * yr + yi * yi).sum(), (xr, xi))
    assert K.COUNTS["stage_b"].launches == 2  # forward and backward


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
    ("hilbert_device 2^20", {"stage_a": 2, "stage_b": 1}),
    ("dct_device 2^20", {"stage_a": 1}),
    ("idct_device 2^20", {"stage_a": 1}),
    ("czt_device 2^16", {"stage_a": 2, "stage_b": 2}),
    ("czt_device 1000", {"whole_transform": 2}),
    ("fht_device 2^20", {"stage_a": 2}),
    # the taps' spectrum, then the blocks forward and back, each K1 at B > 1
    ("oaconvolve_device (8, 2^20) * 1025", {"whole_transform": 3}),
])
def test_filtering_calls_launch_the_expected_kernels(dev, call, want):
    """The K1/K2/K3 launches of each call where the dispatch sends it (K4 on
    each complex staged transform), and no plain version on the card."""
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


# ── The 2-D / N-D path ───────────────────────────────────────────────────────


@pytest.mark.parametrize("call,want", [
    ("fft2_device (4, 2^17)", {"stage_a": 1}),
    ("ifft2_device (4, 2^17)", {"stage_a": 1, "stage_b": 1}),
    ("rfft2_device (4, 2^17)", {"stage_a": 1}),
    ("fft2_device (256, 256)", {}),
    ("fftn_device 1-D 1024", {"whole_transform_packed": 1}),
    ("fftn_device 1-D 4096", {"whole_transform": 1}),
    ("fft_convolve2d_device 256^2 * 9^2", {}),
])
def test_2d_calls_launch_the_expected_kernels(dev, call, want):
    """K3 on rows longer than 65,536 at B > 1, K2 / K1 on a 1-D fftn in the
    band, the torch engines elsewhere; no plain version on the card; each
    output against torch.fft (5 * log2(N) * eps of max|ref|)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, 1 << 17, device=dev, generator=g)
    sq = torch.randn(256, 256, device=dev, generator=g)
    k = torch.randn(9, 9, device=dev, generator=g)
    v1, v4 = torch.randn(1024, device=dev, generator=g), torch.randn(4096, device=dev, generator=g)
    zx = torch.fft.fft2(x)
    fns = {
        "fft2_device (4, 2^17)": (lambda: gt.fft2_device(x), lambda: zx, x.numel()),
        "ifft2_device (4, 2^17)": (lambda: gt.ifft2_device(zx.real.contiguous(), zx.imag.contiguous()),
                                   lambda: torch.fft.ifft2(zx), x.numel()),
        "rfft2_device (4, 2^17)": (lambda: gt.rfft2_device(x), lambda: torch.fft.rfft2(x), x.numel()),
        "fft2_device (256, 256)": (lambda: gt.fft2_device(sq), lambda: torch.fft.fft2(sq), sq.numel()),
        "fftn_device 1-D 1024": (lambda: gt.fftn_device(v1), lambda: torch.fft.fft(v1), 1024),
        "fftn_device 1-D 4096": (lambda: gt.fftn_device(v4), lambda: torch.fft.fft(v4), 4096),
        "fft_convolve2d_device 256^2 * 9^2": (
            lambda: (gt.fft_convolve2d_device(sq, k),),
            lambda: torch.fft.irfft2(torch.fft.rfft2(sq, s=(512, 512)) * torch.fft.rfft2(k, s=(512, 512)),
                                     s=(512, 512))[:264, :264], 512 * 512),
    }
    fn, ref_fn, n = fns[call]
    fn()  # plans and tables made on the first call
    torch.cuda.synchronize()
    K.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _launches()
    assert all(p == 0 for _, p in got.values()), got
    assert {kk: v[0] for kk, v in got.items() if v[0]} == want, got
    ref = ref_fn()
    parts = (ref.real, ref.imag) if ref.is_complex() else (ref,)
    err = max(float((o - r).abs().max()) for o, r in zip(out, parts))
    assert err <= 2 * 5 * np.log2(n) * np.finfo(np.float32).eps * float(ref.abs().max())


def test_fft2_device_grad_on_the_card(dev):
    """The 2-D transform keeps autograd through K3 at B = 4 and matches
    torch.fft's gradient of the same loss."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4, 1 << 17, device=dev, generator=g, requires_grad=True)
    w = torch.randn(4, 1 << 17, device=dev, generator=g)
    yr, yi = gt.fft2_device(x)
    assert yr.grad_fn is not None
    (got,) = torch.autograd.grad((w * yr + w * yi).sum(), x)
    z = torch.fft.fft2(x)
    (want,) = torch.autograd.grad((w * z.real + w * z.imag).sum(), x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_conv2d_step_chains_in_cuda_graphs(dev):
    from gpu_fft_tpu_torch.utils import profiling

    step = profiling.conv2d_step(np.ones((5, 5), np.float32) / 25.0)
    x = torch.randn(2, 128, 128, device=dev)
    st = chained_step_stats(step, x, k1=2, k2=12, reps=2, min_span_s=0.002)
    assert st.median_s > 0
    assert bool(torch.isfinite(step(x)).all())


def test_examples_run_on_the_card(dev):
    import contextlib
    import importlib
    import io

    from gpu_fft_tpu_torch.examples import NAMES

    for name in NAMES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(f"gpu_fft_tpu_torch.examples.{name}").main(device="cuda")
        assert rc == 0 and "FAIL" not in buf.getvalue(), buf.getvalue()


# ── The scipy.fft namespace and the FNO ──────────────────────────────────────


@pytest.mark.parametrize("call,want", [
    ("fft 1024", {"whole_transform_packed": 1}),
    ("fft 4096", {"whole_transform": 1}),
    ("ifft 16384", {"whole_transform": 1}),
    ("fft 2^20", {"stage_a": 1, "stage_b": 1}),
    ("fft 1009", {"whole_transform": 2}),
    ("fft 1000", {}),
    ("rfft 4096", {"whole_transform": 1}),
    ("irfft 2^20", {"stage_a": 1}),
    ("fftn 512^2", {}),
])
def test_compat_calls_launch_the_expected_kernels(dev, call, want):
    """``compat`` on CUDA tensors: a tensor out on the card, the dispatch's
    kernels (K2 / K1 in the band, K1 twice for Bluestein at 1,009, K3
    staged, the mixed four-step at 1,000 and the n = 512 products of a
    512^2 image on torch), no plain version; each output against torch.fft
    (5 * log2(N) * eps of max|ref|; 3e-5 off powers of two)."""
    import gpu_fft_tpu_torch.compat as cf

    name, size = call.split()
    n = {"2^20": 1 << 20, "512^2": 512 * 512}.get(size) or int(size)
    g = torch.Generator(device=dev).manual_seed(6)
    if name == "fftn":
        x = torch.complex(*torch.randn(2, 512, 512, device=dev, generator=g))
        fn, ref_fn = (lambda: cf.fftn(x)), (lambda: torch.fft.fftn(x))
    elif name == "rfft":
        x = torch.randn(n, device=dev, generator=g)
        fn, ref_fn = (lambda: cf.rfft(x)), (lambda: torch.fft.rfft(x))
    elif name == "irfft":
        x = torch.complex(*torch.randn(2, n // 2 + 1, device=dev, generator=g))
        fn, ref_fn = (lambda: cf.irfft(x)), (lambda: torch.fft.irfft(x))
    else:
        x = torch.complex(*torch.randn(2, n, device=dev, generator=g))
        fn, ref_fn = (lambda: getattr(cf, name)(x)), (lambda: getattr(torch.fft, name)(x))
    fn()  # plans and tables made on the first call
    torch.cuda.synchronize()
    K.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _launches()
    assert all(p == 0 for _, p in got.values()), got
    assert {kk: v[0] for kk, v in got.items() if v[0]} == want, got
    assert isinstance(out, torch.Tensor) and out.device.type == "cuda"
    ref = ref_fn()
    tol = 5 * np.log2(n) * np.finfo(np.float32).eps if n & (n - 1) == 0 else 3e-5
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


def test_fno1d_long_record_step_launches_k3_three_times_a_layer(dev):
    """FNO1d (modes 16, width 64, depth 1) at L = 2^18, B = 2: one train
    step runs K3 for the forward rfft, the irfft's staged fold and the
    rfft's backward, K4 in that backward (a complex transform), and no
    plain version."""
    from gpu_fft_tpu_torch.models import FNO1d, make_train_step

    g = torch.Generator(device=dev).manual_seed(7)
    model = FNO1d(modes=16, width=64, depth=1, in_channels=1, device=dev,
                  generator=torch.Generator().manual_seed(7))
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    x = torch.randn(2, 1 << 18, 1, device=dev, generator=g)
    y = torch.randn(2, 1 << 18, 1, device=dev, generator=g)
    step(x, y)
    torch.cuda.synchronize()
    K.reset_counts()
    loss = step(x, y)
    torch.cuda.synchronize()
    got = _launches()
    assert {kk: v[0] for kk, v in got.items() if v[0]} == {"stage_a": 3, "stage_b": 1}, got
    assert all(p == 0 for _, p in got.values()), got
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


# ── The kernel operators, serving and the parallel layer on the card ────────


@pytest.mark.parametrize("name,n", [("whole_transform_packed", 1024), ("whole_transform", 4096),
                                    ("stage_a", 1 << 20), ("stage_b", 1 << 20)])
def test_kernel_operators_on_the_card(dev, name, n):
    """Each ``torch.ops.gpu_fft_tpu_torch`` operator launches its kernel on a
    CUDA tensor (one launch, no plain call) and agrees with its plain
    version; a captured CUDA graph replays it."""
    g = torch.Generator(device=dev).manual_seed(n)
    if name == "stage_b":
        plan = P.on_device(P.get_stage_a_plan, n, 1, None, device=dev)
        n1, n2, t = plan["n1"], plan["n2"], plan["stage_b"]
        tw = P.on_device(P.get_stage_b_twiddle, n2, 1, device=dev)
        yr, yi = (torch.randn(2, n1, n2, device=dev, generator=g) for _ in "ri")
        tables = K.stage_b_tables(t, tw)
        op = lambda: torch.ops.gpu_fft_tpu_torch.stage_b(yr, yi, tables, n1, 1.0 / n)  # noqa: E731
        want = K.stage_b_kernel_plain(yr, yi, n1, n2, t, tw, 1.0 / n)
    elif name == "stage_a":
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2 = plan["n1"], plan["n2"]
        x = torch.randn(1, n1, n2, device=dev, generator=g)
        tables = [plan[k] for k in ("f1r", "f1i", "two_r", "two_i", "twi_r", "twi_i")]
        op = lambda: torch.ops.gpu_fft_tpu_torch.stage_a(x, None, tables, n1, n2, plan["ct"], n1, n2)  # noqa: E731
        want = K.stage_a_plain(x, None, n1, n2, plan, plan["ct"])
    else:
        make = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
        plan = P.on_device(make, n, -1, None, device=dev)
        keys = ("packed",) if name == "whole_transform_packed" else ("f1r", "f1i", "twr", "twi", "f2r", "f2i")
        x = torch.randn(1, n, device=dev, generator=g)
        op = lambda: getattr(torch.ops.gpu_fft_tpu_torch, name)(x, None, [plan[k] for k in keys])  # noqa: E731
        want = getattr(K, name + "_plain")(x, None, plan)
    K.reset_counts()
    got = op()
    torch.cuda.synchronize()
    assert (K.COUNTS[name].launches, K.COUNTS[name].plain_calls) == (1, 0)
    _close(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op()
    graph.replay()
    torch.cuda.synchronize()
    _close(captured, want)


@pytest.mark.parametrize("n,kernel", [(1024, "whole_transform_packed_bf16"), (4096, "whole_transform_bf16"),
                                      (16384, "whole_transform_bf16")])
def test_fast_artifact_runs_its_kernel_on_the_card(dev, n, kernel, tmp_path, monkeypatch):
    """An artifact exported on the card under "fast" records K2F / K1F and
    launches it (with its launch rule's geometry), bit-equal to the live
    fft_device of that mode."""
    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch.utils.serving import exported_call, load_transform, save_transform

    monkeypatch.setattr(config, "PRECISION", "fast")
    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, n, device="cuda")
    art = load_transform(path)
    targets = [str(node.target) for node in art.graph.nodes if node.op == "call_function"]
    assert [t for t in targets if t.startswith("gpu_fft_tpu_torch.")] == [f"gpu_fft_tpu_torch.{kernel}.default"]
    x = np.random.default_rng(n).standard_normal((1, n)).astype(np.float32)
    K.reset_counts()
    yr, yi = exported_call(art, x)
    assert (K.COUNTS[kernel].launches, K.COUNTS[kernel].plain_calls) == (1, 0)
    lr, li = gt.fft_device(torch.from_numpy(x).to(dev))
    np.testing.assert_array_equal(yr, lr.cpu().numpy())
    np.testing.assert_array_equal(yi, li.cpu().numpy())


def test_exported_artifact_runs_on_the_card(dev, tmp_path):
    """export -> save -> load -> call at (1, 4,096) on the card: K1 runs
    inside the artifact, bit-equal to the live fft_device."""
    from gpu_fft_tpu_torch.utils.serving import exported_call, load_transform, save_transform

    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, 4096, device="cuda")
    art = load_transform(path)
    x = np.random.default_rng(3).standard_normal((1, 4096)).astype(np.float32)
    K.reset_counts()
    yr, yi = exported_call(art, x)
    assert (K.COUNTS["whole_transform"].launches, K.COUNTS["whole_transform"].plain_calls) == (1, 0)
    lr, li = gt.fft_device(torch.from_numpy(x).to(dev))
    np.testing.assert_array_equal(yr, lr.cpu().numpy())
    np.testing.assert_array_equal(yi, li.cpu().numpy())


# ── K1F / K2F / K3F, the "fast" kernels (GPU_FFT_TPU_PRECISION=fast) ─────────
#
# Gate: max |kernel - plain| <= 1e-3 * max |plain|.  Both take the same bf16
# operands and accumulate in fp32 in other orders; a one-ulp fp32 difference
# in Z before its bf16 rounding (K1F / K2F) can move one intermediate by a
# bf16 ulp (2^-8).
FAST_RTOL = 1e-3


def _close_fast(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    assert err <= FAST_RTOL * scale, f"max|d| {err:.3e} > {FAST_RTOL} * {scale:.3e}"


@pytest.mark.parametrize(
    "name,n",
    [("whole_transform_bf16", n) for n in (1024, 2048, 4096, 8192, 16384)]
    + [("whole_transform_packed_bf16", n) for n in (1024, 2048, 4096, 8192, 16384)],
)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
def test_whole_bf16_kernel(dev, name, n, b, complex_, signal):
    make = P.get_whole_packed_plan if "packed" in name else P.get_whole_plan
    plan = P.on_device(make, n, 1 if complex_ else -1, 1.0 / n if complex_ else None, device=dev)
    g = torch.Generator(device=dev).manual_seed(n + b)
    xr = _signal(signal, b, n, g, dev)
    xi = _signal(signal, b, n, g, dev) if complex_ else None
    K.reset_counts()
    got = getattr(K, name)(xr, xi, plan)
    assert K.COUNTS[name].launches == 1 and K.COUNTS[name].plain_calls == 0
    _close_fast(got, getattr(K, name + "_plain")(xr, xi, plan))


def _signals(signal, b, n1, n2, g, dev):
    return torch.stack([_signal(signal, n1, n2, g, dev) for _ in range(b)])


@pytest.mark.parametrize("n,ct", [(1 << 17, 512), (1 << 17, 32), (1 << 18, 2048), (1 << 20, 2048), (1 << 20, 512),
                                  (1 << 22, 2048), (1 << 24, 2048)])
@pytest.mark.parametrize("kind", ["real_rows", "complex", "complex_col_tiles"])
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
@pytest.mark.parametrize("b", [1, 3])
def test_stage_a_bf16_kernel(dev, n, ct, kind, signal, b):
    """K3F at B = 1 and 3; ct = 32 keeps 17 column tiles on the irfft fold's
    form (an odd multiple of 32 columns, half a 64-column tile masked);
    2^24 is n1 = 256 (real rows = 136, two row blocks; complex, four)."""
    plan = P.on_device(P.get_stage_a_plan, n, -1 if kind == "real_rows" else 1, ct, device=dev)
    n1, n2 = plan["n1"], plan["n2"]
    g = torch.Generator(device=dev).manual_seed(n + ct)
    xr = _signals(signal, b, n1, n2, g, dev)
    xi = None if kind == "real_rows" else _signals(signal, b, n1, n2, g, dev)
    kw = dict(rows=P.stage_a_real_rows(n1) if kind == "real_rows" else None,
              col_tiles=-(-(n2 // 2 + 1) // ct) if kind == "complex_col_tiles" else None)
    K.reset_counts()
    got = K.stage_a_bf16(xr, xi, n1, n2, plan, ct, **kw)
    assert K.COUNTS["stage_a_bf16"].launches == 1
    _close_fast(got, K.stage_a_bf16_plain(xr, xi, n1, n2, plan, ct, **kw))


@pytest.mark.parametrize("kind", ["real_rows", "complex", "complex_col_tiles"])
@pytest.mark.parametrize("layout", ["factored", "legacy"])
def test_stage_a_bf16_every_launch_shape(dev, kind, layout):
    """K3F and K3LF at (1, 2^20) at every launch shape their rule considers
    (``stage_a_bf16_launch_shapes``, the rule's pick first), each within
    1e-3 of the plain version."""
    n, sign = 1 << 20, -1 if kind == "real_rows" else 1
    plan = (P.on_device(P.get_stage_a_plan, n, sign, None, device=dev) if layout == "factored"
            else P.on_device(legacy_plan, n, 128, sign, device=dev))
    n1, n2 = plan["n1"], plan["n2"]
    ct = plan.get("ct", P.stage_a_col_tile(n1, n2))
    g = torch.Generator(device=dev).manual_seed(7)
    xr = torch.randn(1, n1, n2, generator=g, device=dev)
    xi = None if kind == "real_rows" else torch.randn(1, n1, n2, generator=g, device=dev)
    tiles = -(-(n2 // 2 + 1) // ct) if kind == "complex_col_tiles" else None
    rows = P.stage_a_real_rows(n1) if kind == "real_rows" else None
    r, ncols = K._stage_a_extent(n1, n2, plan, ct, tiles, rows)
    (img,) = K.bf16_images(plan)
    tables = [img, *(plan[k] for k in (K._TWIDDLE_FACTORS if layout == "factored" else K._TWIDDLE_TABLE))]
    want = K.stage_a_bf16_plain(xr, xi, n1, n2, plan, ct, tiles, rows)
    shapes = K.stage_a_bf16_launch_shapes(1, n1, n2, r, ncols, xi is not None, K.sm_count(dev))
    assert len(shapes) >= 2
    for geometry in shapes:
        _close_fast(K.stage_a_bf16_launch(xr, xi, tables, n1, n2, ct, r, ncols, geometry), want)


LEGACY_CASES = [(1 << 17, 16, False, None, None), (1 << 17, 16, True, None, 16),
                (1 << 17, 128, False, None, 72), (1 << 17, 128, True, 1, None),
                (1 << 20, 128, False, None, None), (1 << 20, 256, True, 2, 136),
                (1 << 22, 128, False, None, 72), (1 << 22, 512, True, None, None),
                (1 << 20, 256, False, None, 136), (1 << 20, 256, True, None, None), (48 * 4096, 48, True, None, 40)]


@pytest.mark.parametrize("n,n1,complex_,tiles,rows", LEGACY_CASES)
@pytest.mark.parametrize("signal", ["randn", "dc", "impulse"])
@pytest.mark.parametrize("b", [1, 3])
def test_stage_a_legacy_bf16_kernel(dev, n, n1, complex_, tiles, rows, signal, b, monkeypatch):
    """K3LF: ``stage_a`` on a legacy plan under "fast" launches it (and no
    other kernel), within 1e-3 of its plain version; B = 1 and 3, n1 = 256
    real (rows = 136) and complex, n1 = 512 complex (F streamed), n1 = 48
    (the last real group half padding)."""
    from gpu_fft_tpu_torch import config

    plan = P.on_device(legacy_plan, n, n1, 1 if complex_ else -1, device=dev)
    n2 = plan["n2"]
    ct = P.stage_a_col_tile(n1, n2)
    g = torch.Generator(device=dev).manual_seed(n1)
    xr = _signals(signal, b, n1, n2, g, dev)
    xi = _signals(signal, b, n1, n2, g, dev) if complex_ else None
    monkeypatch.setattr(config, "PRECISION", "fast")
    K.reset_counts()
    got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows)
    assert {k: c.launches for k, c in K.COUNTS.items() if c.launches or c.plain_calls} == {"stage_a_legacy_bf16": 1}
    _close_fast(got, K.stage_a_bf16_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows))


@pytest.mark.parametrize("n,n1", [(1 << 17, 128), (1 << 20, 128), (1 << 20, 256), (1 << 17, 32), (1 << 13, 128),
                                  (64 * 512, 64), (96 * 192, 96)])
def test_stage_a_manual_bf16_kernel(dev, n, n1, monkeypatch):
    """S2F: ``stage_a_manual`` under "fast" launches it (not S2), within
    1e-3 of its plain version, at every launch shape S3's bf16 x1 rule
    considers (the shipped one first); n1 = 64 and 96 take 128 and 64
    stacked rows a block, 96 a last depth chunk of 32."""
    from gpu_fft_tpu_torch import config

    plan = A.manual_tables(P.on_device(legacy_plan, n, n1, -1, device=dev))
    n2 = plan["n2"]
    x = torch.randn(n1, n2, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    want = A.stage_a_manual_bf16_plain(x, plan)
    monkeypatch.setattr(config, "PRECISION", "fast")
    A.reset_counts()
    _close_fast(A.stage_a_manual(x, plan), want)
    assert A.COUNTS["stage_a_manual_bf16"].launches == 1 and A.COUNTS["stage_a_manual"].launches == 0
    for geometry in A.dot_launch_shapes(1, n1, n2, "bf16_x1", A.sm_count(dev)):
        _close_fast(A.manual_bf16_launch(x, plan, geometry), want)


def test_fast_legacy_kernels_refuse_before_the_launch(dev, monkeypatch):
    """A shape K3LF or S2F cannot take raises ValueError on the card and
    launches nothing; S2F without its image raises too."""
    from gpu_fft_tpu_torch import config

    monkeypatch.setattr(config, "PRECISION", "fast")
    plan = P.on_device(legacy_plan, 24 * 64, 24, -1, device=dev)
    K.reset_counts()
    A.reset_counts()
    with pytest.raises(ValueError, match="n1 a multiple of 16"):
        K.stage_a(torch.zeros(1, 24, 64, device=dev), None, 24, 64, plan, 64)
    with pytest.raises(ValueError, match="stage_a_manual_bf16 kernel needs"):
        A.stage_a_manual(torch.zeros(48, 4096, device=dev), {})
    s2 = P.on_device(legacy_plan, 1 << 17, 128, -1, device=dev)
    with pytest.raises(ValueError, match="f_img"):
        A.stage_a_manual(torch.zeros(128, 1024, device=dev), s2)
    assert all(c.launches == 0 for c in (*K.COUNTS.values(), *A.COUNTS.values()))


@pytest.mark.parametrize("n,kernel", [(1024, "whole_transform_packed_bf16"), (4096, "whole_transform_bf16"),
                                      (1 << 20, "stage_a_bf16")])
def test_fast_mode_launches_its_kernels_on_card(dev, n, kernel, monkeypatch):
    """Under "fast" the main path launches K2F / K1F / K3F, never K1/K2/K3,
    within the mode's band; under "high" none of the six."""
    from gpu_fft_tpu_torch import config

    x = torch.randn(1, n, device=dev, generator=torch.Generator(device=dev).manual_seed(n))
    ref = np.fft.fft(x.double().cpu().numpy(), axis=-1)
    for mode, band, want in (("fast", 2e-2, {kernel: 1}), ("high", 2e-4, {})):
        monkeypatch.setattr(config, "PRECISION", mode)
        K.reset_counts()
        yr, yi = gt.fft_device(x)
        ran = {k: c.launches for k, c in K.COUNTS.items() if c.launches or c.plain_calls}
        assert ran == want
        err = max(np.abs(yr.cpu().numpy() - ref.real).max(), np.abs(yi.cpu().numpy() - ref.imag).max())
        assert 1e-6 < err / np.abs(ref).max() < band


@pytest.mark.parametrize("n,kernel", [(32768, "whole_transform"), (1 << 21, "stage_a")])
def test_packed_real_forward_launches_one_kernel_on_card(dev, n, kernel):
    """The gate-closed packed real forward (``plan.RFFT_PACK_MIN`` opened for
    the test): the n/2-point complex transform is one launch of K1, or of K3
    and K4, and the spectrum is within 5 log2(n) eps of numpy in float64."""
    from unittest import mock

    x = torch.randn(1, n, device=dev, generator=torch.Generator(device=dev).manual_seed(n))
    ref = np.fft.fft(x.double().cpu().numpy(), axis=-1)
    K.reset_counts()
    with mock.patch.object(P, "RFFT_PACK_MIN", 8):
        yr, yi = gt.fft_device(x)
    ran = {k: c.launches for k, c in K.COUNTS.items() if c.launches or c.plain_calls}
    assert ran == {kernel: 1, **({"stage_b": 1} if kernel == "stage_a" else {})}
    err = max(np.abs(yr.cpu().numpy() - ref.real).max(), np.abs(yi.cpu().numpy() - ref.imag).max())
    assert err / np.abs(ref).max() <= 5 * np.log2(n) * np.finfo(np.float32).eps
    assert not P.rfft_pack_applies(1, n)
