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


@pytest.mark.parametrize("complex_,rows,tiles", [(False, 72, None), (True, None, None), (True, None, 1)])
def test_stage_a_kernel(dev, complex_, rows, tiles):
    n = 1 << 17
    ct = P.stage_a_ct_full_range(n)
    plan = P.on_device(P.get_stage_a_plan, n, -1, ct, device=dev)
    n1, n2 = plan["n1"], plan["n2"]
    g = torch.Generator(device=dev).manual_seed(1)
    xr = torch.randn(2, n1, n2, device=dev, generator=g)
    xi = torch.randn(2, n1, n2, device=dev, generator=g) if complex_ else None
    got = K.stage_a(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows)
    _close(got, K.stage_a_plain(xr, xi, n1, n2, plan, ct, col_tiles=tiles, rows=rows))


@pytest.mark.parametrize(
    "n,n1,complex_,tiles,rows",
    [(1 << 17, 16, False, None, None), (1 << 17, 16, True, None, 16),
     (1 << 17, 128, False, None, 72), (1 << 17, 128, True, 1, None),
     (1 << 20, 128, False, None, None), (1 << 20, 256, True, 2, 136)],
)
def test_stage_a_legacy_kernel(dev, n, n1, complex_, tiles, rows):
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


@pytest.mark.parametrize("n,n1", [(1 << 17, 128), (1 << 20, 128), (1 << 20, 256), (1 << 17, 32)])
def test_stage_a_manual_kernel(dev, n, n1):
    plan = P.on_device(legacy_plan, n, n1, -1, device=dev)
    x = torch.randn(n1, plan["n2"], device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    A.reset_counts()
    got = A.stage_a_manual(x, plan)
    assert A.COUNTS["stage_a_manual"].launches == 1
    _close(got, A.stage_a_manual_plain(x, plan))


@pytest.mark.parametrize("variant", A.VARIANTS)
@pytest.mark.parametrize("b,n1,n2", [(1, 128, 8192), (1, 32, 256), (2, 64, 512)])
def test_stage_a_dot_kernel(dev, variant, b, n1, n2):
    g = torch.Generator(device=dev).manual_seed(n1 + n2)
    fr = torch.randn(n1, n1, device=dev, generator=g) / n1
    fi = torch.randn(n1, n1, device=dev, generator=g) / n1
    x = torch.randn(b, n1, n2, device=dev, generator=g)
    tables = A.dot_tables(fr, fi)
    A.reset_counts()
    got = A.stage_a_dot(x, tables, variant)
    assert A.COUNTS[f"stage_a_dot_{variant}"].launches == 1
    _close(got, A.stage_a_dot_plain(x, tables, variant))


@pytest.mark.parametrize("n", [4096, 16384, 32768, 65536])  # n2 = 64, 128, 256, 256
@pytest.mark.parametrize("b", [1, 3])
def test_fused_fft_lm_kernel(dev, n, b):
    t = P.on_device(E.lm_tables, n, -1, device=dev)
    x = torch.randn(b, n, device=dev, generator=torch.Generator(device=dev).manual_seed(n + b))
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
    plan = P.on_device(legacy_plan, 1 << 17, 128, -1, device=dev)
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
