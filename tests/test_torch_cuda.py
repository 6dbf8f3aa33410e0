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
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.plan as P
from gpu_fft_tpu_torch.config import apply_precision

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


@pytest.mark.parametrize(
    "name,n",
    [("whole_transform_packed", 1024), ("whole_transform", 1024), ("whole_transform", 8192),
     ("whole_transform", 65536)],
)
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("complex_", [False, True])
def test_whole_kernel(dev, name, n, b, complex_):
    make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
    sign, scale = (1, 1.0 / n) if complex_ else (-1, None)
    plan = P.on_device(make_plan, n, sign, scale, device=dev)
    g = torch.Generator(device=dev).manual_seed(n + b)
    xr = torch.randn(b, n, device=dev, generator=g)
    xi = torch.randn(b, n, device=dev, generator=g) if complex_ else None
    K.reset_counts()
    got = getattr(K, name)(xr, xi, plan)
    assert K.COUNTS[name].launches == 1 and K.COUNTS[name].plain_calls == 0
    _close(got, getattr(K, name + "_plain")(xr, xi, plan))


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
