"""The port's exact-length transform (``gpu_fft_tpu_torch/ops/exact.py``)
against the JAX package's, on the CPU: the same mixed-radix split and
tables (bit-identical, through ``plan.from_jax_plan``), the same Bluestein
tables, and ``fft_exact`` / ``ifft_exact`` at the lengths of
``tests/test_exact.py`` with its gates (numpy f64 as the oracle), and
within 1e-5 max |JAX| of the JAX package.  Gradients flow through both
strategies (a dot test)."""

import numpy as np
import pytest
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.ops.exact as jexact
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.ops.exact as texact
from gpu_fft_tpu_torch import plan as P

LENGTHS = [1, 3, 6, 12, 97, 100, 360, 997, 1000, 1536, 2018, 44100, 48000, 65537]


def _rel(got, want):
    scale = max(float(np.abs(np.asarray(w, np.float64)).max()) for w in want)
    return max(float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
               for g, w in zip(got, want)) / max(scale, 1e-30)


@pytest.mark.parametrize("n", [4, 6, 97, 360, 1000, 2018, 44100, 48000, 1 << 12, 3 << 16,
                               1009 * 997, 65537, 1000003])
def test_mixed_split_matches_jax(n):
    assert texact.mixed_split(n) == jexact.mixed_split(n)


@pytest.mark.parametrize("n", [6, 1000, 48000])
@pytest.mark.parametrize("sign", [-1, 1])
def test_mixed_plan_tables_are_bit_identical(n, sign):
    got = texact._mixed_plan(n, sign)
    want = P.from_jax_plan(jexact._mixed_plan(n, sign))
    assert (got.n, got.sign, got.kind, got.n1, got.n2) == (want.n, want.sign, want.kind, want.n1, want.n2)
    assert got.tables.keys() == want.tables.keys()
    for k in got.tables:
        assert np.array_equal(got.tables[k], want.tables[k]), k


@pytest.mark.parametrize("n", [3, 97, 2018])
@pytest.mark.parametrize("sign", [-1, 1])
def test_bluestein_tables_are_bit_identical(n, sign):
    got, want = texact._bluestein_plan(n, sign), jexact._bluestein_plan(n, sign)
    assert got.keys() == want.keys() and got["m"] == want["m"]
    for k in ("wr", "wi", "kr", "ki"):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n", LENGTHS)
def test_fft_exact_matches_jax_and_numpy(n):
    x = np.random.default_rng(n).uniform(-1.0, 1.0, n).astype(np.float32)
    re, im = gt.fft_exact(x, device="cpu")
    jre, jim = gf.fft_exact(x)
    assert re.shape == (n,) and re.dtype == np.float32
    assert _rel((re, im), (jre, jim)) <= 1e-5
    ref = np.fft.fft(x.astype(np.float64))
    scale = max(1.0, float(np.abs(ref).max()))
    assert max(np.abs(re - ref.real).max(), np.abs(im - ref.imag).max()) / scale < 2e-5
    rr, ri = gt.ifft_exact(re, im, device="cpu")
    jrr, jri = gf.ifft_exact(jre, jim)
    assert _rel((rr, ri), (jrr, jri)) <= 1e-5
    assert np.abs(rr - x).max() < 1e-4 and np.abs(ri).max() < 1e-4


@pytest.mark.parametrize("n", [6, 250, 1000, 997, 48000])
def test_complex_batches_match_jax(n):
    rng = np.random.default_rng(n + 1)
    xr, xi = rng.standard_normal((2, 3, n)).astype(np.float32)
    yr, yi = gt.fft_exact_device(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = gf.fft_exact_device(xr, xi)
    assert _rel((yr.numpy(), yi.numpy()), (np.asarray(jr), np.asarray(ji))) <= 1e-5
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    tol = 5e-6 if texact.mixed_split(n) else 2e-5
    assert _rel((yr.numpy(), yi.numpy()), (ref.real, ref.imag)) < tol
    br, bi = gt.ifft_exact_device(yr, yi)
    assert np.abs(br.numpy() - xr).max() < 5e-4 and np.abs(bi.numpy() - xi).max() < 5e-4


@pytest.mark.parametrize("n,path", [(1000, "mixed"), (997, "bluestein"), (1024, "pow2")])
def test_dispatch_and_gradients(n, path):
    """Each strategy is taken where the JAX package takes it (Bluestein at
    997: two K1 transforms at m = 2,048), and gradients flow through it."""
    assert (texact.mixed_split(n) is not None) == (path == "mixed")
    rng = np.random.default_rng(n)
    v, wr, wi = (rng.standard_normal((1, n)).astype(np.float32) for _ in range(3))
    vt = torch.from_numpy(v).requires_grad_()
    K.reset_counts()
    out = gt.fft_exact_device(vt)
    launches = {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls}
    assert launches == {"bluestein": {"whole_transform": 2}, "mixed": {},
                        "pow2": {"whole_transform_packed": 1}}[path]
    (g,) = torch.autograd.grad(out, vt, grad_outputs=(torch.from_numpy(wr), torch.from_numpy(wi)))
    lhs = float(np.vdot(out[0].detach().numpy().astype(np.float64), wr) +
                np.vdot(out[1].detach().numpy().astype(np.float64), wi))
    rhs = float(np.vdot(g.numpy().astype(np.float64), v))
    assert abs(lhs - rhs) / max(1.0, abs(lhs)) < 1e-4


def test_contracts():
    re, im = gt.fft_exact(np.array([3.5], np.float32), device="cpu")
    assert re[0] == pytest.approx(3.5) and im[0] == 0.0
    with pytest.raises(ValueError):
        gt.fft_exact(np.zeros(0, np.float32), device="cpu")
    with pytest.raises(ValueError):
        gt.ifft_exact(np.zeros(8, np.float32), np.zeros(4, np.float32), device="cpu")
    with pytest.raises(ValueError):
        gt.fft_exact_device(torch.zeros(4, 250), torch.zeros(1, 250))
    from gpu_fft_tpu_torch.config import MAX_N

    texact._check_exact_n(MAX_N)
    for bad in (MAX_N + 1, 2 * MAX_N):
        with pytest.raises(ValueError):
            texact._check_exact_n(bad)
