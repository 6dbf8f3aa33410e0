"""The port's multirate ops (``gpu_fft_tpu_torch/ops/multirate.py``) against
the JAX package's (``gpu_fft_tpu/ops/multirate.py``) on the CPU.

The same seeded numpy inputs go through both packages, with
``tests/test_multirate.py``'s gate, 2e-3 of max(1, max|ref|), against the
JAX package and scipy; ``decimate(ftype="iir")`` with
``tests/test_iir.py``'s 2e-5 absolute.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu_torch as gt


def _signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n,lh,up,down", [(50, 7, 1, 1), (100, 31, 3, 1), (100, 31, 1, 4), (257, 33, 3, 5),
                                          (1000, 64, 7, 3)])
def test_upfirdn_matches_jax(n, lh, up, down):
    x, h = _signal(n, n), _signal(lh, lh)
    got = gt.upfirdn(h, x, up, down, device="cpu")
    assert _err(got, gf.upfirdn(h, x, up, down)) < 2e-3
    assert _err(got, scipy.signal.upfirdn(h.astype(np.float64), x.astype(np.float64), up, down)) < 2e-3


def test_upfirdn_device_batched_matches_jax():
    x, h = _signal(1, 3, 400), _signal(2, 21)
    got = gt.upfirdn_device(torch.from_numpy(h), torch.from_numpy(x), 3, 2).numpy()
    assert _err(got, np.asarray(gf.upfirdn_device(h, x, 3, 2))) < 2e-3
    ref = scipy.signal.upfirdn(h.astype(np.float64), x.astype(np.float64), 3, 2, axis=-1)
    assert _err(got, ref) < 2e-3


def test_upfirdn_contract_errors():
    with pytest.raises(ValueError):
        gt.upfirdn(np.ones((2, 2)), np.ones(10), device="cpu")
    with pytest.raises(ValueError):
        gt.upfirdn(np.ones(3), np.ones(10), 0, 1, device="cpu")
    with pytest.raises(ValueError):
        gt.upfirdn(np.ones(3), np.ones((2, 2, 2)), device="cpu")


@pytest.mark.parametrize("n,up,down", [(1000, 2, 1), (1000, 1, 2), (1000, 3, 5), (777, 7, 3), (1024, 160, 441),
                                       (500, 4, 4), (4096, 3, 2)])
def test_resample_poly_kaiser_matches_jax(n, up, down):
    x = _signal(n + up, n)
    got = gt.resample_poly(x, up, down, device="cpu")
    assert _err(got, gf.resample_poly(x, up, down)) < 2e-3
    assert _err(got, scipy.signal.resample_poly(x.astype(np.float64), up, down)) < 2e-3


@pytest.mark.parametrize("up,down", [(2, 3), (3, 2)])
def test_resample_poly_array_window_matches_jax(up, down):
    x = _signal(9, 999)
    h = scipy.signal.firwin(41, 0.2)
    got = gt.resample_poly(x, up, down, window=h, device="cpu")
    assert _err(got, gf.resample_poly(x, up, down, window=h)) < 2e-3
    assert _err(got, scipy.signal.resample_poly(x.astype(np.float64), up, down, window=h)) < 2e-3


def test_resample_poly_device_batched_and_contracts():
    x = _signal(4, 3, 600)
    got = gt.resample_poly_device(torch.from_numpy(x), 3, 2).numpy()
    assert _err(got, np.asarray(gf.resample_poly_device(x, 3, 2))) < 2e-3
    same = gt.resample_poly_device(torch.from_numpy(x), 2, 2)
    assert np.array_equal(same.numpy(), x)
    with pytest.raises(ValueError):
        gt.resample_poly(x[0], 0, 1, device="cpu")
    with pytest.raises(ValueError):
        gt.resample_poly(np.ones(10), 2, 1, window=np.ones((2, 2)), device="cpu")


@pytest.mark.parametrize("q", [2, 5, 13])
@pytest.mark.parametrize("zero_phase", [True, False])
def test_decimate_fir_matches_jax(q, zero_phase):
    x = _signal(q, 2048)
    got = gt.decimate(x, q, ftype="fir", zero_phase=zero_phase, device="cpu")
    assert _err(got, gf.decimate(x, q, ftype="fir", zero_phase=zero_phase)) < 2e-3
    ref = scipy.signal.decimate(x.astype(np.float64), q, ftype="fir", zero_phase=zero_phase)
    assert _err(got, ref) < 2e-3


@pytest.mark.parametrize("q,zero_phase", [(2, True), (4, True), (7, True), (4, False)])
def test_decimate_iir_matches_jax(q, zero_phase):
    """scipy's default: an order-8 Chebyshev-I as second-order sections."""
    x = _signal(21, 4000)
    got = gt.decimate(x, q, zero_phase=zero_phase, device="cpu")
    jgot = gf.decimate(x, q, zero_phase=zero_phase)
    ref = scipy.signal.decimate(x.astype(np.float64), q, zero_phase=zero_phase)
    assert got.shape == ref.shape
    assert np.abs(got - jgot).max() < 2e-5
    assert np.abs(got - ref).max() < 2e-5


def test_decimate_custom_order_and_contracts():
    x = _signal(3, 1500)
    got = gt.decimate(x, 4, n=60, ftype="fir", device="cpu")
    assert _err(got, gf.decimate(x, 4, n=60, ftype="fir")) < 2e-3
    assert gt.decimate(np.arange(5, dtype=np.float32), 1, device="cpu").tolist() == [0, 1, 2, 3, 4]
    for bad in ({"q": 0}, {"q": 2, "ftype": "nope"}, {"q": 2, "n": 0}):
        with pytest.raises(ValueError):
            gt.decimate(x, device="cpu", **bad)
