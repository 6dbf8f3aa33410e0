"""The port's 2-D convolutions (``gpu_fft_tpu_torch/ops/filter.py``) against
the JAX package's (``gpu_fft_tpu/ops/filter.py``) and scipy.signal, on the
CPU.

``fft_convolve2d``, ``fft_correlate2d``, ``convolve2d`` and ``correlate2d``
in every mode x boundary, ``fft_convolve2d_device`` with its batch rules,
and ``choose_conv_method`` on 2-D inputs; the same seeded images go
through both packages.  Tolerance: 1e-5 * max|JAX| against the JAX package
(both fp32 on the pow2 rfft2 path), and ``tests/test_filter2d.py``'s
1e-5 * max(1, max|scipy|) against scipy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import gpu_fft_tpu.ops.filter as jfilt
import gpu_fft_tpu_torch.ops.filter as tfilt

RTOL = 1e-5
MODES = ("full", "same", "valid")
BOUNDARIES = ("fill", "wrap", "symm")


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("shapes", [((12, 15), (3, 4)), ((9, 8), (5, 5)), ((7, 7), (7, 2))], ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["fft_convolve2d", "fft_correlate2d"])
def test_fft_conv2d_modes_match_jax_and_scipy(name, mode, shapes):
    x, k = _img(shapes[0], 1), _img(shapes[1], 2)
    got = getattr(tfilt, name)(x, k, mode, device="cpu")
    _close(got, getattr(jfilt, name)(x, k, mode))
    oracle = ss.convolve2d if name == "fft_convolve2d" else ss.correlate2d
    _close(got, oracle(x.astype(np.float32).astype(np.float64), k.astype(np.float32).astype(np.float64), mode))


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["convolve2d", "correlate2d"])
def test_boundary_forms_match_jax_and_scipy(name, mode, boundary):
    x, k = _img((11, 13), 3), _img((3, 4), 4)
    got = getattr(tfilt, name)(x, k, mode, boundary, device="cpu")
    _close(got, getattr(jfilt, name)(x, k, mode, boundary))
    _close(got, getattr(ss, name)(x, k, mode, boundary))


@pytest.mark.parametrize("name", ["convolve2d", "correlate2d"])
def test_fillvalue_matches_jax_and_scipy(name):
    x, k = _img((10, 9), 5), _img((3, 3), 6)
    got = getattr(tfilt, name)(x, k, "same", "fill", 2.5, device="cpu")
    _close(got, getattr(jfilt, name)(x, k, "same", "fill", 2.5))
    _close(got, getattr(ss, name)(x, k, "same", "fill", 2.5))


@pytest.mark.parametrize("xs,ks", [((16, 20), (5, 3)), ((3, 16, 20), (5, 3)), ((16, 20), (2, 5, 3)),
                                   ((2, 9, 9), (2, 4, 4)), ((1, 8, 8), (3, 3, 3))], ids=str)
def test_fft_convolve2d_device_batches_match_jax(xs, ks):
    """A one-image operand serves the other's batch (the port transforms it
    once and broadcasts the spectrum; the JAX package broadcasts the
    image)."""
    x, k = _img(xs, 7).astype(np.float32), _img(ks, 8).astype(np.float32)
    got = tfilt.fft_convolve2d_device(torch.from_numpy(x), torch.from_numpy(k))
    want = np.asarray(jfilt.fft_convolve2d_device(jnp.asarray(x), jnp.asarray(k)))
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), want)


@pytest.mark.parametrize("args", [((4,), (3, 3)), ((2, 4, 4), (3, 2, 2)), ((4, 0), (2, 2)),
                                  ((2, 2, 4, 4), (2, 2))], ids=str)
def test_fft_convolve2d_device_errors_match_jax(args):
    x, k = (np.ones(s, np.float32) for s in args)
    with pytest.raises(ValueError):
        jfilt.fft_convolve2d_device(x, k)
    with pytest.raises(ValueError):
        tfilt.fft_convolve2d_device(x, k, device="cpu")


@pytest.mark.parametrize("call", [
    lambda m, kw: m.fft_convolve2d(np.ones((4, 4)), np.ones((5, 5)), "valid", **kw),
    lambda m, kw: m.fft_convolve2d(np.ones((4, 4)), np.ones((2, 2)), "bogus", **kw),
    lambda m, kw: m.fft_correlate2d(np.ones(4), np.ones((2, 2)), **kw),
    lambda m, kw: m.convolve2d(np.ones((4, 4)), np.ones((2, 2)), boundary="circular", **kw),
    lambda m, kw: m.correlate2d(np.ones((4, 4)), np.ones((5, 2)), "valid", "wrap", **kw),
    lambda m, kw: m.convolve2d(np.ones(4), np.ones((2, 2)), **kw),
], ids=["valid-too-small", "bad-mode", "1-D", "bad-boundary", "valid-boundary", "1-D-boundary"])
def test_errors_match_jax(call):
    with pytest.raises(ValueError):
        call(jfilt, {})
    with pytest.raises(ValueError):
        call(tfilt, {"device": "cpu"})


def test_doctests_hold():
    img = np.array([[1.0, 2.0], [3.0, 4.0]])
    assert tfilt.fft_convolve2d(img, np.array([[1.0, 1.0]]), device="cpu").round(5).tolist() == \
        [[1.0, 3.0, 2.0], [3.0, 7.0, 4.0]]
    assert tfilt.fft_correlate2d(img, img, mode="valid", device="cpu").round(4).tolist() == [[30.0]]


@pytest.mark.parametrize("shapes,heuristic", [(((4, 4), (2, 2)), "direct"), (((64, 64), (9, 9)), "fft"),
                                              (((3,), (40,)), "direct")], ids=str)
def test_choose_conv_method_heuristic_matches_jax(shapes, heuristic):
    x, k = _img(shapes[0]), _img(shapes[1])
    assert tfilt.choose_conv_method(x, k) == jfilt.choose_conv_method(x, k) == heuristic


@pytest.mark.parametrize("mode", MODES)
def test_choose_conv_method_measures_2d_inputs(mode):
    """``measure=True`` times 2-D inputs through ``fft_convolve2d`` (the
    direct side times nothing, as in the JAX package)."""
    x, k = _img((32, 32)), _img((5, 5))
    method, times = tfilt.choose_conv_method(x, k, mode, measure=True, device="cpu")
    jmethod, jtimes = jfilt.choose_conv_method(x, k, mode, measure=True)
    assert set(times) == set(jtimes) == {"direct", "fft"}
    assert method in ("fft", "direct") and all(t > 0 for t in times.values())
    assert method == ("fft" if times["fft"] <= times["direct"] else "direct")


def test_choose_conv_method_measures_1d_inputs():
    method, times = tfilt.choose_conv_method(_img(300), _img(20), measure=True, device="cpu")
    assert method == ("fft" if times["fft"] <= times["direct"] else "direct")


def test_conv2d_step_runs_the_convolution():
    from gpu_fft_tpu_torch.utils.profiling import conv2d_step

    k = _img((3, 3)).astype(np.float32)
    step = conv2d_step(k, device="cpu")
    x = torch.from_numpy(_img((2, 16, 16)).astype(np.float32))
    y = step(x)
    full = np.stack([ss.convolve2d(xi.astype(np.float64), k.astype(np.float64)) for xi in x.numpy()])
    _close(y.numpy(), x.numpy() + 1e-6 * full[:, :16, :16])
