"""The port's ``scipy.ndimage`` Fourier filters
(``gpu_fft_tpu_torch/ops/ndimage_fourier.py``) against the JAX package's
(``gpu_fft_tpu/ops/ndimage_fourier.py``) and scipy.ndimage, on the CPU.

The same seeded spectrum, real or complex, goes through both packages and
scipy; the cases are ``tests/test_ndimage_fourier.py``'s: 1/2/3-D, odd and
even sizes, scalar and per-axis parameters, the real-transform mode
(``n``, ``axis``).  The filters are elementwise products by f32 tables made
from f64, so both packages agree to 1e-6 * max|JAX| and scipy to that
file's TOL = 2e-6 * max(1, max|scipy|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import gpu_fft_tpu.ndimage as jndi
import gpu_fft_tpu_torch.ndimage as tndi
import gpu_fft_tpu_torch.ops.ndimage_fourier as tnf

TOL = 2e-6
FILTERS = ("fourier_gaussian", "fourier_uniform", "fourier_ellipsoid", "fourier_shift")


def _spec(shape, complex_=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x


def _check(name, x, param, **kw):
    want_scipy = getattr(sndi, name)(x, param, **kw)
    want = np.asarray(getattr(jndi, name)(x, param, **kw))
    got = getattr(tndi, name)(x, param, **kw, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert np.iscomplexobj(got) == np.iscomplexobj(want)
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    assert np.abs(got - want_scipy).max() < TOL * max(1.0, np.abs(want_scipy).max())


PARAMS = {"fourier_gaussian": (2.0, 0.5), "fourier_uniform": (5.0, 2.0), "fourier_ellipsoid": (5.0, 3.0),
          "fourier_shift": (3.0, -2.5)}


@pytest.mark.parametrize("complex_", [True, False], ids=["complex", "real"])
@pytest.mark.parametrize("shape", [(16,), (15,), (16, 12), (9, 7), (8, 6, 10)])
@pytest.mark.parametrize("name", FILTERS)
def test_filter_matches_jax_and_scipy(name, shape, complex_):
    for param in PARAMS[name]:
        _check(name, _spec(shape, complex_), param)


@pytest.mark.parametrize("name,param", [("fourier_gaussian", (1.5, 3.0)), ("fourier_uniform", (4.0, 6.0)),
                                        ("fourier_ellipsoid", (4.0, 6.0)), ("fourier_shift", (1.0, -4.5))])
def test_per_axis_parameters(name, param):
    _check(name, _spec((16, 12)), param)


def test_ellipsoid_large_argument_exercises_the_j1_integral():
    _check("fourier_ellipsoid", _spec((64, 64)), 25.0)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", FILTERS)
def test_real_transform_mode(name, axis):
    """n >= 0: ``axis`` holds the rfft of a length-n real signal."""
    n = 24
    sig = np.random.default_rng(1).standard_normal((10, n) if axis == -1 else (n, 10))
    spec = np.fft.rfft(sig, axis=axis)
    _check(name, spec, {"fourier_shift": 2.5, "fourier_uniform": 4.0}.get(name, 1.5), n=n, axis=axis)


@pytest.mark.parametrize("name", FILTERS)
def test_device_forms_match_jax(name):
    """Split-complex tensors in and out; ``xi=None`` stays None except for
    the shift, whose output is complex."""
    x = _spec((12, 16))
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    param = {"fourier_shift": (1.0, -2.0)}.get(name, 2.0)
    for imag in (xi, None):
        want = getattr(jndi, name + "_device")(jnp.asarray(xr), None if imag is None else jnp.asarray(imag), param)
        got = getattr(tndi, name + "_device")(torch.from_numpy(xr), None if imag is None else torch.from_numpy(imag),
                                              param)
        assert (got[1] is None) == (want[1] is None)
        for g, w in zip(got, want):
            if w is not None:
                assert isinstance(g, torch.Tensor)
                assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6 * max(1.0, np.abs(np.asarray(w)).max())


def test_tables_are_built_once_per_device():
    tnf._separable_plan.cache_clear()
    x = torch.from_numpy(_spec((8, 10), False).astype(np.float32))
    for _ in range(3):
        tndi.fourier_gaussian_device(x, None, 1.25)
    info = tnf._separable_plan.cache_info()
    assert info.misses == 1 and info.hits == 0  # the device cache holds it after the first call


def test_ellipsoid_4d_raises():
    with pytest.raises(NotImplementedError):
        tndi.fourier_ellipsoid(_spec((4, 4, 4, 4)), 2.0, device="cpu")


def test_output_param_rejected():
    with pytest.raises(ValueError):
        tndi.fourier_gaussian(_spec((8,)), 1.0, output=np.zeros(8, complex), device="cpu")


def test_zero_n_raises_like_jax():
    for mod in (jndi, tndi):
        kw = {"device": "cpu"} if mod is tndi else {}
        with pytest.raises(ValueError):
            mod.fourier_gaussian(_spec((8, 5)), 1.0, n=0, **kw)


def test_namespace_is_the_jax_packages():
    assert tndi.__all__ == jndi.__all__


def test_j1_by_distinct_radius_in_blocks_is_the_jax_packages(monkeypatch):
    """The port integrates each distinct radius once, a block at a time;
    every value equals the JAX package's whole-grid quadrature bit for bit,
    across block edges and repeated radii."""
    import gpu_fft_tpu.ops.ndimage_fourier as jnf

    monkeypatch.setattr(tnf, "_J1_BLOCK", 7)
    x = np.random.default_rng(3).uniform(0.0, 40.0, (9, 11))
    x[3] = x[0]  # repeated radii
    np.testing.assert_array_equal(tnf._bessel_j1(x), jnf._bessel_j1(x))
    np.testing.assert_array_equal(tnf._ellipsoid_table(6.0, (20, 18), -1, -1),
                                  jnf._ellipsoid_table(6.0, (20, 18), -1, -1))
