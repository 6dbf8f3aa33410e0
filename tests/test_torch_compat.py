"""The port's scipy.fft namespace (``gpu_fft_tpu_torch.compat``) against the
JAX package's (``gpu_fft_tpu.compat``) and scipy.fft, on the CPU.

Every name in ``__all__`` runs on the same seeded inputs through both
packages and scipy in float64: the three norms, ``n`` crop / pad,
``axis`` / ``axes`` / ``s``, lengths off powers of two (mixed four-step and
Bluestein), powers of two on the dispatch (K2 / K1 / K3's plain versions
here), and DCT / DST types 1-4.  Tolerances: 1e-5 * max|JAX| against the
JAX package, and ``tests/test_compat.py``'s 3e-5 * max(1, max|scipy|)
against scipy (5e-5 in the fuzz).  Then the uarray dispatch, the workers
and backend-control API, the validation errors, tensors in and out with a
gradient against ``jax.grad``, and the deterministic fuzz.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sf
import torch

import gpu_fft_tpu.compat as jf
import gpu_fft_tpu_torch.compat as cf

ROOT = Path(__file__).resolve().parent.parent
NORMS = [None, "ortho", "forward"]
JAX_RTOL = 1e-5
SCIPY_TOL = 3e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """Host calls (numpy in) run on the CPU: the uarray path passes scipy's
    arguments only, so the device comes from the environment."""
    monkeypatch.setenv("GPU_FFT_TPU_TORCH_DEVICE", "cpu")


def _data():
    rng = np.random.default_rng(7)
    c = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)  # noqa: E731
    return {
        "x": rng.standard_normal((3, 50)).astype(np.float32),
        "z": c(3, 50),
        "w": rng.standard_normal((4, 12, 20)).astype(np.float32),
        "zc": c(4, 12, 20),
        "p": rng.standard_normal((2, 1024)).astype(np.float32),  # powers of two: the dispatch
        "zp": c(1, 4096),
        "hp": c(1, 2049),
        "prime": c(2, 1009),  # Bluestein at m = 2,048
    }


D = _data()


def _f64(a):
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _case(name, args, kwargs=None, ref=None):
    """(id, function name, positional data keys or values, kwargs, scipy name)."""
    return pytest.param(name, args, kwargs or {}, ref or name,
                        id=f"{name}-{'-'.join(map(str, args))}-{kwargs or ''}")


CASES = []
for norm in NORMS:
    nk = {"norm": norm}
    CASES += [
        _case("fft", ("z",), nk), _case("ifft", ("z",), nk),
        _case("rfft", ("x",), nk), _case("irfft", ("z26",), nk),
        _case("hfft", ("z26",), nk), _case("ihfft", ("x",), nk),
        _case("fftn", ("zc",), nk), _case("ifftn", ("zc",), nk),
        _case("fft2", ("zc",), nk), _case("ifft2", ("zc",), nk),
        _case("rfftn", ("w",), nk), _case("irfftn", ("zc11",), nk),
        _case("rfft2", ("w",), nk), _case("irfft2", ("zc11",), nk),
        _case("hfftn", ("zc11",), nk), _case("ihfftn", ("w",), nk),
        _case("hfft2", ("zc11",), nk), _case("ihfft2", ("w",), nk),
        _case("fft", ("p",), nk), _case("ifft", ("zp",), nk),
        _case("rfft", ("p",), nk), _case("irfft", ("hp",), nk),
        _case("fft", ("prime",), nk), _case("ifft", ("prime",), nk),
    ]
CASES += [
    _case("fft", ("z",), {"n": 30}),
    _case("fft", ("z",), {"n": 64, "axis": 0}),
    _case("rfft", ("x",), {"n": 64}),
    _case("irfft", ("z26",), {"n": 64}),
    _case("irfft", ("z26",), {"n": 51}),
    _case("irfft", ("z26",), {"n": 20}),
    _case("ihfft", ("x",), {"n": 40, "axis": 0}),
    _case("hfft", ("z26",), {"n": 30}),
    _case("fftn", ("zc",), {"s": (8, 16)}),
    _case("fftn", ("zc",), {"axes": (0, 2)}),
    _case("ifftn", ("zc",), {"s": (5, 9), "axes": (2, 0)}),
    _case("rfftn", ("w",), {"s": (8, 32), "axes": (1, 2)}),
    _case("irfftn", ("zc11",), {"s": (8, 16), "axes": (1, 2)}),
    _case("hfftn", ("zc11",), {"s": (8, 16), "axes": (1, 2)}),
    _case("ihfftn", ("w",), {"s": (6, 10), "axes": (0, 1)}),
    _case("fft2", ("zc",), {"s": (16, 16)}),
    _case("rfft2", ("w",), {"s": (16, 32), "axes": (0, 2)}),
    _case("irfft2", ("zc11",), {"s": (12, 32)}),
    _case("hfft2", ("zc11",), {"axes": (0, 2)}),
    _case("ihfft2", ("w",), {"s": (8, 8)}),
    _case("dct", ("x",), {"n": 30, "axis": 0}),
    _case("dctn", ("w",), {"axes": (0, 2)}),
    _case("idctn", ("w",), {"type": 3, "norm": "ortho"}),
    _case("dstn", ("w",), {"type": 1, "s": (6, 12), "axes": (0, 1)}),
    _case("idstn", ("w",), {"s": (8, 16), "axes": (1, 2)}),
]
for type_ in (1, 2, 3, 4):
    for norm in (None, "ortho"):
        for name in ("dct", "idct", "dst", "idst"):
            CASES.append(_case(name, ("x",), {"type": type_, "norm": norm}))


def _arg(key):
    if key == "z26":
        return D["z"][:, :26]
    if key == "zc11":
        return D["zc"][..., :11]
    return D[key]


@pytest.mark.parametrize("name,args,kwargs,ref", CASES)
def test_transform_matches_jax_and_scipy(name, args, kwargs, ref):
    a = [_arg(k) for k in args]
    got = getattr(cf, name)(*a, **kwargs)
    assert isinstance(got, np.ndarray)
    jx = np.asarray(getattr(jf, name)(*a, **kwargs))
    assert got.shape == jx.shape and got.dtype == jx.dtype, (got.shape, got.dtype, jx.shape, jx.dtype)
    assert np.abs(got - jx).max() <= JAX_RTOL * max(np.abs(jx).max(), 1e-30)
    want = getattr(sf, ref)(*[_f64(v) for v in a], **kwargs)
    assert np.abs(got - want).max() <= SCIPY_TOL * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("name,args", [
    ("fftfreq", (10, 0.1)), ("rfftfreq", (11, 0.5)), ("next_fast_len", (1000,)), ("prev_fast_len", (1000,)),
    ("fhtoffset", (0.02, 0.5)),
])
def test_helpers_match_jax(name, args):
    got, want = getattr(cf, name)(*args), getattr(jf, name)(*args)
    assert np.allclose(got, np.asarray(want), rtol=1e-12, atol=0)


def test_helpers_reexported():
    assert np.allclose(cf.fftfreq(10, 0.1), sf.fftfreq(10, 0.1))
    assert np.allclose(cf.rfftfreq(10, 0.1), sf.rfftfreq(10, 0.1))
    assert cf.next_fast_len(1000) == 1024  # this library's pow2 rule
    x = np.arange(8.0)
    assert np.allclose(cf.fftshift(x), sf.fftshift(x))
    assert np.allclose(cf.ifftshift(x), sf.ifftshift(x))
    assert abs(cf.fhtoffset(0.02, 0.5) - sf.fhtoffset(0.02, 0.5)) < 1e-12


@pytest.mark.parametrize("name", ["fht", "ifht"])
def test_fht_matches_jax_and_scipy(name):
    n, dln, mu = 64, 0.1, 0.5
    r = np.exp((np.arange(n) - n // 2) * dln)
    a = (r ** 1.5 * np.exp(-r * r / 2)).astype(np.float32)
    got = getattr(cf, name)(a, dln, mu)
    jx = np.asarray(getattr(jf, name)(a, dln, mu))
    assert np.abs(got - jx).max() <= JAX_RTOL * np.abs(jx).max()
    want = getattr(sf, name)(a.astype(np.float64), dln, mu)
    assert np.abs(got - want).max() <= SCIPY_TOL * max(1.0, np.abs(want).max())


def test_all_names_are_the_jax_packages():
    assert cf.__all__ == jf.__all__
    assert all(callable(getattr(cf, n)) or n == "backend" for n in cf.__all__)


@pytest.mark.parametrize("name,key,dtype", [
    ("fft", "x", np.complex64), ("ifft", "z", np.complex64), ("rfft", "x", np.complex64),
    ("irfft", "z", np.float32), ("hfft", "z", np.float32), ("ihfft", "x", np.complex64),
    ("dct", "x", np.float32), ("rfftn", "w", np.complex64), ("irfftn", "zc", np.float32),
])
def test_numpy_in_gives_numpy_out(name, key, dtype):
    """Non-tensor input comes back as numpy in scipy's single-precision
    dtypes (the JAX package returns a jax.Array: ROADMAP §3)."""
    out = getattr(cf, name)(D[key])
    assert isinstance(out, np.ndarray) and out.dtype == dtype


def test_scipy_set_backend_dispatch():
    x, z, w = D["x"], D["z"], D["w"]
    with sf.set_backend(cf.backend):
        got_fft = sf.fft(z)
        got_dct = sf.dct(x)
        got_rfftn = sf.rfftn(w)
    assert isinstance(got_fft, np.ndarray) and got_fft.dtype == np.complex64  # our path, not scipy's f64
    for got, want in ((got_fft, sf.fft(_f64(z))), (got_dct, sf.dct(_f64(x))), (got_rfftn, sf.rfftn(_f64(w)))):
        assert np.abs(got - want).max() <= SCIPY_TOL * max(1.0, np.abs(want).max())


def test_validation():
    z = np.ones(8, np.complex64)
    with pytest.raises(ValueError, match="invalid norm"):
        cf.fft(z, norm="bogus")
    with pytest.raises(ValueError, match="out of bounds"):
        cf.fft(z, axis=3)
    with pytest.raises(ValueError, match="invalid number of data points"):
        cf.fft(z, n=0)
    with pytest.raises(TypeError, match="real input"):
        cf.rfft(z)
    with pytest.raises(TypeError, match="real input"):
        cf.dct(z)
    with pytest.raises(ValueError, match="same length"):
        cf.fftn(np.ones((4, 4), np.float32), s=(4, 4), axes=(0,))
    with pytest.raises(ValueError, match="unique"):
        cf.fftn(np.ones((4, 4), np.float32), axes=(1, 1))
    with pytest.raises(ValueError, match="exceeds dimensionality"):
        cf.fftn(np.ones((4, 4), np.float32), axes=(2,))
    with pytest.raises(ValueError, match="invalid number of data points"):
        cf.irfft(np.ones(1, np.complex64))
    with pytest.raises(NotImplementedError, match="orthogonalize"):
        cf.dct(np.ones(8, np.float32), norm="ortho", orthogonalize=False)


def test_no_card_means_no_cpu_fallback(monkeypatch):
    """Numpy input with no device asked for runs on "cuda": where there is
    none, the call raises rather than computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("GPU_FFT_TPU_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cf.fft(D["z"])
    assert cf.fft(D["z"], device="cpu").dtype == np.complex64


def test_tensors_in_give_tensors_out_with_a_gradient():
    """The counterpart of the JAX package's ``test_jit_composable``: the
    pipeline rfft -> |X|^2 -> irfft on tensors stays a tensor on the input's
    device, matches scipy, and its gradient matches jax.grad's."""
    x = np.random.default_rng(3).standard_normal((2, 48)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((2, 48)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    spec = cf.rfft(xt)
    out = cf.irfft(spec * torch.conj(spec), n=48)
    assert isinstance(out, torch.Tensor) and out.device == xt.device and out.dtype == torch.float32
    ref = sf.irfft(np.abs(sf.rfft(x.astype(np.float64))) ** 2, n=48)
    assert float((out.detach() - torch.from_numpy(ref)).abs().max()) / max(1.0, np.abs(ref).max()) < 3e-5
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)

    def pipeline(v):
        s = jf.rfft(v)
        return jnp.sum(jf.irfft(s * jnp.conj(s), n=48) * w)

    want = np.asarray(jax.grad(pipeline)(x))
    assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name,key", [("fft", "zc11"), ("ifft", "zc11"), ("fftn", "zc11"), ("hfft", "zc11"),
                                      ("ihfftn", "w")])
def test_tensor_in_and_device_argument(name, key):
    """A tensor stays a tensor on its device (``device`` moves it); the
    values are the numpy path's."""
    a = _arg(key)
    got = getattr(cf, name)(torch.from_numpy(a))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert torch.equal(got, getattr(cf, name)(torch.from_numpy(a), device="cpu"))
    assert np.array_equal(got.numpy(), getattr(cf, name)(a))


def test_property_fuzz_vs_scipy(rng):
    """Deterministic fuzz: random transform family x shape x axis x n x norm
    against the scipy.fft f64 oracle, ``tests/test_compat.py``'s draws."""
    norms = [None, "ortho", "forward"]
    for _ in range(25):
        family = rng.choice(["fft", "ifft", "rfft", "irfft", "fftn", "rfftn", "dct", "dst"])
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(2, 40)) for _ in range(ndim))
        axis = int(rng.integers(0, ndim))
        norm = norms[int(rng.integers(0, 3))]
        n = int(rng.integers(2, 64)) if rng.random() < 0.5 else None
        xr = rng.standard_normal(shape).astype(np.float32)
        label = f"{family} shape={shape} axis={axis} n={n} norm={norm}"
        if family in ("fft", "ifft"):
            x = (xr + 1j * rng.standard_normal(shape)).astype(np.complex64)
            got = getattr(cf, family)(x, n=n, axis=axis, norm=norm)
            ref = getattr(sf, family)(x.astype(np.complex128), n=n, axis=axis, norm=norm)
        elif family == "rfft":
            got = cf.rfft(xr, n=n, axis=axis, norm=norm)
            ref = sf.rfft(xr.astype(np.float64), n=n, axis=axis, norm=norm)
        elif family == "irfft":
            x = (xr + 1j * rng.standard_normal(shape)).astype(np.complex64)
            if x.shape[axis] < 2 and n is None:
                continue  # scipy rejects n=0 output; covered by the validation test
            got = cf.irfft(x, n=n, axis=axis, norm=norm)
            ref = sf.irfft(x.astype(np.complex128), n=n, axis=axis, norm=norm)
        elif family in ("fftn", "rfftn"):
            x = xr if family == "rfftn" else (xr + 1j * rng.standard_normal(shape)).astype(np.complex64)
            naxes = int(rng.integers(1, ndim + 1))
            axes = tuple(sorted(rng.choice(ndim, size=naxes, replace=False).tolist()))
            s = tuple(int(rng.integers(2, 48)) for _ in axes) if rng.random() < 0.5 else None
            label = f"{family} shape={shape} axes={axes} s={s} norm={norm}"
            got = getattr(cf, family)(x, s=s, axes=axes, norm=norm)
            xref = x.astype(np.complex128 if family == "fftn" else np.float64)
            ref = getattr(sf, family)(xref, s=s, axes=axes, norm=norm)
        else:  # dct / dst
            type_ = int(rng.integers(1, 5))
            norm_r = None if norm == "forward" else norm
            label = f"{family}{type_} shape={shape} axis={axis} n={n} norm={norm_r}"
            got = getattr(cf, family)(xr, type=type_, n=n, axis=axis, norm=norm_r)
            ref = getattr(sf, family)(xr.astype(np.float64), type=type_, n=n, axis=axis, norm=norm_r)
        assert got.shape == ref.shape, label
        assert np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max())) < 5e-5, label


def test_workers_api_roundtrip():
    assert cf.get_workers() == 1
    with cf.set_workers(4):
        assert cf.get_workers() == 4
        with cf.set_workers(2):
            assert cf.get_workers() == 2
        assert cf.get_workers() == 4
    assert cf.get_workers() == 1
    with pytest.raises(ValueError):
        with cf.set_workers(0):
            pass


def test_backend_control_functions():
    x = np.random.default_rng(0).standard_normal(256)
    with cf.set_backend():
        got = sf.fft(x)
    assert got.dtype == np.complex64
    ref = np.fft.fft(x.astype(np.float64))
    assert np.abs(got - ref).max() < 1e-4
    with cf.set_backend():
        with cf.skip_backend():
            assert np.abs(sf.fft(x) - ref).max() < 1e-10  # scipy's own f64 path


def test_register_and_global_backend_subprocess():
    """register_backend / set_global_backend change scipy's process-wide
    registry (scipy offers no undo), so they run in a process of their own,
    which imports no jax."""
    code = (
        "import sys, numpy as np, scipy.fft as sf\n"
        "import gpu_fft_tpu_torch.compat as cf\n"
        "cf.register_backend()\n"
        "cf.set_global_backend()\n"
        "x = np.random.default_rng(0).standard_normal(256)\n"
        "got = sf.fft(x)\n"
        "assert got.dtype == np.complex64, got.dtype\n"  # proof it ran our path
        "assert np.abs(got - np.fft.fft(x)).max() < 1e-4\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, GPU_FFT_TPU_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout
