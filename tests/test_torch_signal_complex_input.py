"""Complex input to the port's scipy.signal namespace: a recorded divergence.

Fifteen functions of ``gpu_fft_tpu_torch.signal`` compute on real signals
(float32).  Given a complex array they used to return the answer for its real
part, with no more than numpy's ComplexWarning, as the JAX package still does
(``gpu_fft_tpu.signal``, which casts each input to float32).  The port now
raises TypeError before any work.  Each case holds the three facts: the port
raises for a complex numpy array and a complex tensor; a real input still
matches the JAX package (1e-5 of max|JAX|, both f32 on the same engines); the
JAX package's answer for the complex input is its answer for the real part,
recorded as it is.
"""

import warnings

import numpy as np
import pytest
import scipy.signal as ss
import torch

import gpu_fft_tpu.signal as jsig
import gpu_fft_tpu_torch.signal as tsig

JAX_RTOL = 1e-5
N = 3000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GPU_FFT_TPU_TORCH_DEVICE", "cpu")


def _signals():
    rng = np.random.default_rng(17)
    x, y, z = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    return x, y, (x + 1j * z).astype(np.complex64)


_H = np.hanning(31).astype(np.float32)
_SOS = ss.butter(4, 0.2, output="sos")

# name -> (positional arguments around the signal x, keywords); "x" marks it,
# "y" a second real signal.
CASES = {
    "lfilter": (([1.0, 0.5], [1.0, -0.2], "x"), {}),
    "sosfilt": ((_SOS, "x"), {}),
    "filtfilt": (([1.0, 0.5], [1.0, -0.2], "x"), {}),
    "fftconvolve": (("x", _H), {}),
    "oaconvolve": (("x", _H), {}),
    "correlate": (("x", "y"), {}),
    "upfirdn": ((_H, "x", 3, 2), {}),
    "resample": (("x", 1500), {}),
    "resample_poly": (("x", 3, 2), {}),
    "decimate": (("x", 4), {}),
    "welch": (("x",), {"nperseg": 256}),
    "csd": (("x", "y"), {"nperseg": 256}),
    "periodogram": (("x",), {}),
    "spectrogram": (("x",), {"nperseg": 256}),
    "stft": (("x",), {"nperseg": 256}),
}


def _args(spec, x, y):
    return [{"x": x, "y": y}[a] if isinstance(a, str) else a for a in spec]


def _flat(out) -> list[np.ndarray]:
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out)]


def _close(got, want, rtol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-30)


def test_the_cases_are_the_fifteen():
    assert tuple(CASES) == tsig._REAL_ONLY


@pytest.mark.parametrize("name", list(CASES))
def test_complex_input_raises_where_the_jax_package_takes_the_real_part(name):
    x, y, xc = _signals()
    spec, kw = CASES[name]
    port, jax_fn = getattr(tsig, name), getattr(jsig, name)
    # The port: TypeError for a complex array and a complex tensor, before any work.
    with pytest.raises(TypeError, match="complex input"):
        port(*_args(spec, xc, y), **kw)
    with pytest.raises(TypeError, match="complex input"):
        port(*_args(spec, torch.from_numpy(xc), y), **kw)
    # A real input still matches the JAX package.
    _close(port(*_args(spec, x, y), **kw), jax_fn(*_args(spec, x, y), **kw), JAX_RTOL)
    # The JAX package, as it is: the complex input's answer is the real part's.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.ComplexWarning)
        on_complex = jax_fn(*_args(spec, xc, y), **kw)
    _close(on_complex, jax_fn(*_args(spec, xc.real.copy(), y), **kw), 1e-6)
