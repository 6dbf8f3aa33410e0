"""The port's scipy.signal namespace (``gpu_fft_tpu_torch.signal``) against
the JAX package's (``gpu_fft_tpu.signal``) and scipy.signal, on the CPU.

Each complex wrapper runs on the same seeded input through both packages
and scipy; ``hilbert2`` and ``envelope_scipy`` run the JAX tests'
parametrised cases (``tests/test_filter2d.py``,
``tests/test_signal_completion.py``).  Tolerances: 1e-5 * max|JAX| against
the JAX package (both f32 on the same engines), and the JAX tests' own
gates against scipy.  The namespace's ``__all__`` is the JAX package's,
name for name.
"""

import numpy as np
import pytest
import scipy.signal as ss

import gpu_fft_tpu.signal as jsig
import gpu_fft_tpu_torch.signal as tsig
from gpu_fft_tpu.ops.dsp import envelope_scipy as j_envelope
from gpu_fft_tpu.ops.dsp import hilbert2 as j_hilbert2
from gpu_fft_tpu_torch.ops.dsp import envelope_scipy, hilbert2

JAX_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GPU_FFT_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sig():
    rng = np.random.default_rng(5)
    t = np.arange(2048) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.3 * rng.standard_normal(t.size)
    y = np.roll(x, 5) + 0.1 * rng.standard_normal(t.size)
    return x.astype(np.float32), y.astype(np.float32)


def _vs_jax(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= JAX_RTOL * np.abs(want).max()


def _vs_scipy(got, ref, tol):
    assert np.asarray(got).shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol


def test_all_is_the_jax_packages():
    assert tsig.__all__ == jsig.__all__
    assert all(hasattr(tsig, n) for n in tsig.__all__)


@pytest.mark.parametrize("N", [None, 1024, 4096])
def test_hilbert_complex(sig, N):
    x, _ = sig
    got = tsig.hilbert(x, N=N)
    assert np.iscomplexobj(got)
    _vs_jax(got, jsig.hilbert(x, N=N))
    _vs_scipy(got, ss.hilbert(x.astype(np.float64), N=N), 3e-5)


def test_csd_complex(sig):
    x, y = sig
    f, got = tsig.csd(x, y, fs=1e3, nperseg=256)
    fj, want = jsig.csd(x, y, fs=1e3, nperseg=256)
    fr, ref = ss.csd(x.astype(np.float64), y.astype(np.float64), fs=1e3, nperseg=256)
    assert np.iscomplexobj(got) and np.allclose(f, fj) and np.allclose(f, fr)
    _vs_jax(got, want)
    _vs_scipy(got, ref, 1e-4)


def test_stft_istft_complex(sig):
    x, _ = sig
    f, t, Z = tsig.stft(x, fs=1e3, nperseg=256)
    _, _, Zj = jsig.stft(x, fs=1e3, nperseg=256)
    fr, tr, Zr = ss.stft(x.astype(np.float64), fs=1e3, nperseg=256)
    assert np.iscomplexobj(Z) and np.allclose(f, fr) and np.allclose(t, tr)
    _vs_jax(Z, Zj)
    _vs_scipy(Z, Zr, 1e-4)
    tt, back = tsig.istft(Z, fs=1e3, nperseg=256)
    _, back_j = jsig.istft(Z, fs=1e3, nperseg=256)
    _, back_ref = ss.istft(Zr, fs=1e3, nperseg=256)
    _vs_jax(back, back_j)
    assert back.shape == back_ref.shape
    assert np.abs(back[: x.size] - x).max() < 1e-3


@pytest.mark.parametrize("call", ["czt", "czt_m_w_a", "zoom_fft"])
def test_czt_zoom_complex(sig, call):
    x = sig[0][:500]
    args = {"czt": ((), {}), "czt_m_w_a": ((64, np.exp(-0.02j), 1.0 + 0j), {}),
            "zoom_fft": (([90.0, 110.0],), {"m": 64, "fs": 1e3})}[call]
    name = call.split("_m")[0]
    got = getattr(tsig, name)(x, *args[0], **args[1])
    assert np.iscomplexobj(got)
    _vs_jax(got, getattr(jsig, name)(x, *args[0], **args[1]))
    _vs_scipy(got, getattr(ss, name)(x.astype(np.float64), *args[0], **args[1]), 3e-5)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("name", ["convolve", "correlate"])
def test_convolve_correlate_names(sig, name, mode):
    x, y = sig
    a, b = x[:777], y[:64]
    got = getattr(tsig, name)(a, b, mode=mode)
    _vs_jax(got, getattr(jsig, name)(a, b, mode=mode))
    _vs_scipy(got, getattr(ss, name)(a.astype(np.float64), b.astype(np.float64), mode=mode), 3e-5)
    with pytest.raises(ValueError, match="method"):
        getattr(tsig, name)(a, b, method="direct")


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("name", ["freqz", "sosfreqz", "freqz_sos", "freqz_zpk"])
def test_frequency_responses_complex(name, whole):
    args = {"freqz": ss.butter(4, 0.3), "sosfreqz": (ss.butter(6, 0.3, output="sos"),),
            "freqz_sos": (ss.cheby1(5, 1.0, 0.2, output="sos"),),
            "freqz_zpk": ss.ellip(4, 0.5, 40.0, 0.25, output="zpk")}[name]
    w, h = getattr(tsig, name)(*args, worN=257, whole=whole)
    wj, hj = getattr(jsig, name)(*args, worN=257, whole=whole)
    wr, hr = getattr(ss, name)(*args, worN=257, whole=whole)
    assert np.iscomplexobj(h)
    np.testing.assert_allclose(w, wj, atol=1e-12)
    np.testing.assert_allclose(w, wr, atol=1e-12)
    _vs_jax(h, hj)
    np.testing.assert_allclose(h, hr, atol=1e-5, rtol=1e-4)


def test_freqz_sos_is_sosfreqz():
    assert tsig.freqz_sos is tsig.sosfreqz


@pytest.mark.parametrize("window,nx,fftbins", [("hann", 128, True), (("kaiser", 8.6), 64, True),
                                               ("hann", 128, False), ("tukey", 65, False)])
def test_get_window(window, nx, fftbins):
    w = tsig.get_window(window, nx, fftbins=fftbins)
    np.testing.assert_array_equal(w, jsig.get_window(window, nx, fftbins=fftbins))
    assert np.abs(w - ss.get_window(window, nx, fftbins=fftbins)).max() < 1e-5


def test_reexported_estimators_match_scipy(sig):
    x, _ = sig
    f, p = tsig.welch(x, fs=1e3, nperseg=256)
    fr, pr = ss.welch(x.astype(np.float64), fs=1e3, nperseg=256)
    assert np.allclose(f, fr) and np.abs(p - pr).max() / pr.max() < 1e-4
    f, p = tsig.periodogram(x, fs=1e3)
    fr, pr = ss.periodogram(x.astype(np.float64), fs=1e3)
    assert np.allclose(f, fr) and np.abs(p - pr).max() / pr.max() < 1e-4


def test_multirate_names(sig):
    x, _ = sig
    h = tsig.firwin(31, 0.3)
    got = tsig.upfirdn(h, x[:1000], up=3, down=5)
    ref = ss.upfirdn(h.astype(np.float64), x[:1000].astype(np.float64), up=3, down=5)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 3e-5
    assert tsig.resample_poly(x[:1000], 2, 3).shape == ss.resample_poly(x[:1000].astype(np.float64), 2, 3).shape


# ── hilbert2 (tests/test_filter2d.py's cases) ────────────────────────────────

IMG = np.random.default_rng(23).standard_normal((20, 24))


@pytest.mark.parametrize("arr,N", [(IMG, None), (IMG[:19, :21], None), (IMG, (32, 32)), (IMG, 16)],
                         ids=["20x24", "19x21", "N32", "N16"])
def test_hilbert2_matches_jax_and_scipy(arr, N):
    got = hilbert2(arr, N=N)
    _vs_jax(got, j_hilbert2(arr, N=N))
    ref = ss.hilbert2(arr, N=N)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    assert tsig.hilbert2 is hilbert2


def test_hilbert2_batch_and_axes():
    arr = np.stack([IMG, -IMG])
    got = hilbert2(arr, axes=(-1, -2))
    _vs_jax(got, j_hilbert2(arr, axes=(-1, -2)))
    for i in range(2):
        ref = ss.hilbert2(arr[i].T).T
        np.testing.assert_allclose(got[i], ref, atol=1e-5 * np.abs(ref).max())


def test_hilbert2_errors():
    with pytest.raises(ValueError):
        hilbert2(IMG.astype(complex))
    with pytest.raises(ValueError):
        hilbert2(IMG[0])
    with pytest.raises(ValueError):
        hilbert2(IMG, axes=(0, 0))
    with pytest.raises(ValueError):
        hilbert2(IMG, N=(0, 4))


# ── envelope (tests/test_signal_completion.py's cases) ───────────────────────


def _env_sig(n=300, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n
    return (np.sin(2 * np.pi * 30 * t) * (1 + 0.5 * np.cos(2 * np.pi * 3 * t))
            + 0.1 * rng.standard_normal(n))


def _env_case(x, bp_in, **kw):
    got = envelope_scipy(x, bp_in, **kw)
    _vs_jax(got, j_envelope(x, bp_in, **kw))
    return got


@pytest.mark.parametrize("bp_in", [(1, None), (5, 60), (None, None), (10, None)])
@pytest.mark.parametrize("squared", [False, True])
def test_envelope_real_matches_jax_and_scipy(bp_in, squared):
    x = _env_sig()
    got = _env_case(x, bp_in, squared=squared)
    np.testing.assert_allclose(got, ss.envelope(x, bp_in, squared=squared), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("residual", ["lowpass", "all", None])
def test_envelope_residual_modes(residual):
    x = _env_sig(256, 1)
    got = _env_case(x, (8, 50), residual=residual)
    np.testing.assert_allclose(got, ss.envelope(x, (8, 50), residual=residual), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n_out", [128, 300, 512])
def test_envelope_n_out_resampling(n_out):
    x = _env_sig(256, 2)
    got = _env_case(x, (4, 40), n_out=n_out)
    np.testing.assert_allclose(got, ss.envelope(x, (4, 40), n_out=n_out), atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("bp_in", [(-20, 20), (2, 40)])
@pytest.mark.parametrize("n_out", [None, 128])
def test_envelope_complex_input(bp_in, n_out):
    rng = np.random.default_rng(3)
    z = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    got = _env_case(z, bp_in, n_out=n_out)
    np.testing.assert_allclose(got, ss.envelope(z, bp_in, n_out=n_out), atol=3e-4, rtol=1e-3)


def test_envelope_axis_and_batch():
    x = np.stack([_env_sig(128, s) for s in range(3)])  # (3, 128)
    got = _env_case(x, (2, 30), axis=-1)
    np.testing.assert_allclose(got, ss.envelope(x, (2, 30), axis=-1), atol=2e-4, rtol=1e-3)
    got_t = envelope_scipy(x.T, (2, 30), axis=0)
    np.testing.assert_allclose(got_t, np.moveaxis(got, -1, 1), atol=1e-6)


def test_envelope_namespace_and_errors():
    assert tsig.envelope is envelope_scipy
    x = _env_sig(64)
    for kw in ({"bp_in": (1, 2, 3)}, {"bp_in": (1, None), "n_out": 0}, {"bp_in": (40, 10)},
               {"bp_in": (1, None), "residual": "bandpass"}):
        bp = kw.pop("bp_in")
        with pytest.raises(ValueError):
            envelope_scipy(x, bp, **kw)
