"""The port's ShortTimeFFT (``gpu_fft_tpu_torch/ops/short_time_fft.py``)
against the JAX package's and scipy's, on the CPU: geometry, every
fft_mode, padding mode, scaling, detrend and constructor, forward and
inverse.  Gates: the JAX test's 2e-4 (relative to max) against scipy, and
1e-5 against the JAX package."""

import numpy as np
import pytest
import scipy.signal as ss
from scipy.signal.windows import hamming, hann, kaiser

from gpu_fft_tpu.ops.short_time_fft import ShortTimeFFT as JaxSTFT
from gpu_fft_tpu_torch.ops.short_time_fft import ShortTimeFFT


def _close(a, b, tol, label=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{label}: {a.shape} vs {b.shape}"
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)
    assert err <= tol, f"{label}: rel err {err:.2e}"


def _three(*args, **kw):
    return (ShortTimeFFT(*args, device="cpu", **kw), JaxSTFT(*args, **kw), ss.ShortTimeFFT(*args, **kw))


GRID = [(hann(8, sym=False), 3, 10.0), (hamming(10, sym=False), 4, 2.0),
        (kaiser(12, 8.0, sym=False), 5, 1.0), (np.ones(7), 2, 5.0)]


@pytest.mark.parametrize("w,hop,fs", GRID, ids=["hann8", "hamming10", "kaiser12", "rect7"])
@pytest.mark.parametrize("fft_mode", ["onesided", "twosided", "centered"])
@pytest.mark.parametrize("ps", [0, None, 2])
def test_stft_istft_and_geometry(w, hop, fs, fft_mode, ps):
    rng = np.random.default_rng(hop + len(w))
    for mfft in (len(w), len(w) + 5, 16):
        got, jax_, ref = _three(w, hop, fs, fft_mode=fft_mode, mfft=mfft, phase_shift=ps)
        n = 37
        x = rng.standard_normal(n)
        if fft_mode != "onesided":
            x = x + 1j * rng.standard_normal(n)
        for attr in ("p_min", "k_min", "m_num", "m_num_mid", "f_pts", "delta_t", "delta_f",
                     "invertible", "onesided_fft", "lower_border_end"):
            assert getattr(got, attr) == getattr(ref, attr), attr
        assert (got.p_max(n), got.k_max(n), got.upper_border_begin(n)) == (
            ref.p_max(n), ref.k_max(n), ref.upper_border_begin(n))
        _close(got.dual_win, ref.dual_win, 1e-7, "dual_win")
        z = got.stft(x)
        _close(z, jax_.stft(x), 1e-5, "stft vs jax")
        _close(z, ref.stft(x), 2e-4, "stft vs scipy")
        back = got.istft(z.astype(np.complex128), k1=n)
        _close(back, jax_.istft(z.astype(np.complex128), k1=n), 1e-5, "istft vs jax")
        _close(back, ref.istft(ref.stft(x), k1=n), 2e-4, "istft vs scipy")


@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_padding_modes(padding):
    x = np.random.default_rng(1).standard_normal(37)
    got, jax_, ref = _three(hann(8, sym=False), 3, 10.0)
    z = got.stft(x, padding=padding)
    _close(z, jax_.stft(x, padding=padding), 1e-5, padding)
    _close(z, ref.stft(x, padding=padding), 2e-4, padding)


@pytest.mark.parametrize("sc", ["magnitude", "psd"])
def test_scalings_and_onesided2x(sc):
    x = np.random.default_rng(2).standard_normal(37)
    got, jax_, ref = _three(hann(8, sym=False), 3, 10.0, fft_mode="onesided2X", scale_to=sc)
    assert got.scaling == sc and np.isclose(got.fac_psd, ref.fac_psd)
    z = got.stft(x)
    _close(z, jax_.stft(x), 1e-5, "onesided2X vs jax")
    _close(z, ref.stft(x), 2e-4, "onesided2X vs scipy")
    _close(got.istft(z.astype(np.complex128), k1=37), x, 2e-4, "roundtrip")


def test_detrend_spectrogram_ranges_and_channels():
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(37), rng.standard_normal(37)
    got = ShortTimeFFT.from_window("hann", 10.0, 8, 5, device="cpu")
    jax_ = JaxSTFT.from_window("hann", 10.0, 8, 5)
    ref = ss.ShortTimeFFT.from_window("hann", 10.0, 8, 5)
    for label, fn in [
        ("linear", lambda s: s.stft_detrend(x, "linear")),
        ("constant", lambda s: s.stft_detrend(x, "constant")),
        ("callable", lambda s: s.stft_detrend(x, lambda f: f - f.mean(axis=-1, keepdims=True))),
        ("spectrogram", lambda s: s.spectrogram(x)),
        ("cross", lambda s: s.spectrogram(x, y)),
        ("p range", lambda s: s.stft(x, p0=2, p1=7)),
        ("k_offset", lambda s: s.stft(x, k_offset=4)),
        ("channels", lambda s: s.stft(np.stack([x, y, x + y]))),
    ]:
        z = fn(got)
        _close(z, fn(jax_), 1e-5, f"{label} vs jax")
        _close(z, fn(ref), 2e-4, f"{label} vs scipy")
    xm = np.stack([x, y])
    _close(got.istft(got.stft(xm).astype(np.complex128), k1=37), xm, 2e-4, "channels istft")


def test_alt_constructors():
    w = hann(8, sym=False)
    for ctor in ("from_dual", "from_win_equals_dual"):
        got = getattr(ShortTimeFFT, ctor)(w, 3, 10.0, device="cpu")
        _close(got.win, getattr(JaxSTFT, ctor)(w, 3, 10.0).win, 1e-12, ctor)
        _close(got.win, getattr(ss.ShortTimeFFT, ctor)(w, 3, 10.0).win, 1e-7, ctor)


def test_validation_errors():
    w = hann(8, sym=False)
    for kw in (dict(hop=0), dict(fs=-1.0), dict(mfft=4), dict(fft_mode="bogus"),
               dict(fft_mode="onesided2X"), dict(phase_shift=99)):
        args = dict(win=w, hop=3, fs=1.0, device="cpu") | kw
        with pytest.raises(ValueError):
            ShortTimeFFT(**args)
    s = ShortTimeFFT(w, 3, 1.0, device="cpu")
    with pytest.raises(ValueError):
        s.stft(np.ones(37) * 1j)
    with pytest.raises(ValueError):
        s.stft(np.ones(37), p0=0, p1=0)
    with pytest.raises(ValueError):
        s.istft(np.zeros((3, 4), np.complex64))
    with pytest.raises(ValueError):
        s.stft(np.ones(37), padding="wrap")
    bad = ShortTimeFFT(np.ones(4), 9, 1.0, device="cpu")
    assert not bad.invertible


def test_large_frame_roundtrip_on_the_staged_and_exact_paths():
    """A 1,024-sample frame with hop 256 (the card's shape, shorter signal)
    and a non-power-of-two mfft (the exact path), both back to the signal."""
    x = np.random.default_rng(4).standard_normal(1 << 14).astype(np.float32)
    for mfft in (None, 1200):
        got = ShortTimeFFT.from_window("hann", 1.0, 1024, 768, mfft=mfft, device="cpu")
        ref = ss.ShortTimeFFT.from_window("hann", 1.0, 1024, 768, mfft=mfft)
        z = got.stft(x)
        _close(z, ref.stft(x), 2e-4, f"stft mfft={mfft}")
        _close(got.istft(z, k1=x.size), x, 2e-4, f"roundtrip mfft={mfft}")
