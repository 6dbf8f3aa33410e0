"""The port's short-time transforms and spectral estimators against the JAX
package's, on the CPU (``gpu_fft_tpu_torch/ops/stft.py``,
``ops/spectral.py``).

The same seeded numpy inputs go through both packages; the gates are the
JAX package's own tests' (``tests/test_analysis_ops.py``,
``tests/test_spectrogram.py``, ``tests/test_autodiff.py``), relative to
max |JAX| where those are relative.  The framing and overlap-add are the
port's own (``unfold``, ``fold``): they are held against the JAX package's
slice forms at every gcd class of (frame, hop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.ops.stft as jstft
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.ops.stft as tstft

GCD_CLASSES = [(256, 64), (256, 96), (64, 7), (512, 3), (128, 128), (16, 40)]


def _rel(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-30)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale


def _signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ── Framing and overlap-add ──────────────────────────────────────────────────


@pytest.mark.parametrize("frame,hop", GCD_CLASSES)
def test_frame_signal_and_overlap_add_match_jax(frame, hop):
    x = _signal(frame + hop, 4096)
    num = (4096 - frame) // hop + 1
    got = tstft.frame_signal(torch.from_numpy(x), frame, hop, num)
    assert np.array_equal(got.numpy(), np.asarray(jstft.frame_signal(jnp.asarray(x), frame, hop, num)))
    frames = _signal(frame * hop, 9, frame)
    total = 8 * hop + frame + 5  # the tail pad too
    got = tstft.overlap_add(torch.from_numpy(frames), hop, total).numpy()
    assert _rel(got, np.asarray(jstft.overlap_add(frames, hop, total))) <= 1e-6
    assert tstft.overlap_add(torch.from_numpy(frames), hop, total - 20).shape == (total - 20,)


# ── STFT / ISTFT ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("window,frame,hop", [
    (None, 128, 128), ("hann", 128, 64), ("hamming", 128, 32), ("blackman", 128, 64),
    ("hann", 256, 96), (("kaiser", 8.6), 64, 7),
], ids=str)
def test_stft_istft_match_jax(window, frame, hop):
    """Spectra within 1e-5 of the JAX package's; the roundtrip within
    test_analysis_ops.py's 2e-3 of the signal and of the JAX roundtrip
    wherever the window power exceeds 1e-6 (elsewhere the WOLA division
    magnifies rounding, in both packages)."""
    x = _signal(frame + hop, 2000)
    r, i = gt.stft(x, frame, hop=hop, window=window, device="cpu")
    jr, ji = gf.stft(x, frame, hop=hop, window=window)
    assert _rel((r, i), (jr, ji)) <= 1e-5
    y = gt.istft(r, i, hop=hop, window=window, length=2000, device="cpu")
    jy = gf.istft(jr, ji, hop=hop, window=window, length=2000)
    num = (2000 - frame) // hop + 1
    cov = (num - 1) * hop + frame
    w = gf.window_table(window, frame).astype(np.float64)
    wsq = np.zeros(cov)
    for m in range(num):
        wsq[m * hop : m * hop + frame] += w * w
    ok = wsq > 1e-6
    assert np.abs(y[:cov][ok] - jy[:cov][ok]).max() <= 2e-3
    assert np.abs(y[:cov][ok] - x[:cov][ok]).max() <= 2e-3
    assert np.array_equal(y[cov:], jy[cov:])


def test_stft_multichannel_and_lengths_match_jax():
    x = _signal(3, 3, 2048)
    r, i = gt.stft_device(torch.from_numpy(x), 256, hop=64)
    jr, ji = gf.stft_device(x, 256, hop=64)
    assert r.shape == (3, 29, 129) and _rel((r.numpy(), i.numpy()), (np.asarray(jr), np.asarray(ji))) <= 1e-5
    y = gt.istft_device(r, i, hop=64, length=2048)
    assert y.shape == (3, 2048)
    assert _rel(y.numpy(), np.asarray(gf.istft_device(jr, ji, hop=64, length=2048))) <= 1e-5
    r1, i1 = gt.stft(x[0], 128, hop=64, device="cpu")
    assert gt.istft(r1, i1, hop=64, length=300, device="cpu").shape == (300,)
    assert gt.istft(r1, i1, hop=64, length=3000, device="cpu").shape == (3000,)


@pytest.mark.parametrize("kw", [
    dict(nperseg=128), dict(nperseg=256, noverlap=192, window="hamming"),
    dict(nperseg=128, nfft=512), dict(nperseg=128, boundary=None, padded=False),
    dict(nperseg=64, noverlap=0, window=("kaiser", 6.0)),
], ids=str)
def test_stft_scipy_istft_scipy_match_jax_and_scipy(kw):
    x = _signal(5, 3000)
    f, t, (zr, zi) = gt.stft_scipy(x, fs=10.0, device="cpu", **kw)
    jf, jt, (jzr, jzi) = gf.stft_scipy(x, fs=10.0, **kw)
    assert np.array_equal(f, jf) and np.array_equal(t, jt)
    assert _rel((zr, zi), (jzr, jzi)) <= 1e-5
    sf, st, sz = scipy.signal.stft(x.astype(np.float64), fs=10.0, **kw)
    assert np.abs(zr + 1j * zi - sz).max() <= 2e-3 * np.abs(sz).max()
    inv = {k: v for k, v in kw.items() if k in ("nperseg", "noverlap", "window")}
    boundary = kw.get("boundary", "zeros") is not None
    tt, y = gt.istft_scipy(zr, zi, fs=10.0, boundary=boundary, device="cpu", **inv)
    jtt, jy = gf.istft_scipy(jzr, jzi, fs=10.0, boundary=boundary, **inv)
    assert np.array_equal(tt, jtt) and np.abs(y - jy).max() <= 2e-3


def test_stft_contracts():
    for fn in (gt.stft, gf.stft):
        kw = dict(device="cpu") if fn is gt.stft else {}
        with pytest.raises(ValueError):
            fn(np.zeros(100, np.float32), 100, **kw)  # not a power of two
        with pytest.raises(ValueError):
            fn(np.zeros(10, np.float32), 64, **kw)  # shorter than one frame
        with pytest.raises(ValueError):
            fn(np.zeros(512, np.float32), 64, window="bogus", **kw)
    with pytest.raises(ValueError):
        gt.istft(np.zeros((4, 33), np.float32), np.zeros((4, 32), np.float32), device="cpu")
    with pytest.raises(ValueError):
        gt.stft_scipy(np.zeros(512, np.float32), nperseg=64, noverlap=64, device="cpu")


@pytest.mark.parametrize("window,nperseg,noverlap", [
    ("hann", 256, 128), ("hann", 256, 64), ("hamming", 100, 50), ("boxcar", 64, 0),
    (np.hanning(64), 64, 16),
], ids=str)
def test_cola_nola_and_dual_windows_match_jax(window, nperseg, noverlap):
    assert tstft.check_COLA(window, nperseg, noverlap) == jstft.check_COLA(window, nperseg, noverlap)
    assert tstft.check_NOLA(window, nperseg, noverlap) == jstft.check_NOLA(window, nperseg, noverlap)
    win = tstft._check_window_f64(window, nperseg)
    hop = nperseg - noverlap
    for scaled in (True, False):
        try:
            want = jstft.closest_STFT_dual_window(win, hop, scaled=scaled)
        except ValueError:
            with pytest.raises(ValueError):
                tstft.closest_STFT_dual_window(win, hop, scaled=scaled)
            continue
        got = tstft.closest_STFT_dual_window(win, hop, scaled=scaled)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


# ── Spectrograms ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("kw", [dict(hop=64), dict(hop=None, window="hann"),
                                dict(hop=100, one_sided=False, window=("kaiser", 5.0))], ids=str)
def test_spectrogram_matches_jax(kw):
    x = _signal(7, 4000)
    got = gt.spectrogram(x, 256, device="cpu", **kw)
    assert _rel(got, gf.spectrogram(x, 256, **kw)) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(), dict(nperseg=128, noverlap=64, window="hann"), dict(scaling="spectrum", detrend=False),
    dict(nperseg=128, nfft=512, detrend="linear"), dict(mode="magnitude"), dict(mode="complex"),
], ids=str)
def test_spectrogram_scipy_matches_jax_and_scipy(kw):
    x = _signal(11, 4096)
    f, t, got = gt.spectrogram_scipy(x, fs=100.0, device="cpu", **kw)
    jf, jt, want = gf.spectrogram_scipy(x, fs=100.0, **kw)
    assert np.array_equal(f, jf) and np.array_equal(t, jt)
    assert _rel(got, want) <= 1e-5
    sf, st, ref = scipy.signal.spectrogram(x, fs=100.0, **kw)
    got = got[0] + 1j * got[1] if kw.get("mode") == "complex" else got
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


# ── The Welch family ─────────────────────────────────────────────────────────


WELCH_CASES = [
    dict(nperseg=256), dict(nperseg=256, window="hamming", scaling="spectrum"),
    dict(nperseg=128, noverlap=96), dict(nperseg=128, noverlap=96, detrend=False),
    dict(nperseg=256, detrend="linear"), dict(nperseg=256, average="median"),
    dict(nperseg=256, nfft=1024), dict(nperseg=256, window=("kaiser", 12.0)),
    dict(nperseg=64, noverlap=7, window="flattop"),
]


@pytest.mark.parametrize("kw", WELCH_CASES, ids=str)
@pytest.mark.parametrize("channels", [None, 3])
def test_welch_matches_jax_and_scipy(kw, channels):
    shape = (4096,) if channels is None else (channels, 2048)
    x = _signal(13, *shape) + np.float32(2.0)
    f, p = gt.welch(x, fs=200.0, device="cpu", **kw)
    jf, jp = gf.welch(x, fs=200.0, **kw)
    assert np.array_equal(f, jf) and _rel(p, jp) <= 1e-4
    sf, sp = scipy.signal.welch(x, fs=200.0, axis=-1, **kw)
    assert np.abs(p - sp).max() <= 2e-3 * np.abs(sp).max()


@pytest.mark.parametrize("kw", [dict(nperseg=256), dict(nperseg=128, nfft=512),
                                dict(nperseg=256, detrend="linear", scaling="spectrum")], ids=str)
def test_csd_coherence_match_jax_and_scipy(kw):
    x, y = _signal(17, 4096), _signal(19, 4096)
    y = (0.5 * x + y).astype(np.float32)
    f, (pr, pi) = gt.csd(x, y, fs=100.0, device="cpu", **kw)
    jf, (jpr, jpi) = gf.csd(x, y, fs=100.0, **kw)
    assert np.array_equal(f, jf) and _rel((pr, pi), (jpr, jpi)) <= 1e-4
    sf, sp = scipy.signal.csd(x, y, fs=100.0, **kw)
    assert np.abs(pr + 1j * pi - sp).max() <= 2e-3 * np.abs(sp).max()
    f, c = gt.coherence(x, y, fs=100.0, nperseg=kw["nperseg"], device="cpu")
    jf, jc = gf.coherence(x, y, fs=100.0, nperseg=kw["nperseg"])
    assert np.array_equal(f, jf) and np.abs(c - jc).max() <= 1e-3
    assert np.abs(c - scipy.signal.coherence(x, y, fs=100.0, nperseg=kw["nperseg"])[1]).max() <= 1e-3
    _, p = gt.welch(x, nperseg=128, device="cpu")
    _, (sr, si) = gt.csd(x, x, nperseg=128, device="cpu")
    assert np.abs(sr - p).max() <= 1e-6 * np.abs(p).max() and np.abs(si).max() <= 1e-6 * np.abs(p).max()


@pytest.mark.parametrize("n", [256, 999, 1000])
@pytest.mark.parametrize("kw", [dict(), dict(scaling="spectrum"), dict(window="hann"),
                                dict(detrend="linear"), dict(detrend=False)], ids=str)
def test_periodogram_matches_jax_and_scipy(n, kw):
    x = _signal(n, n) + np.float32(0.5)
    f, p = gt.periodogram(x, fs=50.0, device="cpu", **kw)
    jf, jp = gf.periodogram(x, fs=50.0, **kw)
    assert np.array_equal(f, jf) and _rel(p, jp) <= 2e-4
    sf, sp = scipy.signal.periodogram(x, fs=50.0, **kw)
    assert np.abs(p - sp).max() <= 2e-4 * np.abs(sp).max()


def test_lombscargle_matches_jax_and_scipy():
    rng = np.random.default_rng(23)
    t = np.sort(rng.uniform(0, 10, 300))
    y = np.sin(2 * np.pi * 1.3 * t) + 0.1 * rng.standard_normal(300)
    w = np.linspace(0.1, 20.0, 500)
    for kw in (dict(), dict(precenter=True, normalize=True)):
        got = gt.lombscargle(t, y, w, **kw)
        assert np.array_equal(got, gf.lombscargle(t, y, w, **kw))
        assert np.abs(got - scipy.signal.lombscargle(t, y, w, **kw)).max() <= 1e-9 * np.abs(got).max()


def test_spectral_family_contracts():
    x = np.zeros(512, np.float32)
    for call in (
        lambda: gt.csd(x, np.zeros(256, np.float32), device="cpu"),
        lambda: gt.coherence(x, np.zeros(256, np.float32), device="cpu"),
        lambda: gt.periodogram(np.zeros(1, np.float32), device="cpu"),
        lambda: gt.periodogram(x, scaling="bogus", device="cpu"),
        lambda: gt.welch(np.zeros(1024, np.float32), nperseg=100, device="cpu"),
        lambda: gt.welch(np.zeros(1024, np.float32), nperseg=128, noverlap=128, device="cpu"),
        lambda: gt.welch(np.zeros(1024, np.float32), average="mode", device="cpu"),
        lambda: gt.welch(np.ones(1024, np.float32), detrend="quadratic", device="cpu"),
        lambda: gt.welch(np.zeros(16, np.float32), nperseg=64, device="cpu"),
        lambda: gt.spectrogram_scipy(np.ones(4096, np.float32), mode="angle", device="cpu"),
        lambda: gt.spectrogram(np.ones(100, np.float32), 100, device="cpu"),
    ):
        with pytest.raises(ValueError):
            call()


# ── Gradients through the estimators (tests/test_autodiff.py:124) ────────────


def _estimator_losses(lib, fns):
    return {
        "stft": lambda v: lib.sum(sum(q**2 for q in fns.stft_device(v.reshape(1, -1), 256, 64))),
        "welch": lambda v: lib.sum(fns.welch_device(v, fs=1.0, nperseg=256)[1]),
        "spectrogram": lambda v: lib.sum(fns.spectrogram_device(v, 256, 64)),
        "csd": lambda v: lib.sum(fns.csd_device(v, v[::-1] * 1.0, nperseg=256)[1][0]),
        "periodogram": lambda v: lib.sum(fns.periodogram_device(v[:4000], window="hann")[1]),
        "istft": lambda v: lib.sum(
            fns.istft_device(*fns.stft_device(v, 256, 64), hop=64, length=4096) * v),
    }


@pytest.fixture(scope="module")
def jax_estimator_grads():
    x = _signal(29, 4096)
    losses = _estimator_losses(jnp, gf)
    losses["csd"] = lambda v: jnp.sum(gf.csd_device(v, v[::-1] * 1.0, nperseg=256)[1][0])
    return {k: np.asarray(jax.grad(f)(jnp.asarray(x))) for k, f in losses.items()}


@pytest.mark.parametrize("name", ["stft", "welch", "spectrogram", "csd", "periodogram", "istft"])
def test_estimator_gradients_match_jax_and_central_differences(jax_estimator_grads, name):
    x, d = _signal(29, 4096), _signal(31, 4096)
    losses = _estimator_losses(torch, gt)
    losses["csd"] = lambda v: torch.sum(gt.csd_device(v, torch.flip(v, (0,)), nperseg=256)[1][0])
    loss = losses[name]
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(loss(xt), xt)
    assert bool(torch.isfinite(g).all())
    assert _rel(g.numpy(), jax_estimator_grads[name]) <= 1e-5
    eps = 1e-2
    dt = torch.from_numpy(d)
    with torch.no_grad():
        fd = (float(loss(xt + eps * dt)) - float(loss(xt - eps * dt))) / (2 * eps)
    an = float(np.vdot(g.numpy().astype(np.float64), d.astype(np.float64)))
    assert abs(fd - an) / max(1.0, abs(an)) < 5e-3
