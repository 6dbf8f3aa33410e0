"""The port's DSP ops (``gpu_fft_tpu_torch/ops/dsp.py``) against the JAX
package's (``gpu_fft_tpu/ops/dsp.py``) on the CPU.

The same seeded numpy inputs go through both packages.  The gates are the
JAX package's own tests' (``tests/test_dsp.py``,
``tests/test_analysis_ops.py``), relative to max |JAX| where those are
relative; every case also holds the port against the numpy / scipy
reference with the same gate.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.ops import dsp as tdsp


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ── Convolution and correlation ──────────────────────────────────────────────


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("la,lb", [(100, 7), (1000, 33), (513, 512), (4000, 97)])
def test_fft_convolve_matches_jax(la, lb, mode):
    """test_dsp.py's gate: 1e-5 of max|ref|."""
    a, b = _signal(la, la), _signal(lb, lb)
    got = gt.fft_convolve(a, b, mode=mode, device="cpu")
    assert _rel(got, gf.fft_convolve(a, b, mode=mode)) < 1e-5
    assert _rel(got, np.convolve(a.astype(np.float64), b.astype(np.float64), mode=mode)) < 1e-5


@pytest.mark.parametrize("shapes", [((3, 300), (3, 40)), ((3, 300), (40,)), ((300,), (3, 40)), ((1, 2000), (1, 20))],
                         ids=str)
def test_fft_convolve_device_batched_and_broadcast(shapes):
    """A one-row operand broadcasts (its spectrum computed once); test_dsp.py's
    batched gate, 1e-5 of max(1, max|ref|)."""
    (sa, sb) = shapes
    a, b = _signal(1, *sa), _signal(2, *sb)
    got = tdsp.fft_convolve_device(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(gf.fft_convolve_device(a, b))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-5
    ra, rb = np.atleast_2d(a).astype(np.float64), np.atleast_2d(b).astype(np.float64)
    rows = max(ra.shape[0], rb.shape[0])
    ref = np.stack([np.convolve(ra[min(i, ra.shape[0] - 1)], rb[min(i, rb.shape[0] - 1)]) for i in range(rows)])
    assert np.abs(np.atleast_2d(got) - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


def test_fft_convolve_device_one_dimensional_contract():
    out = tdsp.fft_convolve_device(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 1.0]))
    assert out.shape == (4,)
    assert np.allclose(out.numpy(), [1.0, 3.0, 5.0, 3.0], atol=1e-5)
    with pytest.raises(ValueError, match="batch sizes differ"):
        tdsp.fft_convolve_device(torch.zeros(2, 8), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="non-empty"):
        tdsp.fft_convolve_device(torch.zeros(2, 0), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        gt.fft_convolve([1.0, 2.0], [1.0, 2.0, 3.0], mode="valid", device="cpu")


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("la,lb", [(100, 30), (20, 50)])
def test_fft_correlate_matches_jax(la, lb, mode):
    """test_analysis_ops.py's gate: 2e-3 absolute.  numpy's 'same' with the
    longer second operand centres otherwise than the convolution both
    packages run; that case is held to the JAX package only."""
    a, b = _signal(la, la), _signal(lb + 1, lb)
    got = gt.fft_correlate(a, b, mode=mode, device="cpu")
    want = gf.fft_correlate(a, b, mode=mode)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-3
    if not (mode == "same" and la < lb):
        assert np.abs(got - np.correlate(a.astype(np.float64), b.astype(np.float64), mode=mode)).max() < 2e-3


# ── Analytic signal, envelope, resampling ────────────────────────────────────


@pytest.mark.parametrize("n", [256, 1000, 257, 4096, 1 << 17])
def test_hilbert_matches_jax(n):
    """test_analysis_ops.py's gate, 2e-3 absolute; at 2^17 K3's plain
    version (the JAX side in interpret mode) and the staged path run."""
    x = _signal(n, n)
    ar, ai = gt.hilbert(x, device="cpu")
    jr, ji = gf.hilbert(x)
    assert np.abs(ar - jr).max() < 2e-3 and np.abs(ai - ji).max() < 2e-3
    ref = scipy.signal.hilbert(x.astype(np.float64))
    assert np.abs(ar - ref.real).max() < 2e-3 and np.abs(ai - ref.imag).max() < 2e-3


def test_hilbert_and_envelope_device_batched():
    x = _signal(3, 3, 512)
    ar, ai = gt.hilbert_device(torch.from_numpy(x))
    jr, ji = gf.hilbert_device(x)
    assert np.abs(ai.numpy() - np.asarray(ji)).max() < 2e-3
    env = gt.envelope_device(torch.from_numpy(x)).numpy()
    assert np.abs(env - np.asarray(gf.envelope_device(x))).max() < 1e-5
    assert np.abs(gt.envelope(x[0], device="cpu") - env[0]).max() < 1e-5


def test_envelope_recovers_amplitude_modulation():
    t = np.arange(2048) / 2048.0
    a = 1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    x = (a * np.cos(2 * np.pi * 200.0 * t)).astype(np.float32)
    env = gt.envelope(x, device="cpu")
    assert np.abs(env[200:-200] - a[200:-200]).max() < 2e-2
    assert np.abs(env - gf.envelope(x)).max() < 1e-5


@pytest.mark.parametrize(
    "n,num",
    [(128, 64), (128, 256), (100, 40), (100, 250), (101, 37), (101, 202), (64, 63), (4096, 2048),
     (2048, 4096), (1000, 1024), (1024, 1000), (4410, 4800)],
)
def test_resample_matches_jax(n, num):
    """Up and down, a power-of-two target (``inverse_real``, scale 1/n) and
    any other (the exact inverse times num/n), even and odd n;
    test_analysis_ops.py's gate, 3e-3 absolute."""
    x = _signal(n + num, n)
    got = gt.resample(x, num, device="cpu")
    assert got.shape == (num,)
    assert np.abs(got - gf.resample(x, num)).max() < 3e-3
    assert np.abs(got - scipy.signal.resample(x.astype(np.float64), num)).max() < 3e-3


def test_resample_batched_identity_and_contracts():
    x = _signal(4, 4, 96)
    same = gt.resample_device(torch.from_numpy(x), 96).numpy()
    assert np.abs(same - x).max() < 2e-3
    up = gt.resample_device(torch.from_numpy(x), 192).numpy()
    assert np.abs(up - np.asarray(gf.resample_device(x, 192))).max() < 3e-3
    with pytest.raises(ValueError):
        gt.resample(np.zeros(16, np.float32), 0, device="cpu")
    with pytest.raises(ValueError):
        gt.resample(np.zeros((2, 2, 2), np.float32), 4, device="cpu")


# ── Hermitian transforms and host helpers ────────────────────────────────────


@pytest.mark.parametrize("n", [16, 1024, 65536])
def test_hfft_ihfft_match_jax(n):
    """hfft against the JAX package's and numpy's (1e-5 of max|ref|);
    ihfft(hfft(a)) returns a."""
    h = n // 2 + 1
    ar, ai = _signal(n, h), _signal(n + 1, h)
    got = gt.hfft(ar, ai, device="cpu")
    assert _rel(got, gf.hfft(ar, ai)) < 1e-5
    assert _rel(got, np.fft.hfft(ar.astype(np.float64) + 1j * ai.astype(np.float64), n)) < 1e-5
    br, bi = gt.ihfft(got, device="cpu")
    jr, ji = gf.ihfft(got)
    assert _rel(br, jr) < 1e-5 and _rel(bi, ji) < 1e-5
    ai_ref = ai.copy()
    ai_ref[0] = ai_ref[-1] = 0.0
    assert np.abs(br - ar).max() < 1e-4 and np.abs(bi - ai_ref).max() < 1e-4


def test_hfft_ihfft_contracts():
    with pytest.raises(ValueError):
        gt.hfft(np.zeros(4, np.float32), np.zeros(5, np.float32), device="cpu")
    with pytest.raises(ValueError):
        gt.hfft(np.zeros(4, np.float32), np.zeros(4, np.float32), device="cpu")  # n = 6
    with pytest.raises(ValueError):
        gt.ihfft(np.zeros(6, np.float32), device="cpu")


@pytest.mark.parametrize("shape,axes", [((8,), None), ((7,), None), ((4, 6), None), ((4, 6), 1), ((5, 6), (0,))],
                         ids=str)
def test_shifts_match_numpy_on_tensors_and_arrays(shape, axes):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for ours, ref in ((tdsp.fftshift, np.fft.fftshift), (tdsp.ifftshift, np.fft.ifftshift)):
        assert np.array_equal(ours(torch.from_numpy(x), axes=axes).numpy(), ref(x, axes=axes))
        assert np.array_equal(ours(x, axes=axes), ref(x, axes=axes))
    assert np.array_equal(tdsp.ifftshift(tdsp.fftshift(torch.from_numpy(x), axes), axes).numpy(), x)


def test_fast_lengths_and_frequencies_match_jax():
    for t in (1, 2, 3, 1000, 1024, 1025):
        assert gt.next_fast_len(t) == gf.next_fast_len(t)
        if t >= 2:
            assert gt.prev_fast_len(t) == gf.prev_fast_len(t)
    for n, d in ((4, 0.25), (9, 1.0), (8, 0.125)):
        assert np.array_equal(tdsp.fftfreq(n, d), gf.fftfreq(n, d))
        assert np.array_equal(tdsp.rfftfreq(n, d), gf.rfftfreq(n, d))
    with pytest.raises(ValueError):
        gt.next_fast_len(0)
    with pytest.raises(ValueError):
        gt.prev_fast_len(1)


@pytest.mark.parametrize("kind,bp", [("linear", 0), ("constant", 0), ("linear", [30, 70])])
def test_detrend_matches_jax(kind, bp):
    x = _signal(9, 2, 100).astype(np.float64) + np.arange(100) * 0.3
    got = gt.detrend(x, axis=-1, type=kind, bp=bp)
    assert np.abs(got - gf.detrend(x, axis=-1, type=kind, bp=bp)).max() < 1e-12
    assert np.abs(got - scipy.signal.detrend(x, axis=-1, type=kind, bp=bp)).max() < 1e-10


def test_host_helpers_match_jax():
    for la, lb in ((10, 4), (4, 10), (7, 7)):
        for mode in ("full", "same", "valid"):
            assert np.array_equal(gt.correlation_lags(la, lb, mode), gf.correlation_lags(la, lb, mode))
    ev = np.random.default_rng(5).uniform(0, 10, 50)
    assert gt.vectorstrength(ev, 0.7) == gf.vectorstrength(ev, 0.7)
    s, p = gt.vectorstrength(ev, [0.5, 0.7])
    js, jp = gf.vectorstrength(ev, [0.5, 0.7])
    assert np.array_equal(s, js) and np.array_equal(p, jp)
    q, r = gt.deconvolve([1.0, 5.0, 7.0, 3.0, 2.0], [1.0, 2.0])
    jq, jr = gf.deconvolve([1.0, 5.0, 7.0, 3.0, 2.0], [1.0, 2.0])
    assert np.array_equal(q, jq) and np.array_equal(r, jr)
    grid = np.linspace(-3, 3, 31)
    assert np.array_equal(gt.gauss_spline(grid, 3), gf.gauss_spline(grid, 3))
    with pytest.raises(ValueError):
        gt.correlation_lags(3, 4, "nope")
