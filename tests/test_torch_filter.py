"""The port's FIR filtering (``gpu_fft_tpu_torch/ops/filter.py``) against
the JAX package's (``gpu_fft_tpu/ops/filter.py``) on the CPU.

The same seeded numpy inputs go through both packages.  The device paths
(overlap-add, fftfilt, filtfilt_fir, FIRStream) are held to
``tests/test_filter.py``'s gates, 2e-3 of max(1, max|ref|) (filtfilt 5e-3),
against the JAX package and against scipy.  The host designs are f64 numpy
in both packages and must agree to 1e-12; the responses that ride the f32
exact transform (freqz, sosfreqz, freqz_fir) and savgol_filter's f32
convolution to 1e-5 of max|JAX|.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.ops import filter as tfilt
from gpu_fft_tpu_torch.tuning import get_tuning


def _signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(got, want):
    """max |got - want| over max(1, max|want|): test_filter.py's scale."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# ── Overlap-add ──────────────────────────────────────────────────────────────


def test_block_rule_reads_the_tuning_row():
    assert get_tuning().oa_block_min == 16384
    assert tfilt._best_block_fft_size(33) == 16384
    assert tfilt._best_block_fft_size(8193) == 32768  # grown to keep the tail in one hop


@pytest.mark.parametrize("n,lh", [(2000, 33), (20000, 64), (50000, 257), (5000, 1)])
def test_oaconvolve_default_block_matches_jax(n, lh):
    """The default block (16,384): several blocks at n = 20,000 and 50,000,
    the single-block branch below."""
    x, h = _signal(n, n), _signal(lh, lh)
    got = gt.oaconvolve(x, h, device="cpu")
    assert _err(got, gf.oaconvolve(x, h)) < 2e-3
    assert _err(got, scipy.signal.oaconvolve(x.astype(np.float64), h.astype(np.float64))) < 2e-3


@pytest.mark.parametrize("block", [256, 1024, 4096])
def test_oaconvolve_explicit_block_matches_jax(block):
    x, h = _signal(12000, 12000), _signal(50, 50)
    got = gt.oaconvolve(x, h, block=block, device="cpu")
    assert _err(got, gf.oaconvolve(x, h, block=block)) < 2e-3
    assert _err(got, np.convolve(x.astype(np.float64), h.astype(np.float64))) < 2e-3


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("la,lb", [(3000, 41), (50, 4000), (40, 7)])
def test_oaconvolve_modes_swap_and_single_block_match_jax(la, lb, mode):
    """scipy.signal.oaconvolve's mode shapes; (50, 4000) swaps the operands
    (the kernel is longer), (40, 7) takes the single-block branch."""
    x, h = _signal(la, la), _signal(lb + 1, lb)
    got = gt.oaconvolve(x, h, mode=mode, device="cpu")
    assert _err(got, gf.oaconvolve(x, h, mode=mode)) < 2e-3
    assert _err(got, scipy.signal.oaconvolve(x.astype(np.float64), h.astype(np.float64), mode=mode)) < 2e-3


@pytest.mark.parametrize("xshape,hshape", [((3, 8000), (65,)), ((2, 6000), (2, 33)), ((1, 30000), (3, 20))],
                         ids=str)
def test_oaconvolve_device_batched_matches_jax(xshape, hshape):
    x, h = _signal(1, *xshape), _signal(2, *hshape)
    got = tfilt.oaconvolve_device(torch.from_numpy(x), torch.from_numpy(h), block=1024).numpy()
    want = np.asarray(gf.oaconvolve_device(x, h, block=1024))
    assert _err(got, want) < 2e-3
    rows = max(x.shape[0], np.atleast_2d(h).shape[0])
    hh = np.atleast_2d(h)
    for i in range(rows):
        ref = np.convolve(x[min(i, x.shape[0] - 1)].astype(np.float64), hh[min(i, hh.shape[0] - 1)].astype(np.float64))
        assert _err(got[i], ref) < 2e-3


def test_oaconvolve_contract_errors():
    with pytest.raises(ValueError, match="block"):
        gt.oaconvolve(np.ones(5000), np.ones(100), block=128, device="cpu")
    with pytest.raises(ValueError, match="block"):
        gt.oaconvolve(np.ones(5000), np.ones(100), block=1000, device="cpu")
    with pytest.raises(ValueError):
        gt.oaconvolve(np.ones((2, 5)), np.ones(3), device="cpu")
    with pytest.raises(ValueError):
        gt.oaconvolve(np.ones(5), np.ones(3), mode="nope", device="cpu")
    with pytest.raises(ValueError, match="batch sizes"):
        tfilt.oaconvolve_device(torch.ones(2, 50), torch.ones(3, 5))


# ── fftfilt, filtfilt_fir ────────────────────────────────────────────────────


def test_fftfilt_matches_jax_and_lfilter():
    x = _signal(3, 5000)
    h = gf.firwin(51, 0.2).astype(np.float32)
    got = gt.fftfilt(x, h, device="cpu")
    assert _err(got, gf.fftfilt(x, h)) < 2e-3
    assert _err(got, scipy.signal.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))) < 2e-3


def test_fftfilt_device_batched_matches_jax():
    x = _signal(4, 4, 3000)
    h = gf.firwin(31, 0.35).astype(np.float32)
    got = gt.fftfilt_device(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert got.shape == x.shape
    assert _err(got, np.asarray(gf.fftfilt_device(x, h))) < 2e-3


@pytest.mark.parametrize("padlen", [None, 0, 17])
def test_filtfilt_fir_matches_jax(padlen):
    x = _signal(5, 4000)
    h = gf.firwin(21, 0.25).astype(np.float32)
    got = gt.filtfilt_fir(x, h, padlen=padlen, device="cpu")
    assert _err(got, gf.filtfilt_fir(x, h, padlen=padlen)) < 5e-3
    if padlen != 0:  # scipy starts both passes from steady state; the packages from rest
        ref = scipy.signal.filtfilt(h.astype(np.float64), [1.0], x.astype(np.float64),
                                    padlen=3 * h.size if padlen is None else padlen)
        assert _err(got, ref) < 5e-3
    with pytest.raises(ValueError, match="padlen"):
        gt.filtfilt_fir(x[:50], h, device="cpu")


# ── FIRStream ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("chunk,taps", [(512, 33), (256, 257), (128, 300), (1024, 2), (300, 1)])
def test_firstream_matches_jax_chunk_by_chunk(chunk, taps):
    """Each chunk's output and the carried state against the JAX
    FIRStream's; the concatenation against scipy's lfilter.  Taps shorter
    and longer than the chunk."""
    h, x = _signal(taps, taps), _signal(chunk, 8 * chunk)
    ours, theirs = tfilt.FIRStream(h, chunk=chunk, device="cpu"), gf.FIRStream(h, chunk=chunk)
    st, jst = ours.init(), theirs.init()
    outs = []
    for i in range(8):
        piece = x[i * chunk : (i + 1) * chunk]
        st, y = ours.step(st, torch.from_numpy(piece))
        jst, jy = theirs.step(jst, piece)
        assert _err(y.numpy(), np.asarray(jy)) < 2e-3
        assert _err(st.numpy(), np.asarray(jst)) < 2e-3
        outs.append(y.numpy())
    ref = scipy.signal.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))
    assert _err(np.concatenate(outs), ref) < 2e-3


def test_firstream_batched_and_autograd():
    """(batch, chunk) rows stream independently; the step is out of place,
    so a gradient flows through it to the chunk and the state."""
    h = _signal(6, 65)
    x = _signal(7, 3, 4 * 200)
    stream = tfilt.FIRStream(h, chunk=200, batch=3, device="cpu")
    st = stream.init()
    outs = []
    for i in range(4):
        st, y = stream.step(st, torch.from_numpy(x[:, i * 200 : (i + 1) * 200]))
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=1)
    for r in range(3):
        ref = scipy.signal.lfilter(h.astype(np.float64), [1.0], x[r].astype(np.float64))
        assert _err(got[r], ref) < 2e-3
    xin = torch.from_numpy(x[:, :200]).requires_grad_(True)
    s0 = torch.from_numpy(_signal(8, 3, 64)).requires_grad_(True)
    st, y = stream.step(s0, xin)
    (y.sum() + st.sum()).backward()
    # d(sum y + sum carry)/dx = sum of the taps for every sample; d/ds = 1
    # on the overlapped head.
    assert torch.allclose(xin.grad, torch.full_like(xin, float(h.sum())), atol=1e-4)
    assert torch.allclose(s0.grad, torch.ones_like(s0))


def test_firstream_contract_errors():
    with pytest.raises(ValueError):
        tfilt.FIRStream(np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError):
        tfilt.FIRStream(np.ones(4), chunk=0, device="cpu")
    stream = tfilt.FIRStream(np.ones(4, np.float32), chunk=16, batch=2, device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        stream.step(stream.init(), torch.zeros(2, 15))
    assert stream.init().device.type == "cpu"


# ── Host designs: f64 numpy in both packages ─────────────────────────────────


@pytest.mark.parametrize("args,kw", [
    ((11, 0.4), {}), ((65, 0.3), {}), ((64, 0.3), {}), ((63, 0.35), {"pass_zero": False}),
    ((81, [0.2, 0.5]), {"pass_zero": False}), ((81, [0.2, 0.5]), {}), ((51, 0.3), {"window": "blackman"}),
    ((51, 0.3), {"window": ("kaiser", 6.0)}), ((51, 1000.0), {"fs": 8000.0, "scale": False}),
    ((31, 0.3), {"pass_zero": "lowpass"}), ((31, 0.3), {"pass_zero": "highpass"}),
    ((65, [0.2, 0.5]), {"pass_zero": "bandpass"}), ((65, [0.2, 0.5]), {"pass_zero": "bandstop"}),
    ((33, 0.4), {"window": None}), ((33, 0.4), {"window": "rect"}),
], ids=str)
def test_firwin_matches_jax(args, kw):
    got = gt.firwin(*args, **kw)
    assert np.abs(got - gf.firwin(*args, **kw)).max() <= 1e-12
    scipy_kw = {**kw, "window": "boxcar"} if kw.get("window", "hamming") in (None, "rect") else kw
    assert np.abs(got - scipy.signal.firwin(*args, **scipy_kw)).max() < 1e-12


@pytest.mark.parametrize("numtaps,freq,gain,kw", [
    (65, [0.0, 0.3, 0.3, 1.0], [1.0, 1.0, 0.0, 0.0], {}),
    (64, [0.0, 0.5, 1.0], [1.0, 0.5, 0.0], {}),
    (33, [0.0, 0.5, 1.0], [0.0, 1.0, 0.0], {"antisymmetric": True}),
    (34, [0.0, 0.5, 1.0], [0.0, 1.0, 1.0], {"antisymmetric": True, "window": "hann"}),
    (41, [0.0, 100.0, 250.0, 500.0], [1.0, 1.0, 0.2, 0.0], {"fs": 1000.0, "nfreqs": 257}),
], ids=str)
def test_firwin2_matches_jax(numtaps, freq, gain, kw):
    got = gt.firwin2(numtaps, freq, gain, **kw)
    assert np.abs(got - gf.firwin2(numtaps, freq, gain, **kw)).max() <= 1e-12
    assert np.abs(got - scipy.signal.firwin2(numtaps, freq, gain, **kw)).max() < 1e-12


def test_kaiser_helpers_match_jax():
    for a in (10.0, 21.0, 30.0, 50.0, 60.0, 100.0):
        assert gt.kaiser_beta(a) == gf.kaiser_beta(a)
    assert gt.kaiser_atten(81, 0.1) == gf.kaiser_atten(81, 0.1)
    for ripple, width in ((60.0, 0.1), (40.0, 0.05), (-80.0, 0.02)):
        assert gt.kaiserord(ripple, width) == gf.kaiserord(ripple, width)
    with pytest.raises(ValueError):
        gt.kaiserord(5.0, 0.1)


@pytest.mark.parametrize("wl,poly,kw", [(5, 2, {}), (11, 3, {"deriv": 1}), (7, 2, {"pos": 2, "use": "dot"}),
                                        (9, 4, {"deriv": 2, "delta": 0.5}), (6, 2, {})], ids=str)
def test_savgol_coeffs_match_jax(wl, poly, kw):
    got = gt.savgol_coeffs(wl, poly, **kw)
    assert np.abs(got - gf.savgol_coeffs(wl, poly, **kw)).max() <= 1e-12


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "constant", "wrap"])
def test_savgol_filter_matches_jax(mode):
    x = _signal(9, 3, 400).astype(np.float64)
    got = gt.savgol_filter(x, 11, 3, mode=mode, device="cpu")
    assert _rel(got, gf.savgol_filter(x, 11, 3, mode=mode)) < 1e-5
    assert _rel(got, scipy.signal.savgol_filter(x, 11, 3, mode=mode)) < 1e-5
    d = gt.savgol_filter(x.T, 9, 2, deriv=1, axis=0, mode=mode, device="cpu")
    assert _rel(d, gf.savgol_filter(x.T, 9, 2, deriv=1, axis=0, mode=mode)) < 1e-5


@pytest.mark.parametrize("whole", [False, True])
def test_freqz_sosfreqz_match_jax(whole):
    b, a = gf.butter(4, 0.3)
    w, hr, hi = gt.freqz(b, a, worN=256, whole=whole, device="cpu")
    jw, jr, ji = gf.freqz(b, a, worN=256, whole=whole)
    assert np.array_equal(w, jw)
    assert _rel(hr + 1j * hi, jr + 1j * ji) < 1e-5
    _, ref = scipy.signal.freqz(b, a, worN=256, whole=whole)
    assert _rel(hr + 1j * hi, ref) < 1e-5
    sos = gf.butter(6, [0.2, 0.4], btype="bandpass", output="sos")
    w, hr, hi = gt.sosfreqz(sos, worN=300, whole=whole, device="cpu")
    _, jr, ji = gf.sosfreqz(sos, worN=300, whole=whole)
    assert _rel(hr + 1j * hi, jr + 1j * ji) < 1e-5
    w2, h2 = gt.freqz_sos(sos, worN=300, whole=whole, device="cpu")
    assert np.array_equal(w2, w) and np.array_equal(h2, hr + 1j * hi)
    with pytest.raises(ValueError):
        gt.freqz(b, a, worN=0, device="cpu")


@pytest.mark.parametrize("n,taps", [(512, 65), (64, 300), (100, 33)])
def test_freqz_fir_matches_jax(n, taps):
    """Taps longer than 2n fold mod 2n (64, 300); a non-power-of-two grid
    (100) takes the exact transform."""
    h = gf.firwin(taps, 0.3)
    w, hr, hi = gt.freqz_fir(h, n, device="cpu")
    jw, jr, ji = gf.freqz_fir(h, n)
    assert np.array_equal(w, jw)
    assert _rel(hr + 1j * hi, jr + 1j * ji) < 1e-5
    _, ref = scipy.signal.freqz(h, worN=n)
    assert _rel(hr + 1j * hi, ref) < 1e-5


@pytest.mark.parametrize("w,whole", [(512, False), (300, True)])
def test_group_delay_matches_jax(w, whole):
    system = gf.butter(4, 0.3)
    got = gt.group_delay(system, w=w, whole=whole)
    want = gf.group_delay(system, w=w, whole=whole)
    assert np.array_equal(got[0], want[0]) and np.abs(got[1] - want[1]).max() <= 1e-12
    long_fir = (gf.firwin(701, 0.2), [1.0])  # longer than the grid: folds
    assert np.abs(gt.group_delay(long_fir, w=128)[1] - gf.group_delay(long_fir, w=128)[1]).max() <= 1e-9


@pytest.mark.parametrize("taps,half,n_fft", [(31, True, None), (32, False, None), (51, True, 64), (21, False, 63)],
                         ids=str)
def test_minimum_phase_matches_jax(taps, half, n_fft):
    h = gf.firwin(taps, 0.3)
    got = gt.minimum_phase(h, n_fft, half=half)
    assert np.abs(got - gf.minimum_phase(h, n_fft, half=half)).max() <= 1e-12
    with pytest.raises(ValueError):
        gt.minimum_phase(h, 4)


@pytest.mark.parametrize("kw", [
    {"hsize": (5, 7), "window": ("hamming", "hann"), "fc": 0.3},
    {"hsize": (9, 9), "window": "hamming", "fc": 0.4, "circular": True},
], ids=str)
def test_firwin_2d_matches_jax(kw):
    assert np.abs(gt.firwin_2d(**kw) - gf.firwin_2d(**kw)).max() <= 1e-12
    with pytest.raises(ValueError):
        gt.firwin_2d((5,), "hamming", fc=0.3)


def test_choose_conv_method_matches_jax():
    for a, b in (((10,), (5,)), ((1000,), (100,)), ((100,), (20,)), ((64, 64), (5, 5))):
        x, k = np.ones(a), np.ones(b)
        assert gt.choose_conv_method(x, k) == gf.choose_conv_method(x, k)
    method, times = gt.choose_conv_method(np.ones(300), np.ones(30), measure=True, device="cpu")
    assert method in ("fft", "direct") and set(times) == {"fft", "direct"}
    # 2-D inputs are timed through fft_convolve2d, as in the JAX package.
    method, times = gt.choose_conv_method(np.ones((8, 8)), np.ones((3, 3)), measure=True, device="cpu")
    _, jtimes = gf.choose_conv_method(np.ones((8, 8)), np.ones((3, 3)), measure=True)
    assert method in ("fft", "direct") and set(times) == set(jtimes) == {"fft", "direct"}
