"""The port's IIR engine (``gpu_fft_tpu_torch/ops/iir.py``) against the JAX
package's block-state engine (``gpu_fft_tpu/ops/iir.py``) on the CPU.

The same seeded numpy inputs go through both packages, with
``tests/test_iir.py``'s gates: 2e-4 of max(1, max|ref|) for lfilter and its
state, 5e-4 for filtfilt / sosfilt, 5e-5 for sosfiltfilt, 1e-10 for the
host steady states (f64 in both).  The carry is a loop here and a
``lax.scan`` there: the tests reach one block, several, and a ragged last
block, and compare ``zf`` (the state at sample n, not a block's entry
state).
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import gpu_fft_tpu.ops.iir as jiir
import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.ops import iir as tiir


def _sig(n, seed=0, *lead):
    return np.random.default_rng(seed).standard_normal((*lead, n))


def _close(got, want, gate):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= gate * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("order", [1, 4, 6])
@pytest.mark.parametrize("n", [7, 100, 1024, 2048, 5000])
def test_lfilter_matches_jax(order, n):
    """n = 1,024: one block; 2,048: two whole blocks; 5,000: a ragged last
    block; 7 and 100: one short block."""
    b, a = ss.butter(order, 0.2)
    x = _sig(n, order)
    got = gt.lfilter(b, a, x, device="cpu")
    _close(got, jiir.lfilter(b, a, x), 2e-4)
    _close(got, ss.lfilter(b, a, x), 2e-4)


@pytest.mark.parametrize("n", [100, 1024, 2048, 3000])
def test_lfilter_zi_and_zf_match_jax(n):
    """With ``zi`` the final state ``zf`` is the state at sample n: after a
    whole last block (1,024, 2,048) and after a ragged one (100, 3,000)."""
    b, a = ss.butter(3, 0.25)
    x = _sig(n, 3)
    zi = ss.lfilter_zi(b, a) * x[0]
    y, zf = gt.lfilter(b, a, x, zi=zi, device="cpu")
    jy, jzf = jiir.lfilter(b, a, x, zi=zi)
    ry, rzf = ss.lfilter(b, a, x, zi=zi)
    _close(y, jy, 2e-4)
    _close(zf, jzf, 2e-4)
    _close(y, ry, 2e-4)
    _close(zf, rzf, 2e-4)


@pytest.mark.parametrize("split", [1, 777, 1024, 1999])
def test_streaming_equals_one_shot(split):
    b, a = ss.butter(4, 0.15)
    x = _sig(2000, 4)
    y1, zf = gt.lfilter(b, a, x[:split], zi=np.zeros(4), device="cpu")
    y2, _ = gt.lfilter(b, a, x[split:], zi=zf, device="cpu")
    _close(np.concatenate([y1, y2]), gt.lfilter(b, a, x, device="cpu"), 5e-4)


def test_lfilter_device_state_rows_and_block_override():
    """(R, k) ``zi`` rows on the device API, a block length that is not the
    default, the entry-state sequence against the JAX scan's."""
    b, a = ss.butter(2, 0.3)
    x = _sig(1500, 5, 3).astype(np.float32)
    zi = _sig(2, 6, 3).astype(np.float32)
    y, zf = tiir.lfilter_device(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi), block=256)
    jy, jzf = jiir.lfilter_device(b, a, x, zi=zi, block=256)
    _close(y.numpy(), np.asarray(jy), 2e-4)
    _close(zf.numpy(), np.asarray(jzf), 2e-4)
    ry, rzf = ss.lfilter(b, a, x.astype(np.float64), zi=zi.astype(np.float64))
    _close(y.numpy(), ry, 2e-4)
    _close(zf.numpy(), rzf, 2e-4)


def test_lfilter_pure_fir_scalar_and_k0():
    """k = 0 (a scalar gain: no state, empty zf) and a pure FIR."""
    x = _sig(300, 9)
    h = ss.firwin(9, 0.3)
    _close(gt.lfilter(h, [1.0], x, device="cpu"), jiir.lfilter(h, [1.0], x), 1e-5)
    _close(gt.lfilter([2.5], [0.5], x, device="cpu"), 5.0 * x, 1e-4)
    y, zf = gt.lfilter([2.5], [0.5], x, zi=np.zeros(0), device="cpu")
    jy, jzf = jiir.lfilter([2.5], [0.5], x, zi=np.zeros(0))
    _close(y, jy, 1e-6)
    assert zf.shape == np.asarray(jzf).shape == (0,)


def test_lfilter_axis_and_batch():
    b, a = ss.butter(2, 0.4)
    x = _sig(700, 10, 3)
    _close(gt.lfilter(b, a, x, axis=-1, device="cpu"), jiir.lfilter(b, a, x, axis=-1), 2e-4)
    _close(gt.lfilter(b, a, x.T, axis=0, device="cpu"), jiir.lfilter(b, a, x.T, axis=0), 2e-4)


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_filtfilt_matches_jax(padtype):
    b, a = ss.butter(4, 0.2)
    x = _sig(3000, 11, 2)
    got = gt.filtfilt(b, a, x, padtype=padtype, device="cpu")
    _close(got, jiir.filtfilt(b, a, x, padtype=padtype), 5e-4)
    _close(got, ss.filtfilt(b, a, x, padtype=padtype), 5e-4)


def test_sosfilt_with_and_without_zi_matches_jax():
    sos = ss.butter(6, 0.25, output="sos")
    x = _sig(2500, 12)
    _close(gt.sosfilt(sos, x, device="cpu"), jiir.sosfilt(sos, x), 5e-4)
    zi = ss.sosfilt_zi(sos) * x[0]
    y, zf = gt.sosfilt(sos, x, zi=zi, device="cpu")
    jy, jzf = jiir.sosfilt(sos, x, zi=zi)
    _close(y, jy, 5e-4)
    _close(zf, jzf, 5e-4)
    ry, rzf = ss.sosfilt(sos, x, zi=zi)
    _close(y, ry, 5e-4)
    _close(zf, rzf, 5e-4)


@pytest.mark.parametrize("order", [4, 8])
def test_sosfiltfilt_matches_jax(order):
    sos = ss.butter(order, 0.2, output="sos")
    x = _sig(1500, 20)
    got = gt.sosfiltfilt(sos, x, device="cpu")
    _close(got, jiir.sosfiltfilt(sos, x), 5e-5)
    _close(got, ss.sosfiltfilt(sos, x), 5e-5)
    x2 = np.stack([x, x[::-1]])
    _close(gt.sosfiltfilt(sos, x2, device="cpu"), ss.sosfiltfilt(sos, x2), 5e-5)
    with pytest.raises(ValueError):
        gt.sosfiltfilt(sos, x[:10], device="cpu")


def test_host_states_match_jax():
    for order in (1, 2, 5):
        b, a = ss.butter(order, 0.3)
        assert np.abs(gt.lfilter_zi(b, a) - jiir.lfilter_zi(b, a)).max() <= 1e-10
        sos = ss.butter(order, 0.2, output="sos")
        assert np.abs(gt.sosfilt_zi(sos) - jiir.sosfilt_zi(sos)).max() <= 1e-10
    b, a = ss.butter(3, 0.2)
    for y, x in (([1.0, 0.5, -0.2], None), ([1.0], [0.3, 0.1]), ([0.2, 0.1, 0.0, 0.5], [1.0, 2.0, 3.0, 4.0])):
        got = gt.lfiltic(b, a, y, x)
        assert np.abs(got - jiir.lfiltic(b, a, y, x)).max() <= 1e-12
        assert np.abs(got - ss.lfiltic(b, a, y, x)).max() <= 1e-10
    assert np.array_equal(gt.lfiltic([2.0], [2.0, 1.0], [1.0]), jiir.lfiltic([2.0], [2.0, 1.0], [1.0]))


def test_validation():
    with pytest.raises(ValueError):
        gt.lfilter([1.0], [0.0, 1.0], np.ones(10), device="cpu")
    with pytest.raises(ValueError):
        gt.lfilter([], [1.0], np.ones(10), device="cpu")
    with pytest.raises(ValueError):
        tiir.lfilter_device([1.0], [1.0, 0.5], torch.ones(2, 2, 2))
    with pytest.raises(ValueError):
        gt.filtfilt([1.0], [1.0, 0.5], np.ones(10), padtype="bogus", device="cpu")
    with pytest.raises(ValueError):
        gt.sosfilt(np.ones((2, 5)), np.ones(10), device="cpu")
