"""Each reference against numpy.fft / scipy.signal.welch at tiny sizes, on
the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.signal
import torch

from portbench.reference import dft, fft, fft2, welch


def _rows(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n", [2, 8, 512, 1024, 4096, 1 << 14])
def test_dft_rows_is_numpy_fft(n):
    x = _rows((3, n)) + 1j * _rows((3, n), 1)
    yr, yi = dft.dft_rows(x.real.contiguous(), x.imag.contiguous(), -1, torch.float64)
    want = np.fft.fft(x.numpy().astype(np.complex128), axis=-1)
    got = yr.numpy() + 1j * yi.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


@pytest.mark.parametrize("shape", [(4, 4096), (2, 1 << 15), (1, 256)])
def test_fft_reference(shape):
    x = _rows(shape)
    yr, yi = fft.reference(x, {}, "float64")
    want = np.fft.fft(x.numpy().astype(np.float64), axis=-1)
    assert np.abs(yr.numpy() + 1j * yi.numpy() - want).max() / np.abs(want).max() < 1e-13
    assert fft.judge((yr.float(), yi.float()), (yr, yi))["rel_err"] < 1e-6


@pytest.mark.parametrize("shape", [(1, 64, 128), (3, 32, 32), (2, 1024, 16)])
def test_fft2_reference(shape):
    x = _rows(shape)
    yr, yi = fft2.reference(x, {}, "float64")
    want = np.fft.fft2(x.numpy().astype(np.float64))
    assert np.abs(yr.numpy() + 1j * yi.numpy() - want).max() / np.abs(want).max() < 1e-13


@pytest.mark.parametrize("params", [
    {"nperseg": 256, "noverlap": 128},
    {"nperseg": 512, "noverlap": 384, "detrend": "linear", "scaling": "spectrum"},
    {"nperseg": 256, "noverlap": 0, "window": "hamming", "fs": 48000.0, "average": "median"},
    {"nperseg": 128, "noverlap": 64, "window": None, "detrend": False},
])
def test_welch_reference_is_scipy(params):
    x = _rows((3, 1 << 13))
    got = welch.reference(x, params, "float64").numpy()
    window = params.get("window", "hann")
    _, want = scipy.signal.welch(
        x.numpy().astype(np.float64), fs=params.get("fs", 1.0),
        window="boxcar" if window is None else window, nperseg=params["nperseg"],
        noverlap=params["noverlap"], detrend=params.get("detrend", "constant"),
        scaling=params.get("scaling", "density"), average=params.get("average", "mean"), axis=-1)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_lower_precision_reads_higher():
    x = _rows((2, 1 << 14))
    want = fft.reference(x, {}, "float64")
    low = fft.judge(fft.reference(x, {}, "float32"), want)["rel_err"]
    assert 1e-8 < low < 1e-5


def test_unknown_precision_is_refused():
    with pytest.raises(ValueError):
        with dft.precision("bf16"):
            pass
