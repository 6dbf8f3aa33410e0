"""The port's windows (``gpu_fft_tpu_torch/ops/windows.py``, a numpy copy)
against the JAX package's, bit for bit: every family, symmetric and
periodic, odd and even lengths, ``get_window``'s names, tuples and
suffixes, ``dpss`` with its ratios, and the estimators' ``window_table``."""

import warnings

import numpy as np
import pytest

import gpu_fft_tpu.ops.stft as jstft
import gpu_fft_tpu.ops.windows as jw
import gpu_fft_tpu_torch.ops.stft as tstft
import gpu_fft_tpu_torch.ops.windows as tw
from gpu_fft_tpu_torch.signal import windows as tsw

NO_ARG = ["boxcar", "triang", "parzen", "bohman", "blackman", "nuttall", "blackmanharris",
          "flattop", "bartlett", "barthann", "hamming", "hann", "cosine", "lanczos"]
PARAM = [
    ("kaiser", (8.6,)), ("kaiser", (0.0,)), ("gaussian", (7.0,)),
    ("general_gaussian", (1.5, 5.0)), ("general_hamming", (0.7,)),
    ("general_cosine", ([0.4, 0.5, 0.1],)), ("chebwin", (100.0,)), ("chebwin", (40.0,)),
    ("tukey", (0.25,)), ("tukey", (1.0,)), ("tukey", (0.0,)), ("taylor", ()),
    ("taylor", (6, 50, False)), ("exponential", (None, 3.0)), ("dpss", (2.5,)),
]
GET_WINDOW = ["hann", "hamm", "blackmanharris", "tri", "rect", "sinc", ("kaiser", 8.0), 6.5,
              ("tukey", 0.3), ("gaussian", 2.0), ("chebwin", 80), ("dpss", 3.0),
              ("general_cosine", [0.5, 0.5]), ("kbd", 4.0), "hann_symmetric", "flattop_periodic",
              ("taylor", 4, 30), ("exponential", None, 2.0)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), f"max |d| {np.abs(a - b).max():.3e}"


def test_every_public_name_is_ported():
    assert tw.__all__ == jw.__all__
    assert tsw.__all__ == tw.__all__ and tsw.hann is tw.hann


@pytest.mark.parametrize("name", NO_ARG)
@pytest.mark.parametrize("m", [0, 1, 8, 9, 51])
@pytest.mark.parametrize("sym", [True, False])
def test_no_arg_windows_are_bit_identical(name, m, sym):
    _same(getattr(tw, name)(m, sym=sym), getattr(jw, name)(m, sym=sym))


@pytest.mark.parametrize("name,args", PARAM)
@pytest.mark.parametrize("m", [16, 33])
@pytest.mark.parametrize("sym", [True, False])
def test_param_windows_are_bit_identical(name, args, m, sym):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # chebwin's < 45 dB advisory
        _same(getattr(tw, name)(m, *args, sym=sym), getattr(jw, name)(m, *args, sym=sym))


@pytest.mark.parametrize("m", [16, 32])
def test_kbd_dpss_ratios_and_norms(m):
    _same(tw.kaiser_bessel_derived(m, 4.0), jw.kaiser_bessel_derived(m, 4.0))
    for norm in (2, "approximate", "subsample"):
        got, gr = tw.dpss(m, 2.5, Kmax=3, norm=norm, return_ratios=True)
        want, wr = jw.dpss(m, 2.5, Kmax=3, norm=norm, return_ratios=True)
        _same(got, want)
        _same(gr, wr)
    with pytest.raises(ValueError):
        tw.kaiser_bessel_derived(m + 1, 4.0)


@pytest.mark.parametrize("window", GET_WINDOW, ids=str)
@pytest.mark.parametrize("nx", [16, 33])
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window_is_bit_identical(window, nx, fftbins):
    """Equal windows, or the same ValueError (KBD has no periodic form, nor
    an odd length)."""
    out = []
    for mod in (tw, jw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out.append(mod.get_window(window, nx, fftbins))
            except ValueError as e:
                out.append(str(e))
    if isinstance(out[1], str):
        assert out[0] == out[1]
    else:
        _same(*out)


@pytest.mark.parametrize("window", [None, "rect", "hann", ("kaiser", 8.0), 7.0, "blackman"], ids=str)
@pytest.mark.parametrize("n", [1, 4, 256, 1000])
def test_window_table_is_bit_identical(window, n):
    _same(tstft.window_table(window, n), jstft.window_table(window, n))


@pytest.mark.parametrize("bad", [("bogus", 4), ("hann", 0), (("hann", 1.0), 8), ((3, 4), 8), ("kaiser", 8)])
def test_get_window_rejects_what_the_jax_package_rejects(bad):
    for mod in (tw, jw):
        with pytest.raises(ValueError):
            mod.get_window(*bad)
