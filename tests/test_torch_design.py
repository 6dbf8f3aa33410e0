"""The port's copy of the IIR design module (``gpu_fft_tpu_torch/ops/design.py``)
against the JAX package's (``gpu_fft_tpu/ops/design.py``).

Both are the same pure-numpy f64 code, so every output agrees to 1e-12 (in
fact bit for bit) on the cases of ``tests/test_design.py`` and
``tests/test_design_ellip.py``; the copy's source differs from the original
by its module docstring alone.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

import gpu_fft_tpu.ops.design as jd
import gpu_fft_tpu_torch.ops.design as td

ROOT = Path(__file__).resolve().parent.parent
BTYPES = [("low", 0.3), ("high", 0.4), ("bandpass", [0.2, 0.5]), ("bandstop", [0.25, 0.6])]


def _same(got, want):
    """Equal to 1e-12 of scale, recursing through tuples and lists."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.size:
        assert np.abs(g - w).max() <= 1e-12 * max(1.0, float(np.abs(w).max()))


def test_copy_is_the_jax_module_but_its_docstring():
    def body(path):
        tree = ast.parse((ROOT / path).read_text())
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body("gpu_fft_tpu_torch/ops/design.py") == body("gpu_fft_tpu/ops/design.py")
    assert td.__all__ == jd.__all__


@pytest.mark.parametrize("output", ["ba", "zpk", "sos"])
@pytest.mark.parametrize("btype,Wn", BTYPES)
@pytest.mark.parametrize("ftype,args", [("butter", ()), ("cheby1", (1.0,)), ("cheby2", (40.0,)),
                                        ("ellip", (1.0, 40.0)), ("bessel", ())])
def test_designs_match_jax(ftype, args, btype, Wn, output):
    for order in (1, 4, 7):
        _same(getattr(td, ftype)(order, *args, Wn, btype=btype, output=output),
              getattr(jd, ftype)(order, *args, Wn, btype=btype, output=output))


@pytest.mark.parametrize("analog", [False, True])
def test_iirfilter_and_fs_units_match_jax(analog):
    wn = [2.0, 5.0] if analog else [200.0, 300.0]
    kw = {} if analog else {"fs": 2000.0}
    for ftype, extra in (("butter", {}), ("cheby1", {"rp": 1.0}), ("cheby2", {"rs": 30.0}),
                         ("ellip", {"rp": 1.0, "rs": 30.0}), ("bessel", {})):
        for output in ("ba", "zpk", "sos"):
            _same(td.iirfilter(4, wn, btype="bandpass", ftype=ftype, analog=analog, output=output, **extra, **kw),
                  jd.iirfilter(4, wn, btype="bandpass", ftype=ftype, analog=analog, output=output, **extra, **kw))


@pytest.mark.parametrize("case", [
    (0.2, 0.3, 1, 40, {}), (0.4, 0.3, 1, 40, {}), ([0.2, 0.5], [0.1, 0.6], 2, 30, {}),
    ([0.1, 0.6], [0.2, 0.5], 1, 50, {}), (200.0, 300.0, 1, 40, {"fs": 2000.0}), (2.0, 3.0, 1, 40, {"analog": True}),
], ids=str)
def test_order_estimates_match_jax(case):
    wp, ws, gp, gs, kw = case
    for name in ("buttord", "cheb1ord", "cheb2ord", "ellipord"):
        _same(getattr(td, name)(wp, ws, gp, gs, **kw), getattr(jd, name)(wp, ws, gp, gs, **kw))
    _same(td.iirdesign(wp, ws, gp, gs, **kw), jd.iirdesign(wp, ws, gp, gs, **kw))


def test_biquads_and_comb_match_jax():
    for name in ("iirnotch", "iirpeak"):
        _same(getattr(td, name)(0.3, 30.0), getattr(jd, name)(0.3, 30.0))
        _same(getattr(td, name)(60.0, 30.0, fs=1000.0), getattr(jd, name)(60.0, 30.0, fs=1000.0))
    for ftype in ("notch", "peak"):
        for pass_zero in (False, True):
            _same(td.iircomb(50.0, 30.0, ftype=ftype, fs=1000.0, pass_zero=pass_zero),
                  jd.iircomb(50.0, 30.0, ftype=ftype, fs=1000.0, pass_zero=pass_zero))


def test_conversions_match_jax():
    z = np.array([-1.0, -1.0, 1j, -1j])
    p = np.array([0.5 + 0.3j, 0.5 - 0.3j, -0.2, 0.8])
    k = 0.7
    _same(td.zpk2tf(z, p, k), jd.zpk2tf(z, p, k))
    _same(td.zpk2sos(z, p, k), jd.zpk2sos(z, p, k))
    b, a = jd.butter(5, 0.3)
    _same(td.tf2zpk(b, a), jd.tf2zpk(b, a))
    _same(td.tf2sos(b, a), jd.tf2sos(b, a))
    sos = jd.cheby1(6, 1.0, [0.2, 0.4], btype="bandpass", output="sos")
    _same(td.sos2tf(sos), jd.sos2tf(sos))
    _same(td.sos2zpk(sos), jd.sos2zpk(sos))
    _same(td.normalize([2.0, 4.0, 6.0], [2.0, 1.0]), jd.normalize([2.0, 4.0, 6.0], [2.0, 1.0]))
    _same(td.bilinear([1.0], [1.0, 2.0, 2.0], fs=10.0), jd.bilinear([1.0], [1.0, 2.0, 2.0], fs=10.0))
    zz, pp, kk = jd.buttap(4)
    _same(td.bilinear_zpk(zz, pp, kk, 10.0), jd.bilinear_zpk(zz, pp, kk, 10.0))
    _same(td.freqz_zpk(z, p, k, worN=64), jd.freqz_zpk(z, p, k, worN=64))


def test_prototypes_and_transforms_match_jax():
    for name, args in (("buttap", (5,)), ("cheb1ap", (5, 1.0)), ("cheb2ap", (5, 40.0)), ("ellipap", (5, 1.0, 40.0)),
                       ("besselap", (5,))):
        _same(getattr(td, name)(*args), getattr(jd, name)(*args))
    b, a = jd.zpk2tf(*jd.buttap(3))
    z, p, k = jd.buttap(3)
    for name, args in (("lp2lp", (2.0,)), ("lp2hp", (2.0,)), ("lp2bp", (2.0, 0.5)), ("lp2bs", (2.0, 0.5))):
        _same(getattr(td, name)(b, a, *args), getattr(jd, name)(b, a, *args))
        _same(getattr(td, name + "_zpk")(z, p, k, *args), getattr(jd, name + "_zpk")(z, p, k, *args))
    _same(td.findfreqs(b, a, 64), jd.findfreqs(b, a, 64))
    _same(td.freqs(b, a, worN=64), jd.freqs(b, a, worN=64))
    _same(td.freqs_zpk(z, p, k, worN=64), jd.freqs_zpk(z, p, k, worN=64))


def test_validation_matches_jax():
    for mod in (td, jd):
        with pytest.raises(ValueError):
            mod.butter(0, 0.3)
        with pytest.raises(ValueError):
            mod.butter(4, 1.5)
        with pytest.raises(ValueError):
            mod.buttord(0.2, 0.3, 40, 1)
        with pytest.raises(ValueError):
            mod.iirnotch(600.0, 30.0, fs=1000.0)
    assert issubclass(td.BadCoefficients, UserWarning)
