"""The port's chirp-z, DCT/DST and FFTLog (``gpu_fft_tpu_torch/ops/czt.py``,
``ops/dct.py``, ``ops/fht.py``) against the JAX package's on the CPU.

The same seeded numpy inputs go through both packages, with the JAX tests'
gates relative to max |ref|: chirp-z 2e-4 (a custom spiral 5e-4,
``tests/test_analysis_ops.py``), DCT/DST 5e-5 (``tests/test_dsp.py``),
FFTLog 3e-5 (``tests/test_fht.py``).  The DCT's Makhoul permutation is
slices and an interleaving stack in the port, a 0/1 permutation matmul in
the JAX package at power-of-two n >= 256: those sizes are held here.
"""

import warnings

import numpy as np
import pytest
import scipy.fft as sf
import scipy.signal
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.ops.czt as jczt
import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.ops import czt as tczt
from gpu_fft_tpu_torch.ops import dct as tdct


def _signal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (scale if scale else max(np.abs(want).max(), 1e-30)))


# ── Chirp-z ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n,m", [(100, 100), (100, 37), (64, 200), (101, 101), (256, 256), (30000, 17)])
def test_czt_default_matches_jax(n, m):
    """The default DFT spacing (exact phase reduction); (30000, 17) is the
    asymmetric n >> m case."""
    x = _signal(n, n)
    gr, gi = gt.czt(x, m=m, device="cpu")
    jr, ji = gf.czt(x, m=m)
    ref = scipy.signal.czt(x.astype(np.float64), m=m)
    assert _rel(gr + 1j * gi, jr + 1j * ji) < 2e-4
    assert _rel(gr + 1j * gi, ref) < 2e-4


def test_czt_custom_w_a_matches_jax():
    x = _signal(80, 80)
    w = complex(np.exp(-2j * np.pi / 97) * 1.001)
    a = complex(np.exp(2j * np.pi * 0.13) * 0.998)
    gr, gi = gt.czt(x, m=50, w=w, a=a, device="cpu")
    jr, ji = gf.czt(x, m=50, w=w, a=a)
    assert _rel(gr + 1j * gi, jr + 1j * ji) < 5e-4
    assert _rel(gr + 1j * gi, scipy.signal.czt(x.astype(np.float64), m=50, w=w, a=a)) < 5e-4


def test_czt_device_batched_complex_input_matches_jax():
    x, xi = _signal(1, 3, 64), _signal(2, 3, 64)
    gr, gi = tczt.czt_device(torch.from_numpy(x), m=40, imag=torch.from_numpy(xi))
    jr, ji = jczt.czt_device(x, m=40, imag=xi)
    assert _rel(gr.numpy() + 1j * gi.numpy(), np.asarray(jr) + 1j * np.asarray(ji)) < 2e-4
    ref = scipy.signal.czt(x.astype(np.float64) + 1j * xi, m=40, axis=-1)
    assert _rel(gr.numpy() + 1j * gi.numpy(), ref) < 2e-4


def test_czt_chirp_phase_exact_reduction():
    """The port's copy of the integer-mod phase reduction against exact
    rational arithmetic and the JAX package's, at j up to 2^20."""
    from fractions import Fraction

    j = np.asarray([1, 12345, (1 << 20) - 3, 1 << 20], dtype=np.int64)
    e = j * j
    for num, den in [(-1, 1000003), (7, 48000), (-(10**14) - 1, (1 << 51) + 5)]:
        got = tczt._phase_halfturns_exact(e, num, den)
        want = [float((Fraction(int(v)) * num / den) % 2) for v in e]
        assert np.abs(got - np.asarray(want)).max() < 1e-12
        assert np.array_equal(got, jczt._phase_halfturns_exact(e, num, den))
    p, jp = tczt._czt_plan(300, 17, 1j, 1 + 0j, (-1, 17)), jczt._czt_plan(300, 17, 1j, 1 + 0j, (-1, 17))
    assert all(np.array_equal(p[k], jp[k]) for k in p)


@pytest.mark.parametrize("fn", [[100.0, 150.0], 80.0])
def test_zoom_fft_matches_jax(fn):
    x = _signal(11, 1000)
    gr, gi = gt.zoom_fft(x, fn, m=128, fs=400.0, device="cpu")
    jr, ji = gf.zoom_fft(x, fn, m=128, fs=400.0)
    assert _rel(gr + 1j * gi, jr + 1j * ji) < 2e-4
    assert _rel(gr + 1j * gi, scipy.signal.zoom_fft(x.astype(np.float64), fn, m=128, fs=400.0)) < 2e-4


def test_czt_and_zoom_fft_classes_match_jax():
    x = _signal(12, 2, 3, 96)
    w = complex(np.exp(-2j * np.pi * 0.3 / 64))
    ours, theirs = gt.CZT(96, 64, w=w, device="cpu"), gf.CZT(96, 64, w=w)
    assert _rel(ours(x), theirs(x)) < 2e-4
    assert _rel(ours(x.swapaxes(1, 2), axis=1), theirs(x.swapaxes(1, 2), axis=1)) < 2e-4
    assert np.array_equal(ours.points(), theirs.points())
    assert np.array_equal(gt.czt_points(10, w, 0.5), gf.czt_points(10, w, 0.5))
    zo, zj = gt.ZoomFFT(96, [0.1, 0.4], 50, fs=2.0, endpoint=True, device="cpu"), gf.ZoomFFT(96, [0.1, 0.4], 50,
                                                                                           fs=2.0, endpoint=True)
    assert _rel(zo(x), zj(x)) < 2e-4
    assert _rel(zo(x), scipy.signal.ZoomFFT(96, [0.1, 0.4], 50, fs=2.0, endpoint=True)(x.astype(np.float64))) < 2e-4
    with pytest.raises(ValueError):
        ours(x[..., :10])


def test_czt_contracts():
    for kw in ({"m": 0}, {"w": 0.0}):
        with pytest.raises(ValueError):
            gt.czt(np.zeros(16, np.float32), device="cpu", **kw)
    with pytest.raises(ValueError):
        gt.zoom_fft(np.zeros(16, np.float32), [1.0, 2.0, 3.0], device="cpu")
    with pytest.raises(ValueError):
        gt.zoom_fft(np.zeros(16, np.float32), 1.0, fs=-1.0, device="cpu")


# ── DCT / DST ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [256, 1024, 257, 100])
def test_dct_dst_match_jax(n, type_, norm):
    """Power-of-two n >= 256 (the permutation the port writes as slices)
    and odd / even non-power-of-two n; forward and inverse."""
    x = _signal(n + type_, 2, n)
    for ours, theirs, ref in ((gt.dct, gf.dct, sf.dct), (gt.dst, gf.dst, sf.dst),
                              (gt.idct, gf.idct, sf.idct), (gt.idst, gf.idst, sf.idst)):
        got = ours(x, type_, norm, device="cpu")
        want = ref(x.astype(np.float64), type=type_, norm=norm)
        scale = max(1.0, float(np.abs(want).max()))
        assert _rel(got, theirs(x, type=type_, norm=norm), scale) < 5e-5, ours.__name__
        assert _rel(got, want, scale) < 5e-5, ours.__name__


@pytest.mark.parametrize("n", [2, 3, 8, 256, 1 << 17])
def test_makhoul_permutation_matches_jax(n):
    """The slice form against the JAX package's (the permutation matmul at
    power-of-two n >= 256), both directions; bit-equal (a permutation)."""
    import jax.numpy as jnp

    from gpu_fft_tpu.ops import dct as jdct

    x = _signal(n, 3, n)
    got = tdct._makhoul_permute(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jdct._makhoul_permute(jnp.asarray(x))))
    assert np.array_equal(tdct._makhoul_unpermute(torch.from_numpy(got)).numpy(), x)


def test_dct_roundtrips_and_staged_size():
    """The ortho DCT-II/III roundtrip at 2^17 (the staged transform and the
    staged real-output inverse) against the JAX package's."""
    x = _signal(17, 1 << 17)
    y = gt.dct(x, 2, "ortho", device="cpu")
    assert _rel(y, gf.dct(x, type=2, norm="ortho"), max(1.0, float(np.abs(y).max()))) < 5e-5
    back = gt.idct(y, 2, "ortho", device="cpu")
    assert np.abs(back - x).max() < 1e-4


@pytest.mark.parametrize("shape,axes,type_", [((16, 24), None, 2), ((8, 12, 10), (0, 2), 3), ((8, 6), (1,), 1),
                                              ((8, 6), (-1, 0), 4)], ids=str)
def test_dctn_dstn_match_jax(shape, axes, type_):
    x = _signal(sum(shape), *shape)
    for ours, theirs, ref in ((gt.dctn, gf.dctn, sf.dctn), (gt.dstn, gf.dstn, sf.dstn),
                              (gt.idctn, gf.idctn, sf.idctn), (gt.idstn, gf.idstn, sf.idstn)):
        got = ours(x, type_, "ortho", axes, device="cpu")
        want = ref(x.astype(np.float64), type=type_, norm="ortho", axes=axes)
        assert _rel(got, theirs(x, type=type_, norm="ortho", axes=axes), max(1.0, np.abs(want).max())) < 5e-5
        assert _rel(got, want, max(1.0, np.abs(want).max())) < 5e-5


def test_dct_contracts():
    with pytest.raises(ValueError):
        gt.dct(np.ones(8), 5, device="cpu")
    with pytest.raises(ValueError):
        gt.dct(np.ones(8), 2, "forward", device="cpu")
    with pytest.raises(ValueError):
        gt.dct(np.ones(1), 1, device="cpu")
    with pytest.raises(ValueError):
        gt.dctn(np.ones((4, 4)), axes=(0, 0), device="cpu")
    with pytest.raises(ValueError):
        gt.dctn(np.ones((4, 4)), axes=(2,), device="cpu")


# ── FFTLog ───────────────────────────────────────────────────────────────────


def _log_signal(n, dln):
    r = np.exp((np.arange(n) - (n - 1) / 2) * dln)
    return (r**1.5 * np.exp(-r * r / 2)).astype(np.float32)


@pytest.mark.parametrize("n,mu,bias", [(n, mu, bias) for n in (8, 63, 64, 100, 256)
                                        for mu, bias in ((0.0, 0.0), (0.5, 0.5), (2.0, -0.25))]
                         + [(n, mu, 0.0) for n in (4096, 10000) for mu in (0.0, 0.5)])
def test_fht_matches_jax(n, mu, bias):
    """Power-of-two n (rfft/irfft) and any other n (the exact transforms),
    with and without a bias at the JAX tests' sizes, unbiased above them.
    The grid spans ln r in +-6.4 at every n (dln = 0.05 at n = 256)."""
    dln = min(0.05, 12.8 / n)
    a = _log_signal(n, dln)
    off = gt.fhtoffset(dln, mu, bias=bias)
    got = gt.fht(a, dln, mu, offset=off, bias=bias, device="cpu")
    want = sf.fht(a.astype(np.float64), dln, mu, offset=off, bias=bias)
    scale = max(1.0, float(np.abs(want).max()))
    assert _rel(got, gf.fht(a, dln, mu, offset=off, bias=bias), scale) < 3e-5
    assert _rel(got, want, scale) < 3e-5
    back = gt.ifht(got, dln, mu, offset=off, bias=bias, device="cpu")
    assert _rel(back, gf.ifht(got, dln, mu, offset=off, bias=bias), max(1.0, float(np.abs(a).max()))) < 3e-5
    assert np.abs(back - a).max() / np.abs(a).max() < 3e-5


def test_fht_biased_error_grows_with_n_in_both_packages():
    """With a bias the f32 power-law tapers exp(-+q t) widen the dynamic
    range as n grows: at n = 4,096, bias 0.5 both packages miss the 3e-5
    gate that holds at n <= 256 (JAX ~1e-4, the port ~4e-5).  Pinned: the
    port is no worse than the JAX package there, and its inverse still
    returns the signal."""
    n, mu, bias = 4096, 0.5, 0.5
    dln = 12.8 / n
    a = _log_signal(n, dln)
    off = gt.fhtoffset(dln, mu, bias=bias)
    want = sf.fht(a.astype(np.float64), dln, mu, offset=off, bias=bias)
    scale = max(1.0, float(np.abs(want).max()))
    got = gt.fht(a, dln, mu, offset=off, bias=bias, device="cpu")
    ours, theirs = _rel(got, want, scale), _rel(gf.fht(a, dln, mu, offset=off, bias=bias), want, scale)
    assert 3e-5 < theirs and ours <= theirs
    back = gt.ifht(got, dln, mu, offset=off, bias=bias, device="cpu")
    assert np.abs(back - a).max() / np.abs(a).max() < 3e-5


def test_fht_batched_device_and_offset():
    n, dln, mu = 64, 0.1, 1.0
    base = _log_signal(n, dln)
    batch = np.stack([base * s for s in (1.0, -0.5, 2.0)])[:, None].repeat(2, axis=1)
    got = gt.fht_device(torch.from_numpy(batch), dln, mu)
    assert got.shape == (3, 2, n)
    assert _rel(got.numpy(), gf.fht(batch, dln, mu)) < 3e-5
    for dln_, mu_, initial, bias in ((0.1, 0.5, 0.0, 0.0), (0.05, 2.0, 0.3, 0.4), (0.2, -0.5, -1.0, -0.2)):
        got = gt.fhtoffset(dln_, mu_, initial=initial, bias=bias)
        assert got == gf.fhtoffset(dln_, mu_, initial=initial, bias=bias)
        assert abs(got - sf.fhtoffset(dln_, mu_, initial=initial, bias=bias)) < 1e-12


def test_fht_singular_warns_and_validates():
    n, dln, mu, bias = 64, 0.05, -1.5, 0.5
    a = _log_signal(n, dln)
    with pytest.warns(UserWarning, match="singular transform"):
        got = gt.fht(a, dln, mu, bias=bias, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = gf.fht(a, dln, mu, bias=bias)
    assert _rel(got, want, max(1.0, float(np.abs(want).max()))) < 3e-5
    with pytest.raises(ValueError, match="non-empty"):
        gt.fht(np.zeros((0,), np.float32), 0.1, 0.0, device="cpu")
    with pytest.raises(ValueError, match="positive log spacing"):
        gt.fht(np.ones(8, np.float32), -0.1, 0.0, device="cpu")
    with pytest.raises(ValueError, match="positive dln"):
        gt.fhtoffset(0.0, 0.5)
