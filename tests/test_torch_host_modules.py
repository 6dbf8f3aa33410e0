"""The port's copies of the host-only modules against the JAX package's, on
the CPU.

``ops/lti.py``, ``ops/fir_optimal.py``, ``ops/peaks.py``, ``ops/rank.py``
and ``utils/signal.py`` are the JAX package's pure-numpy modules with a new
module docstring and nothing else changed, so their outputs are bit-equal
on the cases of ``tests/test_lti.py``, ``test_fir_optimal.py``,
``test_peaks_savgol.py``, ``test_filter2d.py``, ``test_discrete_utils.py``
and ``test_analysis_ops.py``.  ``ops/splines.py`` runs its recursions
through the port's ``lfilter``, so it is held to ``tests/test_torch_iir.py``'s
lfilter gate, 2e-4 * max(1, max|JAX|), and to ``tests/test_splines.py``'s
gates against scipy.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as ss
import torch

import gpu_fft_tpu.ops.fir_optimal as jfo
import gpu_fft_tpu.ops.lti as jlti
import gpu_fft_tpu.ops.peaks as jpk
import gpu_fft_tpu.ops.rank as jrank
import gpu_fft_tpu.ops.splines as jsp
import gpu_fft_tpu.utils.signal as jsig
import gpu_fft_tpu_torch.ops.fir_optimal as tfo
import gpu_fft_tpu_torch.ops.lti as tlti
import gpu_fft_tpu_torch.ops.peaks as tpk
import gpu_fft_tpu_torch.ops.rank as trank
import gpu_fft_tpu_torch.ops.splines as tsp
import gpu_fft_tpu_torch.utils.signal as tsig

ROOT = Path(__file__).resolve().parent.parent
COPIES = {"ops/lti.py": (jlti, tlti), "ops/fir_optimal.py": (jfo, tfo), "ops/peaks.py": (jpk, tpk),
          "ops/rank.py": (jrank, trank), "utils/signal.py": (jsig, tsig)}


#: The port's recorded divergences from a copied module: (function, keyword
#: argument) -> (the port's default, the JAX module's).  ``remez`` takes
#: scipy's default sampling rate, 1.0, where the JAX module has 2.0.
DIVERGENCES = {"ops/fir_optimal.py": {("remez", "fs"): (1.0, 2.0)}}


def _body(path, divergences=None):
    """The module's AST without its docstring; each listed keyword default
    is checked to be the port's and set back to the JAX module's."""
    tree = ast.parse((ROOT / path).read_text())
    tree.body = tree.body[1:]  # the module docstring
    for (fn, kw), (ours, theirs) in (divergences or {}).items():
        (node,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn]
        (i,) = [i for i, a in enumerate(node.args.kwonlyargs) if a.arg == kw]
        assert node.args.kw_defaults[i].value == ours
        node.args.kw_defaults[i] = ast.Constant(theirs)
    return ast.dump(tree)


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copy_is_the_jax_module_but_its_docstring(path):
    assert _body(f"gpu_fft_tpu_torch/{path}", DIVERGENCES.get(path)) == _body(f"gpu_fft_tpu/{path}")
    jmod, tmod = COPIES[path]
    assert tmod.__all__ == jmod.__all__


def _same(got, want):
    """Bit-equal, recursing through tuples, lists, dicts and result objects."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif hasattr(want, "__dict__") and not isinstance(want, np.ndarray):
        _same(vars(got), vars(want))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


RNG = np.random.default_rng(7)
SIG = RNG.standard_normal(400)
PEAKY = np.sin(np.linspace(0, 12 * np.pi, 300)) + 0.3 * RNG.standard_normal(300)
IMG = RNG.standard_normal((17, 23))
A = np.array([[0.0, 1.0], [-2.0, -0.5]])
B = np.array([[0.0], [1.0]])
C = np.array([[1.0, 0.0]])
D = np.array([[0.0]])
T = np.linspace(0, 5, 101)
BA = ([1.0, 3.0, 2.0], [1.0, 2.0, 5.0, 4.0])

CASES = {
    "lti": [
        ("tf2ss", ([1.0, 2.0], [1.0, 3.0, 2.0]), {}),
        ("ss2tf", (A, B, C, D), {}),
        ("zpk2ss", ([-1.0], [-2.0, -3.0], 2.0), {}),
        ("ss2zpk", (A, B, C, D), {}),
        ("abcd_normalize", (A, B, C, D), {}),
        ("cont2discrete", ((A, B, C, D), 0.1), {"method": "zoh"}),
        ("cont2discrete", ((A, B, C, D), 0.1), {"method": "bilinear"}),
        ("cont2discrete", (([1.0], [1.0, 2.0, 1.0]), 0.05), {"method": "gbt", "alpha": 0.3}),
        ("lsim", ((A, B, C, D), np.sin(T), T), {}),
        ("impulse", ((A, B, C, D),), {"T": T}),
        ("step", (([1.0], [1.0, 0.4, 1.0]),), {"T": T}),
        ("freqresp", (([1.0], [1.0, 0.4, 1.0]),), {"w": np.logspace(-1, 1, 20)}),
        ("bode", (([1.0], [1.0, 0.4, 1.0]),), {"w": np.logspace(-1, 1, 20)}),
        ("dlsim", (([0.5], [1.0, -0.5], 1.0), SIG[:50]), {}),
        ("dimpulse", (([0.5], [1.0, -0.5], 1.0),), {"n": 20}),
        ("dstep", ((A * 0.1, B, C, D, 0.1),), {"n": 20}),
        ("dfreqresp", (([0.5], [1.0, -0.5], 1.0),), {"w": np.linspace(0.1, 3.0, 16)}),
        ("dbode", (([0.5], [1.0, -0.5], 1.0),), {"w": np.linspace(0.1, 3.0, 16)}),
        ("place_poles", (A, B, [-3.0, -4.0]), {}),
        ("residue", BA, {}),
        ("residuez", BA, {}),
        ("invres", ([1.0, 2.0], [-1.0, -3.0], []), {}),
        ("invresz", ([1.0, 2.0], [0.5, -0.25], []), {}),
        ("unique_roots", ([1.0, 1.0001, 2.0, 3.0],), {"tol": 1e-3}),
    ],
    "fir_optimal": [
        ("firls", (31, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0]), {}),
        ("firls", (21, [0, 100, 150, 500], [1, 1, 0, 0]), {"weight": [1, 10], "fs": 1000}),
        ("remez", (41, [0, 0.1, 0.2, 0.5], [1, 0]), {"fs": 2.0}),
        ("remez", (30, [0.05, 0.45], [1]), {"type": "hilbert", "fs": 2.0}),
        ("remez", (25, [0, 0.45], [1]), {"type": "differentiator", "fs": 2.0}),
        ("gammatone", (440.0, "fir"), {"fs": 16000.0}),
        ("gammatone", (1000.0, "iir"), {"fs": 16000.0}),
    ],
    "peaks": [
        ("find_peaks", (PEAKY,), {}),
        ("find_peaks", (PEAKY,), {"height": 0.5, "distance": 10, "prominence": 0.3, "width": 2}),
        ("find_peaks", (PEAKY,), {"threshold": 0.05, "plateau_size": 1, "wlen": 31, "rel_height": 0.7}),
        ("find_peaks", (np.array([0, 1, 1, 1, 0, 2, 2, 0, 3.0]),), {"plateau_size": (1, 3)}),
        ("peak_prominences", (PEAKY, ss.find_peaks(PEAKY)[0]), {}),
        ("peak_prominences", (PEAKY, ss.find_peaks(PEAKY)[0]), {"wlen": 21}),
        ("peak_widths", (PEAKY, ss.find_peaks(PEAKY)[0]), {"rel_height": 0.5}),
        ("find_peaks_cwt", (PEAKY, np.arange(1, 10)), {}),
        ("argrelmax", (PEAKY,), {"order": 3}),
        ("argrelmin", (IMG,), {"axis": 1}),
        ("argrelextrema", (PEAKY, np.greater_equal), {"order": 2, "mode": "wrap"}),
    ],
    "rank": [
        ("medfilt", (SIG, 5), {}),
        ("medfilt", (IMG, [3, 5]), {}),
        ("medfilt2d", (IMG, 3), {}),
        ("order_filter", (IMG, np.ones((3, 3)), 4), {}),
        ("wiener", (IMG,), {}),
        ("wiener", (SIG, 7), {"noise": 0.1}),
    ],
    "signal": [
        ("chirp", (T, 1.0, 5.0, 8.0), {}),
        ("chirp", (T, 1.0, 5.0, 8.0), {"method": "quadratic", "vertex_zero": False}),
        ("chirp", (T, 1.0, 5.0, 8.0), {"method": "logarithmic", "phi": 30.0}),
        ("chirp", (T, 1.0, 5.0, 8.0), {"method": "hyperbolic"}),
        ("square", (T * 7,), {"duty": 0.3}),
        ("sawtooth", (T * 7,), {"width": 0.4}),
        ("gausspulse", (np.linspace(-1e-3, 1e-3, 64),), {"fc": 5000.0, "retquad": True, "retenv": True}),
        ("gausspulse", ("cutoff",), {"fc": 1000.0}),
        ("sweep_poly", (T, np.poly1d([0.5, 1.0, 2.0])), {}),
        ("unit_impulse", ((4, 5), "mid"), {}),
        ("unit_impulse", (8, 3), {}),
        ("max_len_seq", (6,), {}),
        ("max_len_seq", (5,), {"state": [1, 0, 1, 1, 0], "length": 40}),
        ("generate_sine_wave", (15.0, 200.0, 1.0), {}),
        ("find_dominant_frequencies", (np.abs(np.fft.rfft(np.sin(0.3 * np.arange(64)))) ** 2,
                                       np.arange(33.0), 10.0), {}),
    ],
}
MODULES = {"lti": (jlti, tlti), "fir_optimal": (jfo, tfo), "peaks": (jpk, tpk), "rank": (jrank, trank),
           "signal": (jsig, tsig)}


@pytest.mark.parametrize("module,name,args,kw", [(m, *c) for m, cs in CASES.items() for c in cs],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_outputs_are_bit_equal(module, name, args, kw):
    jmod, tmod = MODULES[module]
    _same(getattr(tmod, name)(*args, **kw), getattr(jmod, name)(*args, **kw))


def test_remez_default_is_scipys():
    """At the default sampling rate the port designs scipy's filter (fs = 1:
    band edges in cycles a sample); the JAX module's default (fs = 2) reads
    the same edges as half-cycles and diverges.  Gate 2e-4 of max|scipy|:
    the two exchange iterations stop on their own grids, 5.04e-5 (1.0e-4 of
    max|h| = 0.50) apart."""
    want = ss.remez(51, [0, 0.2, 0.3, 0.5], [1, 0])
    got = tfo.remez(51, [0, 0.2, 0.3, 0.5], [1, 0])
    assert abs(np.abs(want).max() - 0.5) < 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    assert np.abs(jfo.remez(51, [0, 0.2, 0.3, 0.5], [1, 0]) - want).max() > 1.0  # the JAX default's filter
    _same(got, tfo.remez(51, [0, 0.2, 0.3, 0.5], [1, 0], fs=1.0))


def test_lti_classes_are_bit_equal():
    for j, t in ((jlti.lti([1.0], [1.0, 0.4, 1.0]), tlti.lti([1.0], [1.0, 0.4, 1.0])),
                 (jlti.dlti([0.5], [1.0, -0.5], dt=0.1), tlti.dlti([0.5], [1.0, -0.5], dt=0.1)),
                 (jlti.lti(A, B, C, D), tlti.lti(A, B, C, D))):
        assert type(t).__name__ == type(j).__name__
        _same(t.to_zpk(), j.to_zpk())
        _same(t.to_ss(), j.to_ss())
        _same(t.impulse(N=16), j.impulse(N=16))
        _same(t.bode(n=12), j.bode(n=12))


@pytest.mark.parametrize("module,call", [
    ("fir_optimal", lambda m: m.firls(30, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0])),  # even taps
    ("fir_optimal", lambda m: m.remez(11, [0, 0.3, 0.2, 0.5], [1, 0])),  # bands out of order
    ("fir_optimal", lambda m: m.gammatone(440.0, "bogus")),
    ("peaks", lambda m: m.find_peaks(IMG)),  # 2-D
    ("peaks", lambda m: m.find_peaks(PEAKY, distance=0)),
    ("lti", lambda m: m.place_poles(A, B, [-3.0, -3.0, -3.0])),
    ("rank", lambda m: m.medfilt(SIG, 4)),  # even kernel
], ids=["firls-even", "remez-bands", "gammatone-type", "peaks-2d", "peaks-distance", "place-poles",
        "medfilt-even"])
def test_errors_are_the_jax_modules(module, call):
    jmod, tmod = MODULES[module]
    with pytest.raises(ValueError) as jerr:
        call(jmod)
    with pytest.raises(ValueError) as terr:
        call(tmod)
    assert str(terr.value) == str(jerr.value)


# ── splines: the port's lfilter under the recursions ─────────────────────────


def _close(got, want, gate):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= gate * max(1.0, float(np.abs(want).max()))


SPLINES = [
    ("symiirorder1", (SIG[:200], 6 * (2 - np.sqrt(3)), -2 + np.sqrt(3)), {}, (2e-5, 2e-5)),
    ("symiirorder1", (RNG.standard_normal((5, 80)), 1.0, 0.5), {}, (2e-5, 2e-5)),
    ("symiirorder1", (RNG.standard_normal((3, 64)).astype(np.float32), 1.0, -0.4), {}, (2e-5, 2e-5)),
    ("symiirorder2", (SIG[:200], 0.5, 0.8), {}, (2e-5, 2e-5)),
    ("symiirorder2", (RNG.standard_normal((4, 120)), 0.3, 1.2), {}, (2e-5, 2e-5)),
    ("cspline1d", (SIG[:150],), {}, (1e-4, 1e-4)),
    ("cspline1d", (SIG[:150],), {"lamb": 2.0}, (1e-4, 1e-4)),
    ("qspline1d", (SIG[:150],), {}, (1e-4, 1e-4)),
    ("cspline2d", (IMG,), {}, (1e-4, 1e-4)),
    ("cspline2d", (RNG.standard_normal((24, 31)),), {"lamb": 1.0}, (1e-4, 1e-4)),
    ("qspline2d", (RNG.standard_normal((20, 26)),), {}, (1e-4, 1e-4)),
    ("spline_filter", (RNG.standard_normal((64, 64)),), {"lmbda": 5.0}, (1e-4, 1e-4)),
    ("spline_filter", (RNG.standard_normal((16, 16)).astype(np.float32),), {}, (1e-3, 1e-3)),
]


@pytest.mark.parametrize("name,args,kw,scipy_tol", SPLINES, ids=lambda v: v if isinstance(v, str) else "")
def test_splines_match_jax_and_scipy(name, args, kw, scipy_tol):
    got = getattr(tsp, name)(*args, **kw, device="cpu")
    _close(got, getattr(jsp, name)(*args, **kw), 2e-4)
    np.testing.assert_allclose(got, getattr(ss, name)(*args, **kw), rtol=scipy_tol[0], atol=scipy_tol[1])


def test_spline_filter_complex_matches_jax():
    imgc = (RNG.standard_normal((16, 16)) + 1j * RNG.standard_normal((16, 16))).astype(np.complex64)
    got = tsp.spline_filter(imgc, device="cpu")
    assert got.dtype == np.complex64
    _close(got, jsp.spline_filter(imgc), 2e-4)


@pytest.mark.parametrize("name", ["cspline1d_eval", "qspline1d_eval", "sepfir2d"])
def test_spline_host_functions_are_bit_equal(name):
    cj = tsp.cspline1d(SIG[:40], device="cpu")
    args = {"cspline1d_eval": (cj, np.linspace(-3.0, 45.0, 97)), "qspline1d_eval": (cj, np.linspace(2.0, 8.0, 33)),
            "sepfir2d": (IMG, RNG.standard_normal(5), RNG.standard_normal(3))}[name]
    _same(getattr(tsp, name)(*args), getattr(jsp, name)(*args))


@pytest.mark.parametrize("call", [
    lambda m, kw: m.symiirorder1(SIG[:32], -3.0, 0.5, **kw),  # does not converge
    lambda m, kw: m.symiirorder1(SIG[:16], 1.0, 1.5, **kw),
    lambda m, kw: m.symiirorder2(SIG[:16], 1.0, 0.5, **kw),
    lambda m, kw: m.cspline2d(RNG.standard_normal((24, 31)), 8.0, **kw),
    lambda m, kw: m.qspline2d(IMG, 1.0, **kw),
], ids=["nonconvergent", "z1", "r", "cspline2d-nonconvergent", "qspline2d-lamb"])
def test_spline_errors_match_jax(call):
    with pytest.raises(ValueError):
        call(jsp, {})
    with pytest.raises(ValueError):
        call(tsp, {"device": "cpu"})


def test_every_spline_recursion_takes_a_device():
    """Each public function that reaches ``lfilter`` takes ``device`` and,
    given none, asks for the card."""
    for name in ("symiirorder1", "symiirorder2", "cspline1d", "qspline1d", "cspline2d", "qspline2d",
                 "spline_filter"):
        assert inspect.signature(getattr(tsp, name)).parameters["device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsp.cspline1d(SIG[:64])
