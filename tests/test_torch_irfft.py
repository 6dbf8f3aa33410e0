"""Real input and real output in the port, against the JAX package, on the CPU.

Mirrors ``tests/test_irfft_half.py`` and ``tests/test_half_spectrum.py``:
the Hermitian fold (``fused_irfft``), the ``inverse_real`` dispatch on both
sides of both gates (the JAX side's stage-A kernel in Pallas interpret
mode), the direct folded tables, the one-sided ``rfft_device`` /
``irfft_device`` roundtrip, DC/Nyquist imaginary parts, the plans, the
gates forced through ``GPU_FFT_TPU_CHIP``, the host ``rfft`` / ``irfft``,
and the ``GPU_FFT_TPU_BACKEND`` override.

Tolerances: max |port - JAX| <= 1e-5 * max |JAX| (fp32 on both sides from
bit-identical tables, another summation order), and the signal against
numpy in float64 within 5 * log2(n) * eps relative to max |x|.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.kernels.fused_jnp as jfj
import gpu_fft_tpu.kernels.large as jlarge
import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.kernels.fused_torch as tft
import gpu_fft_tpu_torch.kernels.large as tlarge
from gpu_fft_tpu_torch import plan as tplan
from gpu_fft_tpu_torch import tuning as ttuning
from gpu_fft_tpu_torch.backends import Backend, default_backend

RTOL = 1e-5
KERNELS = ("whole_transform", "whole_transform_packed", "stage_a")


def _bound(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


def _hermitian(b, n, seed):
    """A real (b, n) signal and its full spectrum, split into fp32 parts."""
    x = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)
    spec = np.fft.fft(x.astype(np.float64), axis=-1)
    return x, spec.real.astype(np.float32), spec.imag.astype(np.float32)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), f"max|d| {err:.3e} > {rtol} * {np.abs(want).max():.3e}"


def _signal_close(got, x, n, factor=1.0):
    err = np.abs(np.asarray(got, np.float64) - x).max() / np.abs(x).max()
    assert err <= factor * _bound(n), f"n={n}: relative error {err:.3e} > {factor * _bound(n):.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_cache():
    """JAX outputs by case key, each computed once per module."""
    cache: dict = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


def _counting(monkeypatch, module, log):
    """Record (col_tiles, ct) of every stage-A call that ``module`` makes."""
    real = module.stage_a

    def wrapper(*args, **kwargs):
        log.append((kwargs.get("col_tiles"), args[5]))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "stage_a", wrapper)


# ── The fused fold (fused_irfft) ─────────────────────────────────────────────


@pytest.mark.parametrize("n", [16, 256, 4096, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_irfft_matches_jax_and_numpy(jax_cache, n, b):
    x, xr, xi = _hermitian(b, n, n + b)
    want = jax_cache(("fold", b, n), lambda: np.asarray(
        jfj.fused_irfft_jnp(jnp.asarray(xr), jnp.asarray(xi), jplan.get_irfft_plan(n, scale=1.0 / n))))
    got = tft.fused_irfft(_t(xr), _t(xi), tplan.on_device(tplan.get_irfft_plan, n, 1.0 / n, None, device="cpu"))
    _close(got.numpy(), want)
    _signal_close(got.numpy(), x, n)


# ── The inverse_real dispatch ────────────────────────────────────────────────

# (b, n) on both sides of both gates: 2^14 the full inverse (B = 1: K1),
# 2^15 / 2^16 the fused fold, 2^17 the full staged inverse, 2^18 K3 on
# 3 of 4 column tiles + the per-row stage-B fold.
DISPATCH = [(1, 1 << 14), (2, 1 << 14), (2, 1 << 15), (2, 1 << 16), (2, 1 << 17), (2, 1 << 18)]
# The stage-A calls each (b, n) makes: (col_tiles, ct).
STAGE_A_CALLS = {(2, 1 << 17): [(None, 512)], (2, 1 << 18): [(3, 512)]}


@pytest.mark.parametrize("b,n", DISPATCH)
def test_inverse_real_dispatch_matches_jax(jax_cache, monkeypatch, b, n):
    x, xr, xi = _hermitian(b, n, n)

    def run_jax():
        log: list = []
        with monkeypatch.context() as m:
            _counting(m, jlarge, log)
            out = np.asarray(jlarge.inverse_real(jnp.asarray(xr), jnp.asarray(xi), n, scale=1.0 / n))
        return out, log

    want, jax_calls = jax_cache(("inverse_real", b, n), run_jax)
    log: list = []
    _counting(monkeypatch, tlarge, log)
    K.reset_counts()
    got = tlarge.inverse_real(_t(xr), _t(xi), n, scale=1.0 / n).numpy()
    _close(got, want)
    _signal_close(got, x, n)
    # Same engine: the same stage-A calls, the whole kernel where JAX has it.
    assert log == jax_calls == STAGE_A_CALLS.get((b, n), [])
    ran = {k for k in KERNELS if K.COUNTS[k].plain_calls}
    assert ran == ({"whole_transform"} if (b, n) == (1, 1 << 14) else {"stage_a"} if log else set())
    # And the full complex inverse's real part.
    full, _ = tlarge.transform_any(_t(xr), _t(xi), n, +1, scale=1.0 / n)
    _close(got, full.numpy(), rtol=2e-5)


@pytest.mark.parametrize("n", [1 << 15, 1 << 17, 1 << 18])
def test_unnormalized_scale_none(n):
    """scale=None is the unnormalized inverse (n * signal) on the fold, the
    full staged inverse and the staged fold: the scale is applied once."""
    x, xr, xi = _hermitian(1, n, 7)
    out = tlarge.inverse_real(_t(xr), _t(xi), n).numpy()
    _signal_close(out / n, x, n)


def test_fold_columns_rebuild_the_mirrored_half():
    """irfft_fold_columns on half the stage-A columns equals the slice of
    the full stage-A output that stage_b_irfft reads: the Q - h + 1 slice
    and the q = 0 block-start plane, shifted by one block, ending at n2/2."""
    n = 1 << 18
    x, xr, xi = _hermitian(2, n, 3)
    plan = tplan.on_device(tplan.get_stage_a_plan, n, +1, None, device="cpu")
    bt = tplan.on_device(tplan.get_stage_b_irfft_plan, n, 1.0 / n, device="cpu")
    n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
    x3r, x3i = _t(xr).reshape(2, n1, n2), _t(xi).reshape(2, n1, n2)
    fr, fi = K.stage_a(x3r, x3i, n1, n2, plan, ct)
    hr, hi = K.stage_a(x3r, x3i, n1, n2, plan, ct, col_tiles=-(-(n2 // 2 + 1) // ct))
    assert hr.shape[2] < n2
    gr, gi = tft.irfft_fold_columns(hr, hi, bt)
    q, p = bt["n1"], bt["n2"]
    _close(gr.numpy(), fr.reshape(2, n1, p, q)[..., : bt["h1"]].numpy())
    _close(gi.numpy(), fi.reshape(2, n1, p, q)[..., : bt["h1"]].numpy())
    full = tft.stage_b_irfft(fr, fi, n1, bt).numpy()
    jfull = np.asarray(jfj.stage_b_irfft_jnp(jnp.asarray(fr.numpy()), jnp.asarray(fi.numpy()), n1,
                                             jplan.get_stage_b_irfft_plan(n, scale=1.0 / n)))
    _close(full, jfull)
    _close(tft.stage_b_irfft_from_half(gr, gi, bt).numpy(), full)
    _signal_close(full, x, n)


# ── The one-sided entry (inverse_real_half, irfft_device) ────────────────────


@pytest.mark.parametrize("n", [2, 4, 16, 64, 256, 512])
@pytest.mark.parametrize("b", [1, 5])
def test_direct_half_matches_jax_and_numpy(jax_cache, n, b):
    x, xr, xi = _hermitian(b, n, n + b)
    h = n // 2 + 1
    want = jax_cache(("direct", b, n), lambda: np.asarray(
        jlarge.inverse_real_half(jnp.asarray(xr[:, :h]), jnp.asarray(xi[:, :h]), n, scale=1.0 / n)))
    got = tlarge.inverse_real_half(_t(xr[:, :h]), _t(xi[:, :h]), n, scale=1.0 / n).numpy()
    _close(got, want)
    err = np.abs(got - x).max() / max(np.abs(x).max(), 1e-30)
    assert err < max(_bound(n), 2e-6)


@pytest.mark.parametrize("n", [256, 512])
def test_direct_k128_matches_the_h_deep_form(n):
    x, xr, xi = _hermitian(3, n, 9)
    h = n // 2 + 1
    a = tft.irfft_direct_half(_t(xr[:, :h]), _t(xi[:, :h]),
                              tplan.on_device(tplan.get_irfft_direct_plan, n, 1.0 / n, device="cpu"))
    k = tft.irfft_direct_half_k128(_t(xr[:, :h]), _t(xi[:, :h]),
                                   tplan.on_device(tplan.get_irfft_direct_k128_plan, n, 1.0 / n, device="cpu"))
    _close(k.numpy(), a.numpy())
    _signal_close(k.numpy(), x, n)


@pytest.mark.parametrize("n", [4, 256, 512, 1024, 4096, 1 << 15, 1 << 18])
def test_irfft_device_one_sided_roundtrip(jax_cache, n):
    """rfft_device -> irfft_device at direct sizes, the mirror + full
    inverse (K2 at 1,024 only at B = 1; B = 3 here), the fold and the
    staged fold, against the JAX package's pair and the signal."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)

    def run_jax():
        fr, fi = gf.rfft_device(jnp.asarray(x))
        return np.asarray(fr), np.asarray(fi), np.asarray(gf.irfft_device(fr, fi))

    jfr, jfi, jy = jax_cache(("roundtrip", n), run_jax)
    fr, fi = gt.rfft_device(_t(x))
    assert fr.shape == fi.shape == (3, n // 2 + 1)
    _close(np.stack([fr.numpy(), fi.numpy()]), np.stack([jfr, jfi]))
    y = gt.irfft_device(fr, fi)
    assert y.shape == (3, n) and y.device.type == "cpu"
    _close(y.numpy(), jy)
    _signal_close(y.numpy(), x, n)


@pytest.mark.parametrize("n", [1024, 4096])
def test_irfft_device_b1_runs_the_whole_kernel(n):
    """At B = 1, 1,024 <= n <= 16,384 the one-sided inverse is the full
    inverse in one kernel: K2 at 1,024, K1 above."""
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    fr, fi = gt.rfft_device(_t(x))
    assert fr.shape == (n // 2 + 1,)
    K.reset_counts()
    y = gt.irfft_device(fr, fi)
    assert y.shape == (n,)
    name = "whole_transform_packed" if n == 1024 else "whole_transform"
    assert {k for k in KERNELS if K.COUNTS[k].plain_calls} == {name}
    _signal_close(y.numpy(), x[None], n)


@pytest.mark.parametrize("n", [256, 4096, 1 << 15, 1 << 18])
@pytest.mark.parametrize("backend", [Backend.TORCH, Backend.TORCH_FFT])
def test_dc_nyquist_imaginary_parts_are_ignored(n, backend):
    """numpy irfft semantics on every path: dirty imaginary parts in bins 0
    and n/2 change nothing."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    sp = np.fft.rfft(x.astype(np.float64))
    xr = sp.real.astype(np.float32)
    xi = sp.imag.astype(np.float32)
    dirty = xi.copy()
    dirty[:, 0] = 7.0
    dirty[:, -1] = -3.0
    clean = gt.irfft_device(_t(xr), _t(xi), backend=backend).numpy()
    got = gt.irfft_device(_t(xr), _t(dirty), backend=backend).numpy()
    np.testing.assert_array_equal(got, clean)
    _signal_close(got, x, n)


# ── Plans ────────────────────────────────────────────────────────────────────


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda: tplan.get_irfft_plan(48), "power-of-two"),
        (lambda: tplan.get_irfft_plan(8), "power-of-two"),
        (lambda: tplan.get_irfft_plan(1 << 17), "FUSED_MAX"),
        (lambda: tplan.get_irfft_plan(4096, None, (32, 64)), "split"),
        (lambda: tplan.get_irfft_direct_plan(3), "power-of-two"),
        (lambda: tplan.get_irfft_direct_plan(1024), "DIRECT_MAX"),
        (lambda: tlarge.inverse_real_half(torch.zeros(1, 10), torch.zeros(1, 10), 16), "9 bins"),
        (lambda: gt.irfft_device(torch.zeros(6), torch.zeros(6)), "bins"),
        (lambda: gt.irfft_device(torch.zeros(5), torch.zeros(4)), "shapes differ"),
        (lambda: gt.irfft(np.ones(5), np.ones(4), device="cpu"), "equal-length"),
        (lambda: gt.irfft(np.ones(4), np.ones(4), device="cpu"), "bins"),
    ],
)
def test_plans_and_entries_reject_bad_n(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _assert_same_plan(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if hasattr(v, "shape"):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize(
    "name,args",
    [("get_irfft_plan", (n, s, None)) for n in (16, 4096, 1 << 16) for s in (None, 1.0 / n)]
    + [("get_irfft_plan", (1 << 13, 1.0 / (1 << 18), (128, 64)))]
    + [("get_irfft_direct_plan", (n, 1.0 / n)) for n in (2, 256, 512)]
    + [("get_irfft_direct_k128_plan", (n, 1.0 / n)) for n in (256, 512)]
    + [("get_stage_b_irfft_plan", (n, 1.0 / n)) for n in (1 << 18, 1 << 20)],
)
def test_plans_equal_the_jax_plans(name, args):
    want = getattr(jplan, name)(*args)
    _assert_same_plan(tplan.from_jax_plan(want), want)
    _assert_same_plan(getattr(tplan, name)(*args), want)


def test_stage_b_irfft_plan_is_none_without_stage_b(monkeypatch):
    """Without stage-B tables (forced-small configurations) inverse_real
    takes the full staged inverse: K3 on every column tile."""
    n = 1 << 18
    monkeypatch.setattr(tplan, "stage_b_plannable", lambda n2: False)
    assert tplan.get_stage_b_irfft_plan(n) is None
    log: list = []
    _counting(monkeypatch, tlarge, log)
    x, xr, xi = _hermitian(1, n, 5)
    tplan.clear_device_cache()  # no plan uploaded with stage B
    try:
        _signal_close(tlarge.inverse_real(_t(xr), _t(xi), n, scale=1.0 / n).numpy(), x, n)
    finally:
        tplan.clear_device_cache()  # nor one uploaded without it
    assert log == [(None, 512)]


# ── Gates ────────────────────────────────────────────────────────────────────


def test_gates_are_tuning_driven():
    assert not tplan.irfft_half_applies(1 << 14)
    assert tplan.irfft_half_applies(1 << 15)
    assert not tplan.irfft_half_staged_applies(1 << 17)
    assert tplan.irfft_half_staged_applies(1 << 18)
    for name in ("h100", "cpu-approx"):
        t = ttuning.TUNING[name]
        assert (t.irfft_half_min, t.irfft_half_staged_min, t.irfft_direct_k128) == (1 << 15, 1 << 18, True)


@pytest.mark.parametrize("n", [256, 1 << 15, 1 << 18])
def test_gate_forced_off_through_gpu_fft_tpu_chip(monkeypatch, n):
    """A row with the irfft gates closed, forced with GPU_FFT_TPU_CHIP,
    routes to the full inverse (or the h-deep direct form) and gives the
    same answer; forcing the h100 row keeps the shipped route."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    sp = np.fft.rfft(x.astype(np.float64))
    xr, xi = _t(sp.real.astype(np.float32)), _t(sp.imag.astype(np.float32))
    log: list = []
    _counting(monkeypatch, tlarge, log)
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "h100")
    on = gt.irfft_device(xr, xi).numpy()
    on_calls = list(log)
    closed = replace(ttuning.TUNING["h100"], name="closed", irfft_half_min=1 << 62,
                     irfft_half_staged_min=1 << 62, irfft_direct_k128=False)
    monkeypatch.setitem(ttuning.TUNING, "closed", closed)
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "closed")
    assert not tplan.irfft_half_applies(n) and not tplan.irfft_half_staged_applies(n)
    log.clear()
    off = gt.irfft_device(xr, xi).numpy()
    _close(off, on, rtol=2e-5)
    _signal_close(off, x, n)
    if n == 1 << 18:
        assert on_calls == [(3, 512)] and log == [(None, 512)]


# ── Host API ─────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("length", [2, 100, 1000, 4096, 20000])
def test_rfft_irfft_match_jax(length):
    x = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    re, im = gt.rfft(x, device="cpu")
    jre, jim = gf.rfft(x)
    assert re.dtype == np.float32 and re.shape == jre.shape == (len(jre),)
    _close(np.stack([re, im]), np.stack([jre, jim]))
    out = gt.irfft(re, im, device="cpu")
    jout = gf.irfft(jre, jim)
    assert out.shape == jout.shape
    _close(out, jout)
    n = out.shape[0]
    ref = np.fft.rfft(np.pad(x.astype(np.float64), (0, n - length)))
    assert max(np.abs(re - ref.real).max(), np.abs(im - ref.imag).max()) <= _bound(n) * np.abs(ref).max()
    assert np.abs(out[:length] - x).max() <= _bound(n) * np.abs(x).max()


@pytest.mark.parametrize("b,n", [(1, 1 << 15), (3, 1 << 16), (1, 1 << 17), (2, 1 << 18)])
def test_rfft_device_half_spectrum_sizes(jax_cache, b, n):
    """rfft_device where the forward runs the half-spectrum path, against
    the JAX package and numpy."""
    x = np.random.default_rng(n + b).standard_normal((b, n)).astype(np.float32)
    want = jax_cache(("rfft", b, n), lambda: np.stack([np.asarray(a) for a in gf.rfft_device(jnp.asarray(x))]))
    got = np.stack([a.numpy() for a in gt.rfft_device(_t(x))])
    _close(got, want)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    _close(got, np.stack([ref.real, ref.imag]), rtol=_bound(n))


# ── GPU_FFT_TPU_BACKEND ──────────────────────────────────────────────────────


@pytest.mark.parametrize(
    "value,want",
    [("torch", Backend.TORCH), ("torch_fft", Backend.TORCH_FFT), ("pallas", Backend.TORCH),
     (" XLA ", Backend.TORCH_FFT), ("", Backend.TORCH)],
)
def test_backend_env_routes(monkeypatch, value, want):
    monkeypatch.setenv("GPU_FFT_TPU_BACKEND", value)
    assert default_backend() is want
    x = np.random.default_rng(2).standard_normal(1024).astype(np.float32)
    K.reset_counts()
    re, im = gt.fft(x, device="cpu")
    ref = np.fft.fft(x.astype(np.float64))
    assert max(np.abs(re - ref.real).max(), np.abs(im - ref.imag).max()) <= _bound(1024) * np.abs(ref).max()
    # TORCH runs K2's plain version at (1, 1,024); torch.fft runs none.
    assert (K.COUNTS["whole_transform_packed"].plain_calls == 1) == (want is Backend.TORCH)


@pytest.mark.parametrize("value,match", [("native", "ROADMAP item 10"), ("cuda", "unknown")])
def test_backend_env_rejects(monkeypatch, value, match):
    monkeypatch.setenv("GPU_FFT_TPU_BACKEND", value)
    with pytest.raises(ValueError, match=match):
        default_backend()
    with pytest.raises(ValueError, match=match):
        gt.fft(np.ones(8, np.float32), device="cpu")
