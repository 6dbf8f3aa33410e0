"""The port's transform path against the JAX package, on the CPU.

``transform_any`` is compared engine for engine: the same (B, n) must reach
the same kernel in both packages (the JAX side's Pallas kernels run in
interpret mode).  The public API (fft, ifft, fft_batch, ifft_batch, psd) and
the reference demo are compared end to end.

Tolerance: max |port - JAX| <= 1e-5 * max |JAX| (fp32 on both sides from
bit-identical tables, different summation order; see test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.kernels.large as jlarge
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
from gpu_fft_tpu_torch.kernels.large import transform_any

RTOL = 1e-5
KERNELS = ("whole_transform", "whole_transform_packed", "stage_a")
SHAPES = [(1, 256), (1, 1024), (1, 4096), (2, 4096), (16, 4096), (1, 65536), (1, 1 << 17)]
# The kernel each (B, n) reaches (gpu_fft_tpu/kernels/large.py:transform_any).
EXPECTED = {
    (1, 1024): "whole_transform_packed",
    (1, 4096): "whole_transform",
    (1, 1 << 17): "stage_a",
}


def _gate(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


def _assert_close(got, want, rtol=RTOL):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= rtol * scale, f"max|d| {err:.3e} > {rtol} * {scale:.3e}"


def _inputs(b, n):
    rng = np.random.default_rng(b * 1000003 + n)
    return (
        rng.standard_normal((b, n)).astype(np.float32),
        rng.standard_normal((b, n)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_results():
    """JAX transform_any outputs per (B, n), and which Pallas kernel ran."""
    real = {name: getattr(jlarge, name) for name in KERNELS}
    ran: dict = {}

    def counting(name):
        def wrapper(*args, **kwargs):
            ran[name] = ran.get(name, 0) + 1
            return real[name](*args, **kwargs)

        return wrapper

    out = {}
    try:
        for name in KERNELS:
            setattr(jlarge, name, counting(name))
        for b, n in SHAPES:
            xr, xi = _inputs(b, n)
            ran.clear()
            fwd = jlarge.transform_any(jnp.asarray(xr), None, n, -1)
            fwd_ran = set(ran)
            ran.clear()
            inv = jlarge.transform_any(jnp.asarray(xr), jnp.asarray(xi), n, 1, scale=1.0 / n)
            out[(b, n)] = dict(
                fwd=[np.asarray(a) for a in fwd], inv=[np.asarray(a) for a in inv],
                fwd_ran=fwd_ran, inv_ran=set(ran),
            )
    finally:
        for name in KERNELS:
            setattr(jlarge, name, real[name])
    return out


@pytest.mark.parametrize("b,n", SHAPES)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_transform_any_matches_jax(jax_results, b, n, direction):
    ref = jax_results[(b, n)]
    xr, xi = _inputs(b, n)
    K.reset_counts()
    if direction == "fwd":
        got = transform_any(torch.from_numpy(xr), None, n, -1)
    else:
        got = transform_any(torch.from_numpy(xr), torch.from_numpy(xi), n, 1, scale=1.0 / n)
    _assert_close([g.numpy() for g in got], ref[direction])
    # Same engine: the kernel the JAX path ran is the one the port ran.
    assert ref[f"{direction}_ran"] == ({EXPECTED[(b, n)]} if (b, n) in EXPECTED else set())
    ran = {name for name in KERNELS if K.COUNTS[name].plain_calls}
    assert ran == ref[f"{direction}_ran"]
    assert all(K.COUNTS[name].launches == 0 for name in KERNELS)


@pytest.mark.parametrize("length", [1, 2, 100, 1000, 4096, 20000])
def test_fft_ifft_match_jax(length):
    x = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    re, im = gt.fft(x, device="cpu")
    jre, jim = gf.fft(x)
    assert re.dtype == np.float32 and re.shape == jre.shape
    _assert_close([re, im], [jre, jim])
    out = gt.ifft(re, im, device="cpu")
    jout = gf.ifft(jre, jim)
    assert out.shape == jout.shape == (2 * len(re),)
    _assert_close([out], [jout])
    n = len(re)
    if n > 1:
        assert np.abs(out[:length] - x).max() <= _gate(n) * max(1.0, np.abs(x).max())


def test_batch_api_matches_jax():
    rng = np.random.default_rng(5)
    signals = [rng.standard_normal(m).astype(np.float32) for m in (700, 1000, 1024)]
    specs = gt.fft_batch(signals, device="cpu")
    jspecs = gf.fft_batch(signals)
    assert len(specs) == len(jspecs) == 3
    for (r, i), (jr, ji) in zip(specs, jspecs):
        _assert_close([r, i], [jr, ji])
    outs = gt.ifft_batch(specs, device="cpu")
    jouts = gf.ifft_batch(jspecs)
    for o, jo, s in zip(outs, jouts, signals):
        _assert_close([o], [jo])
        assert np.abs(o[: len(s)] - s).max() <= _gate(1024) * 4
    assert gt.fft_batch([], device="cpu") == [] and gt.ifft_batch([], device="cpu") == []


def test_psd_and_device_api():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    re, im = gt.fft_device(torch.from_numpy(x))
    assert re.device.type == "cpu" and re.shape == (3, 4096)
    jre, jim = gf.fft_device(x)
    _assert_close([re.numpy(), im.numpy()], [jre, jim])
    np.testing.assert_array_equal(gt.psd(re.numpy(), im.numpy()), gf.psd(re.numpy(), im.numpy()))
    _assert_close([gt.psd_device(re, im).numpy()], [gf.psd_device(jre, jim)])
    p = gt.power_spectrum_device(torch.from_numpy(x))
    _assert_close([p.numpy()], [gf.power_spectrum_device(x)])
    assert gt.one_sided_bins(4096) == 2049
    yr, yi = gt.ifft_device(re[0], im[0])
    assert yr.shape == (4096,)
    assert np.abs(yr.numpy() - x[0]).max() <= _gate(4096) * 4


def test_simple_demo_end_to_end():
    """sine -> fft -> psd -> dominant frequency -> ifft -> roundtrip gate."""
    wave = gt.generate_sine_wave(15.0, 200.0, 5.0)
    np.testing.assert_array_equal(wave, gf.utils.generate_sine_wave(15.0, 200.0, 5.0))
    re, im = gt.fft(wave, device="cpu")
    n = len(re)
    assert (len(wave), n) == (1000, 1024)
    p = gt.psd(re, im)
    freqs = gt.calculate_one_sided_frequencies(n, 200.0)
    dominant = gt.find_dominant_frequencies(p[: n // 2 + 1], freqs, threshold=100.0)
    assert len(dominant) == 1 and f"{dominant[0][0]:.2f}" == "15.04"
    jre, jim = gf.fft(wave)
    jdom = gf.utils.find_dominant_frequencies(gf.psd(jre, jim)[: n // 2 + 1], freqs, 100.0)
    assert dominant[0][0] == jdom[0][0]
    out = gt.ifft(re, im, device="cpu")
    assert np.abs(out[: len(wave)] - wave).max() <= _gate(n)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(1024, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        gt.fft(x, device="cuda")
    monkeypatch.delenv("GPU_FFT_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        gt.fft(x)
    with pytest.raises(RuntimeError, match="cuda"):
        gt.fft_device(x)


def test_device_env_default(monkeypatch):
    monkeypatch.setenv("GPU_FFT_TPU_TORCH_DEVICE", "cpu")
    re, im = gt.fft(np.arange(8, dtype=np.float32))
    ref = np.fft.fft(np.arange(8.0))
    np.testing.assert_allclose(re, ref.real, atol=1e-5)
    np.testing.assert_allclose(im, ref.imag, atol=1e-5)


def test_torch_fft_backend_matches():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    a = gt.fft(x, device="cpu")
    b = gt.fft_with(x, gt.Backend.TORCH_FFT, device="cpu")
    _assert_close(a, b)
    out = gt.ifft_with(*a, "torch_fft", device="cpu")
    _assert_close([out], [gt.ifft(*a, device="cpu")])
    assert gt.available_backends() == [gt.Backend.TORCH, gt.Backend.TORCH_FFT]
    assert gt.default_backend() is gt.Backend.TORCH


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda: gt.ifft(np.ones(3), np.ones(3), device="cpu"), "power of two"),
        (lambda: gt.ifft(np.ones(4), np.ones(8), device="cpu"), "equal-length"),
        (lambda: gt.fft(np.ones((2, 2)), device="cpu"), "1-D"),
        (lambda: gt.fft_device(torch.ones(6)), "power-of-two"),
        (lambda: gt.fft(np.ones((1 << 24) + 1, np.float32), device="cpu"), "exceeds"),
    ],
)
def test_input_validation(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("complex_", [False, True])
def test_recursive_stage_b_matches_folded(monkeypatch, complex_):
    """A plan without stage-B tables (forced-small configs) takes the
    recursive row transforms + digit reversal, with the same result."""
    import gpu_fft_tpu_torch.kernels.large as tlarge

    n = 1 << 17
    xr, xi = _inputs(1, n)
    args = (torch.from_numpy(xr), torch.from_numpy(xi) if complex_ else None, n, -1)
    want = transform_any(*args)
    real_plan = tlarge.get_stage_a_plan

    def without_stage_b(*a):
        return dict(real_plan(*a), stage_b=None)

    monkeypatch.setattr(tlarge, "get_stage_a_plan", without_stage_b)
    got = transform_any(*args)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want])
