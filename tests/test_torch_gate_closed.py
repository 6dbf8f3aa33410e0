"""The gate-closed engines of the port against the JAX package, on the CPU.

Both packages keep these paths with their gates closed (1 << 62: the JAX
package's ``rfft_pack_min`` and ``axis0_*`` tuning fields, the port's
``plan.RFFT_PACK_MIN`` and ``AXIS0_H_MIN``): the packed real forward
(``kernels/large.py:_real_packed_fft``), the axis-0 column pass
(``transform_axis0`` and its three ``ops/fft2d.py`` branches), the
one-sided fold grid (``fused_irfft_half``) and the packed direct rfft / PSD.
Each is held against the JAX function on the same seeded input, and
against numpy in float64, at the JAX tests' shapes and gates
(``tests/test_kernel_paths.py``, ``test_fft2d.py``, ``test_irfft_half.py``);
gates are opened by monkeypatching, the port's constants and the JAX
package's predicates.  Then the soak and the two ablations, rehearsed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu.kernels.fused_jnp as jfj
import gpu_fft_tpu.kernels.large as jlarge
import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu.tuning as jtuning
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused_torch as tfj
import gpu_fft_tpu_torch.kernels.large as tlarge
import gpu_fft_tpu_torch.plan as tplan
from gpu_fft_tpu_torch.config import FUSED_MAX
from gpu_fft_tpu_torch import tuning
from gpu_fft_tpu_torch.scripts import ablate_fft2_axis0, ablate_rfft_packed, soak
from gpu_fft_tpu_torch.utils import profiling as tprof

PACK_SIZES = (256, 4096, 65536, 1 << 17)
AXIS0_CASES = ((64, 96, False), (512, 130, True), (2048, 64, False))


def _bound(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _rel(got, ref):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    ref = [np.asarray(r, dtype=np.float64) for r in ref]
    return max(np.abs(g - r).max() for g, r in zip(got, ref)) / max(np.abs(r).max() for r in ref)


# ── The packed real forward ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def packed_jax():
    """Input and the JAX ``_real_packed_fft`` output per n, B = 3."""
    out = {}
    for n in PACK_SIZES:
        x = np.random.default_rng(n).uniform(-1.0, 1.0, (3, n)).astype(np.float32)
        yr, yi = jlarge._real_packed_fft(jnp.asarray(x), n, None)
        out[n] = (x, np.asarray(yr), np.asarray(yi))
    return out


@pytest.mark.parametrize("n", PACK_SIZES)
def test_packed_real_forward_matches_jax_and_numpy(packed_jax, n):
    x, jr, ji = packed_jax[n]
    yr, yi = tlarge._real_packed_fft(_t(x), n, None)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    assert _rel((yr, yi), (ref.real, ref.imag)) < 2e-6
    assert _rel((yr, yi), (jr, ji)) < 2e-6


def test_packed_real_forward_folds_the_scale():
    n = 4096
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    yr, yi = tlarge._real_packed_fft(_t(x), n, 1.0 / n)
    ref = np.fft.fft(x.astype(np.float64), axis=-1) / n
    assert _rel((yr, yi), (ref.real, ref.imag)) < 2e-6
    jr, ji = jlarge._real_packed_fft(jnp.asarray(x), n, 1.0 / n)
    assert _rel((yr, yi), (jr, ji)) < 2e-6
    w = tplan.on_device(tlarge._pack_twiddle, n, 1.0 / n, device="cpu")
    wr, _ = tplan.get_pack_tables(n)
    np.testing.assert_array_equal(w["wr"].numpy(), wr * np.float32(0.5 / n))


@pytest.mark.parametrize("n", [8, 16, 64, 128])
def test_packed_real_forward_below_256(n):
    """The port's strided split works from n = 8, the gate's floor; the
    JAX package's 256-wide permutation matmul cannot reshape below 256."""
    x = np.random.default_rng(n).uniform(-1.0, 1.0, (3, n)).astype(np.float32)
    yr, yi = tlarge._real_packed_fft(_t(x), n, None)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    assert _rel((yr, yi), (ref.real, ref.imag)) < 2e-6
    with pytest.raises(TypeError):
        jlarge._real_packed_fft(jnp.asarray(x), n, None)


@pytest.mark.parametrize("b,n", [(1, 65536), (1, 4096), (3, 1 << 18)])
def test_forced_gate_meets_the_roundtrip_gate(b, n, monkeypatch):
    """The gate opened through ``plan.RFFT_PACK_MIN``: transform_any takes the
    packed branch, the JAX package's forced branch agrees (B = 1), and the
    public roundtrip meets 5 log2(N) eps
    (``test_packed_gate_still_meets_roundtrip_gate``)."""
    x = np.random.default_rng(n + b).uniform(-1.0, 1.0, (b, n)).astype(np.float32)
    calls = []
    real = tlarge._real_packed_fft
    monkeypatch.setattr(tlarge, "_real_packed_fft", lambda *a: calls.append(a[1]) or real(*a))
    with monkeypatch.context() as m:
        m.setattr(tplan, "RFFT_PACK_MIN", 256)
        assert tplan.rfft_pack_applies(b, n)
        yr, yi = tlarge.transform_any(_t(x), None, n, -1)
        if b == 1:
            re, im = gt.fft(x[0], device="cpu")
            out = gt.ifft(re, im, device="cpu")
            assert np.abs(out[:n] - x[0]).max() <= _bound(n)
    assert calls == [n] * (2 if b == 1 else 1)
    assert not tplan.rfft_pack_applies(b, n) and tplan.RFFT_PACK_MIN == 1 << 62
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    assert _rel((yr, yi), (ref.real, ref.imag)) < _bound(n)
    if b == 1:  # (the JAX half transform at 2^17 runs Pallas in interpret mode)
        monkeypatch.setattr(jlarge, "rfft_pack_applies", lambda b, n: n >= 256)
        jr, ji = jlarge.transform_any(jnp.asarray(x), None, n, -1)
        assert _rel((yr, yi), (jr, ji)) < 2e-6


@pytest.mark.parametrize("b,n", [(1, 4096), (2, 4096), (1, 1 << 18)])
def test_gradient_through_the_packed_branch(b, n, monkeypatch):
    """d/dx of a weighted sum of the spectrum through the packed branch (the
    strided split, K1's or K3's autograd seam at n/2, the epilogue) equals
    the gradient through the closed route."""
    rng = np.random.default_rng(n + 7 * b)
    x = _t(rng.standard_normal((b, n)))
    wr, wi = _t(rng.standard_normal((b, n))), _t(rng.standard_normal((b, n)))

    def grad():
        xx = x.clone().requires_grad_(True)
        yr, yi = tlarge.transform_any(xx, None, n, -1)
        (g,) = torch.autograd.grad((yr * wr + yi * wi).sum(), xx)
        return g.numpy()

    closed = grad()
    monkeypatch.setattr(tplan, "RFFT_PACK_MIN", 8)
    packed = grad()
    assert _rel((packed,), (closed,)) < 1e-5


# ── The axis-0 column pass ───────────────────────────────────────────────────


@pytest.mark.parametrize("h,w,cx", AXIS0_CASES)
def test_transform_axis0_matches_jax_and_numpy(h, w, cx):
    rng = np.random.default_rng(h + w)
    x = rng.standard_normal((h, w)).astype(np.float32)
    xi = rng.standard_normal((h, w)).astype(np.float32) if cx else None
    yr, yi = tfj.transform_axis0(_t(x), None if xi is None else _t(xi), h, -1)
    jr, ji = jfj.transform_axis0(jnp.asarray(x), None if xi is None else jnp.asarray(xi), h, -1)
    ref = np.fft.fft((x if xi is None else x + 1j * xi).astype(np.complex128), axis=0)
    assert _rel((yr, yi), (ref.real, ref.imag)) < 3e-6
    assert _rel((yr, yi), (jr, ji)) < 3e-6


def test_transform_axis0_inverse_with_scale_and_lead_axes():
    x = np.random.default_rng(3).standard_normal((2, 256, 48)).astype(np.float32)
    yr, yi = tfj.transform_axis0(_t(x), None, 256, +1, scale=1.0 / 256)
    ref = np.fft.ifft(x.astype(np.complex128), axis=1)
    assert yr.shape == (2, 256, 48) and np.abs(yr.numpy() - ref.real).max() < 1e-6
    jr, ji = jfj.transform_axis0(jnp.asarray(x), None, 256, +1, scale=1.0 / 256)
    assert _rel((yr, yi), (jr, ji)) < 3e-6


@pytest.fixture
def axis0_calls(monkeypatch):
    """The axis-0 gate opened in both packages; the port's engine calls, logged."""
    calls = []
    real = tfj.transform_axis0
    monkeypatch.setattr(tfj, "transform_axis0", lambda xr, xi, n, *a, **k: calls.append(n) or real(xr, xi, n, *a, **k))
    monkeypatch.setattr(jplan, "axis0_applies", lambda h, w: h & (h - 1) == 0)
    with monkeypatch.context() as m:
        m.setattr(tplan, "AXIS0_H_MIN", 2)
        yield calls
    assert not tplan.axis0_applies(4096, 4096)


@pytest.mark.parametrize("shape", [(512, 96), (2, 128, 64)])
def test_fft2_and_ifft2_through_the_axis0_branch(axis0_calls, shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    yr, yi = gt.fft2_device(_t(x))
    ref = np.fft.fft2(x.astype(np.float64))
    assert _rel((yr, yi), (ref.real, ref.imag)) < 3e-6
    jr, ji = gf.fft2_device(x)
    assert _rel((yr, yi), (jr, ji)) < 3e-6
    br, bi = gt.ifft2_device(yr, yi)
    assert np.abs(br.numpy() - x).max() < 5e-4 and np.abs(bi.numpy()).max() < 5e-4
    assert axis0_calls == [shape[-2]] * 2


def test_rfft2_and_irfft2_through_the_axis0_branch(axis0_calls):
    x = np.random.default_rng(11).standard_normal((256, 256)).astype(np.float32)
    yr, yi = gt.rfft2_device(_t(x))
    ref = np.fft.rfft2(x.astype(np.float64))
    assert _rel((yr, yi), (ref.real, ref.imag)) < 3e-6
    jr, ji = gf.rfft2_device(x)
    assert _rel((yr, yi), (jr, ji)) < 3e-6
    back = gt.irfft2_device(yr, yi)
    assert np.abs(back.numpy() - x).max() < 5e-4
    jback = gf.irfft2_device(jr, ji)
    assert _rel((back,), (jback,)) < 3e-6
    assert axis0_calls == [256, 256]


def test_axis0_predicate_matches_jax_when_open(monkeypatch):
    """Opened from the same H in both packages, the predicates agree on every
    shape: a power-of-two H from h_min up to the engine's FUSED_MAX (the
    port's bound; the JAX row's h_max set to it) and H > W/2 (the JAX row's
    w_min set to 0: the port has no width floor)."""
    fields = dict(axis0_h_min=64, axis0_h_max=FUSED_MAX, axis0_w_min=0)
    opened = dataclasses.replace(jtuning.get_tuning(), **fields)
    monkeypatch.setattr(jplan, "get_tuning", lambda: opened)
    monkeypatch.setattr(tplan, "AXIS0_H_MIN", 64)
    for h in (32, 64, 96, 128, 4096, 8192, FUSED_MAX, 2 * FUSED_MAX):
        for w in (16, 32, 100, 128, 256, 8192):
            assert tplan.axis0_applies(h, w) == jplan.axis0_applies(h, w), (h, w)
    assert tplan.axis0_applies(128, 100) and not tplan.axis0_applies(128, 256)


# ── The one-sided fold grid and the packed direct rfft ──────────────────────


@pytest.fixture(scope="module")
def irfft_half_jax():
    """A (3, n) signal, its one-sided spectrum in f32 and the JAX
    ``fused_irfft_half_jnp`` output, per n."""
    out = {}
    for n in (1 << 15, 1 << 16):
        x = np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)
        sp = np.fft.rfft(x.astype(np.float64))
        xr, xi = sp.real.astype(np.float32), sp.imag.astype(np.float32)
        jy = jfj.fused_irfft_half_jnp(jnp.asarray(xr), jnp.asarray(xi), jplan.get_irfft_plan(n, scale=1.0 / n))
        out[n] = (x, xr, xi, np.asarray(jy))
    return out


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_irfft_half_matches_numpy_and_jax(irfft_half_jax, n, b):
    x, xr, xi, jy = (a[:b] for a in irfft_half_jax[n])
    y = tfj.fused_irfft_half(_t(xr), _t(xi), tplan.on_device(tplan.get_irfft_plan, n, 1.0 / n, None, device="cpu"))
    assert np.abs(y.numpy() - x).max() < _bound(n)
    assert np.abs(y.numpy() - jy).max() < _bound(n)


def test_fused_irfft_half_ignores_dc_nyquist_imag():
    n = 1 << 15
    x = np.random.default_rng(1).standard_normal((1, n)).astype(np.float32)
    sp = np.fft.rfft(x.astype(np.float64))
    xi = sp.imag.astype(np.float32)
    xi[:, 0], xi[:, -1] = 7.0, -3.0
    y = tfj.fused_irfft_half(_t(sp.real), _t(xi), tplan.on_device(tplan.get_irfft_plan, n, 1.0 / n, None, device="cpu"))
    assert np.abs(y.numpy() - x).max() < _bound(n)


@pytest.mark.parametrize("n", [256, 512])
def test_rfft_direct_packed_matches_numpy_and_jax(n):
    x = np.random.default_rng(3).standard_normal((4, n)).astype(np.float32)
    out, fr, fi = tfj.rfft_direct_packed(_t(x), tplan.on_device(tplan.get_rfft_direct_packed_plan, n, None,
                                                                 device="cpu"))
    ref = np.fft.rfft(x.astype(np.float64))
    assert out.shape == (4, n) and fr.shape == fi.shape == (4, n // 2 + 1)
    assert _rel((fr, fi), (ref.real, ref.imag)) < 1e-6
    _, jr, ji = jfj.rfft_direct_packed_jnp(jnp.asarray(x), jplan.get_rfft_direct_packed_plan(n))
    assert _rel((fr, fi), (jr, ji)) < 1e-6


@pytest.mark.parametrize("n", [8, 256])
def test_rfft_packed_psd_matches_numpy_and_jax(n):
    x = np.random.default_rng(6).standard_normal((7, n)).astype(np.float32)
    psd = tfj.rfft_packed_psd(_t(x), tplan.on_device(tplan.get_rfft_direct_packed_plan, n, None, device="cpu"))
    ref = np.abs(np.fft.rfft(x.astype(np.float64))) ** 2
    assert _rel((psd,), (ref,)) < 1e-5
    jp = jfj.rfft_packed_psd_jnp(jnp.asarray(x), jplan.get_rfft_direct_packed_plan(n))
    assert _rel((psd,), (jp,)) < 1e-5


@pytest.mark.parametrize("n,scale", [(8, None), (256, None), (512, 1.0 / 512)])
def test_plans_are_the_jax_packages(n, scale):
    for a, b in zip(tplan.get_pack_tables(n), jplan.get_pack_tables(n)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tplan.get_rfft_direct_packed_plan(n, scale)["t"],
                                  jplan.get_rfft_direct_packed_plan(n, scale)["t"])
    with pytest.raises(ValueError):
        tplan.get_rfft_direct_packed_plan(1024)


# ── The gates as shipped ─────────────────────────────────────────────────────


@pytest.mark.parametrize("row", ["h100", "cpu-approx"])
def test_every_gate_closed_by_default(row, monkeypatch):
    """The port's thresholds are the JAX rows' closed values, and no tuning
    row (nor any other process-wide setting) opens a gate."""
    v5e = jtuning.TUNING["v5e"]
    assert (tplan.RFFT_PACK_MIN, tplan.AXIS0_H_MIN) == (v5e.rfft_pack_min, v5e.axis0_h_min) == (1 << 62, 1 << 62)
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", row)
    assert tuning.get_tuning().name == row
    assert not any(tplan.rfft_pack_applies(b, 1 << k) for b in (1, 3, 64) for k in range(3, 25))
    assert not any(tplan.axis0_applies(h, w) for h in (512, 2048, 4096, 8192) for w in (96, 512, 4096))


# ── The soak and the two ablations ───────────────────────────────────────────


def test_soak_runs_on_the_cpu(capsys):
    assert soak.main(["--device", "cpu", "--iters", "3", "--analysis-iters", "3", "--max-bytes", str(1 << 22)]) == 0
    out = capsys.readouterr().out
    assert "soak: 6/6 ok on cpu" in out and "FAIL" not in out


def test_soak_counts_an_exception_as_a_failure(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no")

    monkeypatch.setattr(gt, "fft_device", broken)
    assert soak.run(iters=2, analysis_iters=0, max_bytes=1 << 20, device="cpu") == (2, 2)
    assert soak.main(["--device", "cpu", "--iters", "1", "--analysis-iters", "0"]) == 1
    assert "EXCEPTION RuntimeError" in capsys.readouterr().out


@pytest.mark.parametrize("seed,drawn", [(23, "-0.62"), (1, "0.72")])
def test_soak_reports_a_clipped_fht_draw_ungated(seed, drawn):
    """A bias past the condition-number cap is gated clipped and also run as
    drawn, its error reported beside the draw but not gated (a non-finite
    one included)."""
    desc, err, good = soak._analysis_case("fht", np.random.default_rng(seed), "cpu")
    assert f"(drawn q={drawn}: err " in desc and desc.endswith(", not gated)")
    assert good and err < soak.GATE


@pytest.fixture
def rehearsal(monkeypatch):
    """The card-only calls replaced: the chained timer runs the step once and
    checks that it keeps its shape."""

    def fake_stats(step, x0, **kw):
        assert step(x0).shape == x0.shape
        return tprof.TimingStats(2e-6, 1e-8, 2e-6, 2e-6, 1, 10, False)

    monkeypatch.setattr(tprof, "chained_step_stats", fake_stats)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu rehearsal")


def test_ablate_rfft_packed_rehearsal(rehearsal, monkeypatch, tmp_path):
    monkeypatch.setattr(ablate_rfft_packed, "QUICK_GATE_SHAPES", ((1, 4096), (3, 1 << 17)))
    res = ablate_rfft_packed.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert [(r["what"], r["b"], r["n"]) for r in res["rows"]] == [
        ("fwd", 253, 256), ("psd", 253, 256), ("gate", 1, 4096), ("gate", 3, 1 << 17)]
    assert not ablate_rfft_packed.parity_failures(res)
    assert (tmp_path / "ablate_rfft_packed_results.json").is_file()
    assert tplan.RFFT_PACK_MIN == 1 << 62 and not tplan.rfft_pack_applies(1, 1 << 22)


def test_ablate_fft2_axis0_rehearsal(rehearsal, monkeypatch, tmp_path):
    monkeypatch.setattr(ablate_fft2_axis0, "QUICK_LEG", ((256, 128),))
    monkeypatch.setattr(ablate_fft2_axis0, "QUICK_COMPOSED", ((512, 256),))
    res = ablate_fft2_axis0.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert [(r["h"], r["w"], r["complex"]) for r in res["isolated_leg"]] == [(256, 128, False), (256, 128, True)]
    assert [(r["h"], r["w"]) for r in res["composed_fft2"]] == [(512, 256)]
    assert not ablate_fft2_axis0.parity_failures(res)
    assert not tplan.axis0_applies(512, 256)
