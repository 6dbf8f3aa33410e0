"""The precision modes of the port (GPU_FFT_TPU_PRECISION = full | high | fast)
against the JAX package's, on the CPU.

A port of ``tests/test_precision.py`` case for case (the bands on the fused
four-step at n = 16,384, the poisoned stage-A kernel under "high", the
invalid mode), plus:

* the band ordering full < high < fast, which the JAX test asserts only on
  a TPU: the port's engines round their operands to bf16 on the CPU too
  (kernels/fused_torch.py), so the modes trade accuracy here as well;
* the port under each mode against the JAX package (whose CPU dots are
  exact f32 in every mode) within the mode's band, through
  ``transform_any`` and ``inverse_real``;
* the routing: "high" never reaches K1/K2/K3 nor their "fast" kernels,
  "fast" reaches K2F/K1F/K3F and not K1/K2/K3;
* the plain versions of K2F / K1F / K3F against a numpy float64 evaluation
  of the JAX bodies (``gpu_fft_tpu/kernels/fused.py:109-150``, ``:312-381``)
  with each operand rounded through ``ml_dtypes.bfloat16`` where the body's
  ``_dot`` takes it, within 1e-3 max|ref| (a one-ulp fp32 difference before
  Z's bf16 rounding can move one intermediate by a bf16 ulp, 2^-8);
* a Parseval gradient in each mode, and the staged irfft's gradient
  (its autograd seam) against the "full" one;
* flipping the mode inside one process: each mode gives its own result.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import gpu_fft_tpu.kernels.large as jlarge
from gpu_fft_tpu import config as jconfig
from gpu_fft_tpu import plan as jplan
from gpu_fft_tpu_torch import config
from gpu_fft_tpu_torch import plan as tplan
from gpu_fft_tpu_torch.kernels import fused as K
from gpu_fft_tpu_torch.kernels import large
from gpu_fft_tpu_torch.kernels.fused_torch import fused_fft_folded

BANDS = {"full": 1e-6, "high": 2e-4, "fast": 2e-2}
MODES = tuple(BANDS)
# (B, n) through transform_any: K2's band, K1's band, the torch four-step,
# the staged path (K3).
SHAPES = ((1, 1024), (1, 4096), (2, 4096), (1, 1 << 17))
IRFFT_N = 1 << 18  # the staged real-output inverse (K3 on half the column tiles)


@pytest.fixture
def mode(monkeypatch):
    """Set the port's mode for one test; monkeypatch puts "full" back."""

    def set_mode(m):
        monkeypatch.setattr(config, "PRECISION", m)

    return set_mode


def _rel(got, ref):
    got = [np.asarray(g, np.float64) for g in got]
    ref = [np.asarray(r, np.float64) for r in ref]
    return max(np.abs(g - r).max() for g, r in zip(got, ref)) / max(np.abs(r).max() for r in ref)


def _rel_err(m, mode, rng, n=16384):
    """The JAX test's ``_rel_err`` on the port's folded four-step."""
    mode(m)
    x = rng.uniform(-1.0, 1.0, (1, n)).astype(np.float32)
    yr, yi = fused_fft_folded(torch.from_numpy(x), None, tplan.on_device(tplan.get_fused_plan, n, -1, device="cpu"))
    ref = np.fft.fft(x[0].astype(np.float64))
    return _rel((yr[0], yi[0]), (ref.real, ref.imag))


# ── tests/test_precision.py, case for case ───────────────────────────────────


@pytest.mark.parametrize("m", MODES)
def test_modes_stay_within_band(m, mode, rng):
    assert _rel_err(m, mode, rng) < BANDS[m]


def test_full_meets_gate_and_bands_order(mode, rng):
    e_full = _rel_err("full", mode, rng)
    assert e_full < 1e-6
    # The JAX test asserts the rest only on a TPU; the port's modes trade
    # accuracy on every device.
    e_high = _rel_err("high", mode, rng)
    e_fast = _rel_err("fast", mode, rng)
    assert e_full < e_high < e_fast
    assert 1e-6 < e_high < 2e-4
    assert 1e-4 < e_fast < 2e-2


def test_high_routes_staged_stage_a_through_torch(mode, monkeypatch, rng):
    """Under "high" the staged path must not reach the stage-A kernel (it
    has no bf16x3 form): poisoned, "high" never calls it and "full" does."""
    n = 1 << 17
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, n)).astype(np.float32))

    def poisoned(*a, **k):
        raise AssertionError("stage_a kernel used under precision=high")

    mode("high")
    monkeypatch.setattr(large, "stage_a", poisoned)
    yr, yi = large.transform_any(x, None, n, -1)
    ref = np.fft.fft(x[0].double().numpy())
    assert _rel((yr[0], yi[0]), (ref.real, ref.imag)) < 2e-4

    mode("full")
    with pytest.raises(AssertionError, match="precision=high"):
        large.transform_any(x, None, n, -1)


def test_invalid_mode_rejected(mode):
    mode("bogus")
    with pytest.raises(KeyError):
        config.matmul_precision()


# ── The port against the JAX package, mode by mode ───────────────────────────


def _inputs(b, n):
    rng = np.random.default_rng(7 * n + b)
    return rng.standard_normal((b, n)).astype(np.float32), rng.standard_normal((b, n)).astype(np.float32)


def _hermitian(n):
    rng = np.random.default_rng(n + 11)
    sp = np.fft.fft(rng.standard_normal((1, n)), axis=-1)
    return sp.real.astype(np.float32), sp.imag.astype(np.float32)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's transform_any (forward real, inverse complex 1/n)
    per ((B, n), mode), and its inverse_real at IRFFT_N per mode."""
    saved = jconfig.PRECISION
    out = {}
    try:
        for m in MODES:
            jconfig.PRECISION = m
            for b, n in SHAPES:
                xr, xi = _inputs(b, n)
                fwd = jlarge.transform_any(jnp.asarray(xr), None, n, -1)
                inv = jlarge.transform_any(jnp.asarray(xr), jnp.asarray(xi), n, 1, scale=1.0 / n)
                out[(b, n), m] = ([np.asarray(a) for a in fwd], [np.asarray(a) for a in inv])
            sr, si = _hermitian(IRFFT_N)
            out["irfft", m] = np.asarray(jlarge.inverse_real(jnp.asarray(sr), jnp.asarray(si), IRFFT_N,
                                                             scale=1.0 / IRFFT_N))
    finally:
        jconfig.PRECISION = saved
    return out


@pytest.mark.parametrize("m", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_transform_any_matches_jax_within_band(shape, m, mode, jax_results):
    b, n = shape
    mode(m)
    xr, xi = _inputs(b, n)
    fwd = large.transform_any(torch.from_numpy(xr), None, n, -1)
    inv = large.transform_any(torch.from_numpy(xr), torch.from_numpy(xi), n, 1, scale=1.0 / n)
    jfwd, jinv = jax_results[shape, m]
    assert _rel(fwd, jfwd) < BANDS[m]
    assert _rel(inv, jinv) < BANDS[m]


@pytest.mark.parametrize("m", MODES)
def test_inverse_real_matches_jax_within_band(m, mode, jax_results):
    mode(m)
    sr, si = _hermitian(IRFFT_N)
    got = large.inverse_real(torch.from_numpy(sr), torch.from_numpy(si), IRFFT_N, scale=1.0 / IRFFT_N)
    assert _rel((got,), (jax_results["irfft", m],)) < BANDS[m]


# ── Routing ──────────────────────────────────────────────────────────────────

# The kernel each (B, n) reaches under "full" and "fast" (whose band stops
# at B = 1); "high" reaches none.  At staged sizes "full" also runs K4
# (``stage_b``) on the complex call's stage B.
ROUTES = {
    (1, 1024): ("whole_transform_packed", "whole_transform_packed_bf16"),
    (1, 4096): ("whole_transform", "whole_transform_bf16"),
    (1, 16384): ("whole_transform", "whole_transform_bf16"),
    (2, 4096): ("whole_transform", None),
    (1, 1 << 17): ("stage_a", "stage_a_bf16"),
}


@pytest.mark.parametrize("m", MODES)
@pytest.mark.parametrize("shape", list(ROUTES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_mode_reaches_its_kernels(shape, m, mode):
    b, n = shape
    mode(m)
    xr, xi = (torch.from_numpy(a) for a in _inputs(b, n))
    K.reset_counts()
    large.transform_any(xr, None, n, -1)
    large.transform_any(xr, xi, n, 1)
    ran = {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls}
    full_kernel, fast_kernel = ROUTES[shape]
    want = {"full": full_kernel, "high": None, "fast": fast_kernel}[m]
    k4 = {"stage_b": 1} if m == "full" and n > 65536 else {}  # the complex call's stage B only
    assert ran == ({want: 2} if want else {}) | k4


@pytest.mark.parametrize("m", MODES)
def test_staged_irfft_reaches_its_kernel(m, mode):
    """The staged real-output inverse: K3 (full), K3F (fast) on the first
    column tiles, the torch stage A under "high" (JAX ``large.py:150``)."""
    mode(m)
    sr, si = _hermitian(IRFFT_N)
    K.reset_counts()
    large.inverse_real(torch.from_numpy(sr), torch.from_numpy(si), IRFFT_N)
    ran = {k for k, c in K.COUNTS.items() if c.plain_calls}
    assert ran == {"full": {"stage_a"}, "high": set(), "fast": {"stage_a_bf16"}}[m]


def test_high_keeps_the_whole_band_out(mode, monkeypatch):
    """Under "high" the band's (B, n) falls through to the torch engines:
    the whole-transform kernels are never called."""

    def poisoned(*a, **k):
        raise AssertionError("whole-transform kernel used under precision=high")

    mode("high")
    for name in ("whole_transform", "whole_transform_packed"):
        monkeypatch.setattr(large, name, poisoned)
    for n in (1024, 4096, 16384):
        xr, _ = _inputs(1, n)
        yr, yi = large.transform_any(torch.from_numpy(xr), None, n, -1)
        ref = np.fft.fft(xr[0].astype(np.float64))
        assert _rel((yr[0], yi[0]), (ref.real, ref.imag)) < BANDS["high"]


@pytest.mark.parametrize("m", MODES)
@pytest.mark.parametrize("b,n", [(1, 1024), (1, 4096), (2, 4096), (1, 1 << 17)])
def test_describe_plan_follows_the_mode(b, n, m, mode):
    """describe_plan names the kernel ``transform_any`` runs in each mode."""
    mode(m)
    info = tplan.describe_plan(n, batch=b)
    K.reset_counts()
    large.transform_any(torch.zeros(b, n), None, n, -1)
    ran = {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls}
    fast = "_bf16" if m == "fast" else ""
    want = {"whole": {info.get("kernel"): 1},
            "staged": {} if m == "high" else {"stage_a" + fast: 1}}.get(info["path"], {})
    assert ran == want, (info, ran)
    assert info["precision"] == m
    if info["path"] == "whole":
        assert info["kernel"].endswith(fast) and m != "high"


# ── K2F / K1F / K3F: the plain versions against the JAX bodies in float64 ────


def _b(a):
    """An operand as a DEFAULT dot takes it: fp32 rounded to bf16 (to
    nearest even), here in float64."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _whole_ref(xr, xi, plan, packed):
    """``_whole_packed_*_kernel`` / ``_whole_*_kernel`` (fused.py:326-381)
    for each row, in float64 with bf16 operands."""
    n1 = plan["n1"]
    out_r, out_i = [], []
    for r in range(xr.shape[0]):
        x = xr[r].reshape(n1, 128)
        y = None if xi is None else xi[r].reshape(n1, 128)
        if packed:
            t = plan["packed"]
            f1 = t[0: 2 * n1, 0:n1]
            if y is None:
                p = _b(f1) @ _b(x)
                pr, pi = p[:n1], p[n1:]
            else:
                p, q = _b(f1) @ _b(x), _b(f1) @ _b(y)
                pr, pi = p[:n1] - q[n1:], p[n1:] + q[:n1]
            twr, twi = _f32(t[2 * n1: 3 * n1]), _f32(t[3 * n1: 4 * n1])
        else:
            if y is None:
                pr, pi = _b(plan["f1r"]) @ _b(x), _b(plan["f1i"]) @ _b(x)
            else:
                k1 = _b(plan["f1r"]) @ _b(_f32(x) + _f32(y))
                k2 = _b(plan["f1d"]) @ _b(x)
                k3 = _b(plan["f1s"]) @ _b(y)
                pr, pi = k1 - k3, k1 + k2
            twr, twi = _f32(plan["twr"]), _f32(plan["twi"])
        zr, zi = pr * twr - pi * twi, pr * twi + pi * twr
        if packed:
            f2 = plan["packed"][4 * n1: 4 * n1 + 256]
            a, c = _b(f2) @ _b(zr).T, _b(f2) @ _b(zi).T
            yr, yi = a[:128] - c[128:], c[:128] + a[128:]
        else:
            k1 = _b(plan["f2r"]) @ _b(zr + zi).T
            k2 = _b(plan["f2d"]) @ _b(zr).T
            k3 = _b(plan["f2s"]) @ _b(zi).T
            yr, yi = k1 - k3, k1 + k2
        out_r.append(yr.reshape(-1))
        out_i.append(yi.reshape(-1))
    return np.stack(out_r), np.stack(out_i)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("kernel,n,b", [
    ("whole_transform_packed_bf16", 1024, 1), ("whole_transform_packed_bf16", 2048, 2),
    ("whole_transform_bf16", 1024, 1), ("whole_transform_bf16", 4096, 1), ("whole_transform_bf16", 16384, 2),
])
def test_whole_bf16_plain_matches_the_jax_body(kernel, n, b, complex_):
    packed = kernel == "whole_transform_packed_bf16"
    make = jplan.get_whole_packed_plan if packed else jplan.get_whole_plan
    sign, scale = (1, 1.0 / n) if complex_ else (-1, None)
    jp = make(n, sign, scale=scale)
    tp = tplan.on_device(tplan.get_whole_packed_plan if packed else tplan.get_whole_plan, n, sign, scale,
                         device="cpu")
    xr, xi = _inputs(b, n)
    xi = xi if complex_ else None
    got = getattr(K, kernel + "_plain")(torch.from_numpy(xr), None if xi is None else torch.from_numpy(xi), tp)
    ref = _whole_ref(xr, xi, {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in jp.items()}, packed)
    assert _rel(got, ref) <= 1e-3
    # The bf16 product is a real cut: the plain fp32 kernel is far closer.
    fp32 = getattr(K, kernel.removesuffix("_bf16") + "_plain")(
        torch.from_numpy(xr), None if xi is None else torch.from_numpy(xi), tp)
    assert _rel(fp32, ref) > 1e-4


def _stage_a_ref(xr, xi, plan, rows, ncols):
    """``_stage_a_real_kernel`` / ``_stage_a_complex_kernel`` with
    ``_tw_block`` (fused.py:80-150) in float64 with bf16 operands, on the
    first ``rows`` rows and ``ncols`` columns."""
    ct = plan["ct"]
    f = {k: np.asarray(plan[k])[:rows] for k in ("f1r", "f1i", "f1s", "f1d")}
    x = xr[:, :, :ncols]
    if xi is None:
        pr, pi = _b(f["f1r"]) @ _b(x), _b(f["f1i"]) @ _b(x)
    else:
        y = xi[:, :, :ncols]
        k1 = _b(f["f1r"]) @ _b(_f32(x) + _f32(y))
        k2 = _b(f["f1d"]) @ _b(x)
        k3 = _b(f["f1s"]) @ _b(y)
        pr, pi = k1 - k3, k1 + k2
    cols = np.arange(ncols)
    o_r = _f32(plan["two_r"])[:rows][:, cols // ct]
    o_i = _f32(plan["two_i"])[:rows][:, cols // ct]
    i_r = _f32(plan["twi_r"])[:rows][:, cols % ct]
    i_i = _f32(plan["twi_i"])[:rows][:, cols % ct]
    twr, twi = o_r * i_r - o_i * i_i, o_r * i_i + o_i * i_r
    return pr * twr - pi * twi, pr * twi + pi * twr


@pytest.mark.parametrize("case", ["real_rows", "complex", "complex_col_tiles"])
@pytest.mark.parametrize("n", [1 << 17, 1 << 18])
def test_stage_a_bf16_plain_matches_the_jax_body(n, case):
    sign = -1 if case == "real_rows" else 1
    jp = jplan.get_stage_a_plan(n, sign)
    tp = tplan.on_device(tplan.get_stage_a_plan, n, sign, None, device="cpu")
    n1, n2, ct = tp["n1"], tp["n2"], tp["ct"]
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((2, n1, n2)).astype(np.float32)
    xi = None if case == "real_rows" else rng.standard_normal((2, n1, n2)).astype(np.float32)
    rows = tplan.stage_a_real_rows(n1) if case == "real_rows" else None
    tiles = -(-(n2 // 2 + 1) // ct) if case == "complex_col_tiles" else None
    got = K.stage_a_bf16_plain(torch.from_numpy(xr), None if xi is None else torch.from_numpy(xi), n1, n2, tp, ct,
                               col_tiles=tiles, rows=rows)
    ref = _stage_a_ref(xr, xi, jp, rows or n1, (tiles * ct) if tiles else n2)
    assert got[0].shape == ref[0].shape
    assert _rel(got, ref) <= 1e-3
    fp32 = K.stage_a_plain(torch.from_numpy(xr), None if xi is None else torch.from_numpy(xi), n1, n2, tp, ct,
                           col_tiles=tiles, rows=rows)
    assert _rel(fp32, ref) > 1e-4


def test_stage_a_on_a_legacy_plan_runs_k3lf_under_fast_and_k3_legacy_under_full(mode):
    """A legacy (materialized-twiddle) plan: "fast" runs K3LF (counted as
    ``stage_a_legacy_bf16``, the bf16 plain version on the CPU), "full"
    runs K3-legacy; ``stage_a_bf16`` and its plain version take the plan
    as they take a factored one."""
    from gpu_fft_tpu_torch.scripts.ablate_large import make_plan

    legacy = tplan.on_device(make_plan, 16 * 64, 16, -1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 16, 64)).astype(np.float32))
    want = K.stage_a_bf16_plain(x, None, 16, 64, legacy, 64)
    assert all(torch.equal(g, w) for g, w in zip(K.stage_a_bf16(x, None, 16, 64, legacy, 64), want))
    mode("fast")
    K.reset_counts()
    got = K.stage_a(x, None, 16, 64, legacy, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.COUNTS["stage_a_legacy_bf16"].plain_calls == 1 and K.COUNTS["stage_a_legacy"].plain_calls == 0
    mode("full")
    K.reset_counts()
    assert K.stage_a(x, None, 16, 64, legacy, 64)[0].shape == (1, 16, 64)
    assert K.COUNTS["stage_a_legacy"].plain_calls == 1 and K.COUNTS["stage_a_legacy_bf16"].plain_calls == 0


def test_frag_image_is_the_mma_register_order():
    """Lane 4 g + t of tile (mt, kt) holds rows 16 mt + (g, g + 8) by depths
    16 kt + (2t, 2t + 1, 2t + 8, 2t + 9), in the A registers' order; rows
    and depths past the matrix are zero."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((24, 40)).astype(np.float32))
    img = K.frag_image(a, -a)
    assert img.shape == (2, 2, 3, 32, 8) and img.dtype == torch.bfloat16
    pad = torch.zeros(32, 48, dtype=torch.bfloat16)
    pad[:24, :40] = a.to(torch.bfloat16)
    for mt in range(2):
        for kt in range(3):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                r, c = 16 * mt + g, 16 * kt + 2 * t
                want = [pad[r, c], pad[r, c + 1], pad[r + 8, c], pad[r + 8, c + 1],
                        pad[r, c + 8], pad[r, c + 9], pad[r + 8, c + 8], pad[r + 8, c + 9]]
                assert torch.equal(img[0, mt, kt, lane], torch.stack(want))
    assert torch.equal(img[1], -img[0])


def test_bf16_images_are_built_once_per_plan():
    whole = tplan.on_device(tplan.get_whole_plan, 4096, -1, None, device="cpu")
    packed = tplan.on_device(tplan.get_whole_packed_plan, 1024, -1, None, device="cpu")
    staged = tplan.on_device(tplan.get_stage_a_plan, 1 << 17, -1, None, device="cpu")
    one, two = K.bf16_images(whole)
    assert K.bf16_images(whole)[0] is one
    assert one.shape == (4, 2, 2, 32, 8) and two.shape == (4, 8, 8, 32, 8)
    assert torch.equal(K.frag_image(whole["f1s"])[0], one[2])
    p1, p2 = K.bf16_images(packed)
    assert p1.shape == (2, 1, 1, 32, 8) and p2.shape == (2, 8, 8, 32, 8)
    (s1,) = K.bf16_images(staged)  # K3F's image: 4 real-input groups of 32 rows, 2 Karatsuba groups of 3 parts
    assert s1.shape == K.stage_a_bf16_image_shape(128) == (10, 2, 64, 64)
    from gpu_fft_tpu_torch.scripts.ablate_large import make_plan

    legacy = tplan.on_device(make_plan, 1 << 17, 64, -1, device="cpu")
    (l1,) = K.bf16_images(legacy)
    assert K.bf16_images(legacy)[0] is l1 and l1.shape == (5, 1, 64, 64)
    assert torch.equal(K.swizzled_image(legacy["f1d"].to(torch.bfloat16)[None])[0, 0], l1[3])  # (Fr, Fd, Fs) from 2


# ── Gradients ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("m", MODES)
@pytest.mark.parametrize("n", [4096, 1 << 17])
def test_parseval_gradient_in_each_mode(n, m, mode):
    """sum |F x|^2 = n sum x^2, so its gradient is 2 n x: through the K1 /
    K1F seam (4,096; the torch engines under "high") and the staged seam."""
    mode(m)
    xr, _ = _inputs(1, n)
    x = torch.from_numpy(xr).requires_grad_(True)
    yr, yi = large.transform_any(x, None, n, -1)
    (yr.square().sum() + yi.square().sum()).backward()
    want = 2.0 * n * xr.astype(np.float64)
    assert _rel((x.grad,), (want,)) < BANDS[m]


@pytest.mark.parametrize("m", ["high", "fast"])
def test_staged_irfft_gradient_in_each_mode(m, mode):
    """The staged irfft's autograd seam (``_StageAFold``: the stage-A
    transpose, mode-aware) against the "full" gradient."""
    sr, si = _hermitian(IRFFT_N)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((1, IRFFT_N)).astype(np.float32))

    def grads():
        a = torch.from_numpy(sr).requires_grad_(True)
        b = torch.from_numpy(si).requires_grad_(True)
        (large.inverse_real(a, b, IRFFT_N, scale=1.0 / IRFFT_N) * w).sum().backward()
        return a.grad, b.grad

    want = grads()
    mode(m)
    got = grads()
    assert _rel(got, want) < BANDS[m]


# ── Flipping the mode in one process ─────────────────────────────────────────


@pytest.mark.parametrize("shape", [(1, 1024), (1, 4096), (1, 1 << 17)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mode_flips_within_one_process(shape, mode):
    """Each call takes the mode set at that call: full, fast, full, high,
    fast give each mode's own numbers, and a mode's result repeats bit for
    bit after the others ran (no table or image of another mode served)."""
    b, n = shape
    xr, _ = (torch.from_numpy(a) for a in _inputs(b, n))
    ref = np.fft.fft(xr.double().numpy(), axis=-1)
    seen = {}
    for m in ("full", "fast", "full", "high", "fast"):
        mode(m)
        y = large.transform_any(xr, None, n, -1)
        err = _rel(y, (ref.real, ref.imag))
        assert err < BANDS[m]
        if m in seen:
            assert all(torch.equal(a, c) for a, c in zip(y, seen[m]))
        seen[m] = y
    assert _rel(seen["fast"], seen["full"]) > 1e-4
    assert 1e-6 < _rel(seen["high"], seen["full"]) < BANDS["high"]
