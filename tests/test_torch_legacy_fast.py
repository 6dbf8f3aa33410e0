"""Stage A on a materialized twiddle under GPU_FFT_TPU_PRECISION=fast: K3-legacy-
fast (K3LF, ``stage_a`` on a legacy plan) and S2-fast (S2F,
``stage_a_manual``), against the JAX package, on the CPU.

The JAX bodies (``gpu_fft_tpu/kernels/fused.py:153-185``,
``_stage_a_real_kernel_full`` / ``_stage_a_complex_kernel_full``, and
``scripts/ablate_2e20_levers.py:stage_a_manual``'s ``inner``) take their dots
at ``config.mosaic_precision()``, one bf16 pass under "fast".  Here:

* the plain versions against a numpy float64 evaluation of those bodies,
  each operand rounded through ``ml_dtypes.bfloat16`` where the body's dot
  takes it, within 1e-3 max|ref|, while the fp32 plain versions stay more
  than 1e-4 away (the bf16 cut is real);
* S2F's paired stacking (``manual_tables``: per 32 output rows their Fr
  rows then their Fi rows) emulated in plain torch from its bf16 image;
* the port under "fast" against the JAX ``stage_a`` on the legacy plan in
  Pallas interpret mode within the "fast" band (2e-2): on the CPU the JAX
  dots are f32 in every mode, so this holds the port's cut, not bit
  equality;
* the routing by mode, and the shapes the kernels refuse (meta tensors: no
  card needed).  The CUDA kernels themselves run in ``test_torch_cuda.py``.

Inputs come from ``np.random.default_rng(seed)``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import gpu_fft_tpu.kernels.fused as jfused
import gpu_fft_tpu_torch.kernels.ablation as A
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.plan as tplan
from gpu_fft_tpu_torch import config
from gpu_fft_tpu_torch.scripts import ablate_large as t_large

FAST_BAND = 2e-2  # the JAX package's "fast" band (tests/test_precision.py)
MODES = ("full", "high", "fast")


@pytest.fixture
def mode(monkeypatch):
    """Set the port's mode for one test; monkeypatch puts "full" back."""

    def set_mode(m):
        monkeypatch.setattr(config, "PRECISION", m)

    return set_mode


def _b(a):
    """An operand as a DEFAULT dot takes it: fp32 rounded to bf16 (to
    nearest even), here in float64."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _rel(got, ref):
    got = [np.asarray(g, np.float64) for g in got]
    ref = [np.asarray(r, np.float64) for r in ref]
    assert [g.shape for g in got] == [r.shape for r in ref]
    return max(np.abs(g - r).max() for g, r in zip(got, ref)) / max(np.abs(r).max() for r in ref)


def _legacy_ref(xr, xi, plan, rows, ncols):
    """``_stage_a_real_kernel_full`` / ``_stage_a_complex_kernel_full`` on the
    first ``rows`` rows and ``ncols`` columns, in float64 with bf16
    operands and the fp32 table."""
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
    twr, twi = _f32(plan["twr"])[:rows, :ncols], _f32(plan["twi"])[:rows, :ncols]
    return pr * twr - pi * twi, pr * twi + pi * twr


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (n, n1, case): real input with the real path's row cut, complex input,
# complex input on its first column tile.
K3LF_CASES = [(n, n1, case) for n in (1 << 17, 1 << 18) for n1, case in
              ((128, "real_rows"), (64, "complex"), (128, "complex_col_tiles"))]


def _k3lf_inputs(n, n1, case):
    sign = -1 if case == "real_rows" else 1
    jp = t_large.make_plan(n, n1, sign)
    tp = tplan.on_device(t_large.make_plan, n, n1, sign, device="cpu")
    n2 = n // n1
    ct = tplan.stage_a_col_tile(n1, n2)
    rng = np.random.default_rng(n + n1)
    xr = rng.standard_normal((2, n1, n2)).astype(np.float32)
    xi = None if case == "real_rows" else rng.standard_normal((2, n1, n2)).astype(np.float32)
    kw = dict(rows=72 if case == "real_rows" else None, col_tiles=1 if case == "complex_col_tiles" else None)
    return jp, tp, n2, ct, xr, xi, kw


@pytest.mark.parametrize("n,n1,case", K3LF_CASES)
def test_k3lf_plain_matches_the_jax_body(n, n1, case):
    jp, tp, n2, ct, xr, xi, kw = _k3lf_inputs(n, n1, case)
    got = K.stage_a_bf16_plain(_t(xr), _t(xi), n1, n2, tp, ct, **kw)
    ref = _legacy_ref(xr, xi, jp, kw["rows"] or n1, ct if kw["col_tiles"] else n2)
    assert _rel(got, ref) <= 1e-3
    fp32 = K.stage_a_plain(_t(xr), _t(xi), n1, n2, tp, ct, **kw)
    assert _rel(fp32, ref) > 1e-4


@pytest.mark.parametrize("n,n1,case", K3LF_CASES)
def test_k3lf_within_the_fast_band_of_jax_stage_a(n, n1, case, mode):
    jp, tp, n2, ct, xr, xi, kw = _k3lf_inputs(n, n1, case)
    want = jfused.stage_a(jnp.asarray(xr), None if xi is None else jnp.asarray(xi), n1, n2, jp, ct, **kw)
    mode("fast")
    K.reset_counts()
    got = K.stage_a(_t(xr), _t(xi), n1, n2, tp, ct, **kw)
    assert K.COUNTS["stage_a_legacy_bf16"].plain_calls == 1
    rel = _rel(got, [np.asarray(w) for w in want])
    assert 1e-4 < rel <= FAST_BAND


# ── S2F ──────────────────────────────────────────────────────────────────────


def _s2_inputs(n1, n2=256):
    n = n1 * n2
    jp = t_large.make_plan(n, n1, -1)
    tp = A.manual_tables(tplan.on_device(t_large.make_plan, n, n1, -1, device="cpu"))
    x = np.random.default_rng(n1 + n2).standard_normal((n1, n2)).astype(np.float32)
    return jp, tp, x


def _unswizzle(img, rows, n1):
    """The (rows, n1) matrix a one-part :func:`A.swizzled_image` holds."""
    groups, _, chunks = img.shape[:3]
    word = torch.arange(8).reshape(1, 8)
    r = torch.arange(64).reshape(64, 1)
    t = img[:, 0].reshape(groups, chunks, 64, 8, 8)  # g, c, r, stored word, depth
    idx = (word ^ (r % 8)).reshape(1, 1, 64, 8, 1).expand_as(t)
    plain = torch.gather(t, 3, idx)  # word j of row r was stored at j ^ (r % 8)
    return plain.permute(0, 2, 1, 3, 4).reshape(groups * 64, chunks * 64)[:rows, :n1]


def _emulate_s2f(x, tables):
    """S2F's arithmetic in plain torch from its bf16 image: the paired
    stacked product P = F_stack x (2 n1, n2) on bf16 operands, then for each
    64-row group g the pair (row r, row r + 32) as Re and Im of output row
    32 g + r, times the twiddle of that row in fp32."""
    n1, n2 = x.shape
    stack = _unswizzle(tables["f_img"], 2 * n1, n1).float()
    p = stack @ x.to(torch.bfloat16).float()
    blocks = p.reshape(n1 // 32, 2, 32, n2)
    pr, pi = blocks[:, 0].reshape(n1, n2), blocks[:, 1].reshape(n1, n2)
    twr, twi = tables["twr"], tables["twi"]
    return pr * twr - pi * twi, pr * twi + pi * twr


@pytest.mark.parametrize("n1", [32, 128])
def test_s2f_plain_matches_the_jax_body(n1):
    jp, tp, x = _s2_inputs(n1)
    ref = _legacy_ref(x[None], None, jp, n1, x.shape[1])
    ref = [r[0] for r in ref]
    got = A.stage_a_manual_bf16_plain(torch.from_numpy(x), tp)
    assert _rel(got, ref) <= 1e-3
    assert _rel(A.stage_a_manual_plain(torch.from_numpy(x), tp), ref) > 1e-4
    # The kernel's stacking and pairing give the same numbers (fp32 sums in
    # another order).
    assert _rel(_emulate_s2f(torch.from_numpy(x), tp), [g.numpy() for g in got]) <= 1e-5


@pytest.mark.parametrize("n1", [32, 64, 128, 256])
def test_manual_tables_hold_the_bf16_image_of_the_stacking(n1):
    """f_img is the bf16 (to nearest even) image of f_stack's stacking, one
    part per 64-row group, bit for bit."""
    t = A.manual_tables(tplan.on_device(t_large.make_plan, n1 * 64, n1, -1, device="cpu"))
    img = t["f_img"]
    assert img.dtype == torch.bfloat16 and img.shape == (2 * n1 // 64, 1, -(-n1 // 64), 64, 64)
    assert torch.equal(_unswizzle(img, 2 * n1, n1), t["f_stack"].t().to(torch.bfloat16))


@pytest.mark.parametrize("n1", [32, 128])
def test_s2f_within_the_fast_band_of_jax_stage_a(n1, mode):
    jp, tp, x = _s2_inputs(n1)
    n2 = x.shape[1]
    want = jfused.stage_a(jnp.asarray(x)[None], None, n1, n2, jp, tplan.stage_a_col_tile(n1, n2))
    mode("fast")
    got = A.stage_a_manual(torch.from_numpy(x), tp)
    assert 1e-4 < _rel(got, [np.asarray(w)[0] for w in want]) <= FAST_BAND


def test_stage_a_manual_honours_the_mode(mode):
    """Under "fast" S2 is S2F: its plain path is the bf16 one, more than
    1e-4 of max|.| from the fp32 plain version; under "full" and "high"
    (which the JAX kernels' Mosaic dots take at HIGHEST) it is S2's."""
    _, tp, x = _s2_inputs(128)
    x = torch.from_numpy(x)
    for m in ("high", "full"):
        mode(m)
        fp32 = A.stage_a_manual_plain(x, tp)
        assert all(torch.equal(g, w) for g, w in zip(A.stage_a_manual(x, tp), fp32))
    mode("fast")
    assert _rel(A.stage_a_manual(x, tp), [w.numpy() for w in fp32]) > 1e-4


# ── Routing and refusals ─────────────────────────────────────────────────────


@pytest.mark.parametrize("m", MODES)
def test_legacy_stage_a_routes_by_mode(m, mode):
    """"fast": K3LF (``stage_a_legacy_bf16``); "full" and "high": K3-legacy;
    each plain call counted once, no other kernel touched."""
    n1, n2 = 32, 256
    tp = tplan.on_device(t_large.make_plan, n1 * n2, n1, -1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, n1, n2)).astype(np.float32))
    mode(m)
    K.reset_counts()
    A.reset_counts()
    y = K.stage_a(x, None, n1, n2, tp, 64, rows=16)
    assert y[0].shape == (1, 16, n2)
    want = "stage_a_legacy_bf16" if m == "fast" else "stage_a_legacy"
    ran = {k: (c.launches, c.plain_calls) for k, c in {**K.COUNTS, **A.COUNTS}.items()
           if c.launches or c.plain_calls}
    assert ran == {want: (0, 1)}


@pytest.mark.parametrize("m", MODES)
def test_stage_a_manual_routes_by_mode(m, mode):
    _, tp, x = _s2_inputs(32)
    mode(m)
    K.reset_counts()
    A.reset_counts()
    A.stage_a_manual(torch.from_numpy(x), tp)
    want = "stage_a_manual_bf16" if m == "fast" else "stage_a_manual"
    ran = {k: (c.launches, c.plain_calls) for k, c in {**K.COUNTS, **A.COUNTS}.items()
           if c.launches or c.plain_calls}
    assert ran == {want: (0, 1)}


_LEGACY_META = {"f1r": None, "f1i": None, "f1s": None, "f1d": None, "twr": None, "twi": None}


@pytest.mark.parametrize("n1,n2,col_tile,match", [
    (24, 64, 64, "n1 a multiple of 16"), (1024, 64, 64, "n1 a multiple of 16"),
    (16, 48, 16, "kept columns a multiple of 32"), (16, 128, 16, "kept columns a multiple of 32"),
])
def test_k3lf_refuses_before_the_launch(n1, n2, col_tile, match, mode):
    """Off the CPU a shape K3LF cannot take raises ValueError before the
    device is looked at (meta tensors), and counts nothing; (16, 128) keeps
    one column tile of 16."""
    mode("fast")
    K.reset_counts()
    with pytest.raises(ValueError, match=match):
        K.stage_a(torch.empty(1, n1, n2, device="meta"), None, n1, n2, _LEGACY_META, col_tile,
                  col_tiles=1 if n2 == 128 else None)
    assert all(c.launches == 0 and c.plain_calls == 0 for c in K.COUNTS.values())


def test_k3lf_needs_the_f1_group():
    legacy = {"f1r": torch.zeros(16, 16), "f1i": torch.zeros(16, 16), "twr": torch.zeros(16, 64),
              "twi": torch.zeros(16, 64)}
    with pytest.raises(ValueError, match="F1 group"):
        K.stage_a_bf16(torch.zeros(1, 16, 64), None, 16, 64, legacy, 64)


@pytest.mark.parametrize("n1,n2", [(16, 8192), (48, 4096), (288, 4096), (128, 96), (128, 32)])
def test_s2f_refuses_before_the_launch(n1, n2, mode):
    mode("fast")
    A.reset_counts()
    with pytest.raises(ValueError, match="stage_a_manual_bf16 kernel needs"):
        A.stage_a_manual(torch.empty(n1, n2, device="meta"), {})
    with pytest.raises(ValueError, match="stage_a_manual_bf16 kernel needs"):
        A.manual_bf16_geometry(n1, n2)
    assert all(c.launches == 0 and c.plain_calls == 0 for c in A.COUNTS.values())


@pytest.mark.parametrize("n1,n2", [(32, 4096), (128, 8192), (256, 4096), (96, 192), (256, 1 << 14)])
def test_manual_bf16_geometry_is_s3s_x1_rule_at_b1(n1, n2):
    """S2F launches as S3's bf16 x1 kernel does at B = 1: the same (wgs,
    grid), whose row blocks cover the 2 n1 stacked rows in whole 64-row
    pairs."""
    wgs, grid = A.manual_bf16_geometry(n1, n2)
    assert (wgs, grid) == A.dot_geometry(1, n1, n2, "bf16_x1")
    assert (2 * n1) % (64 * wgs) == 0 and grid % (2 * n1 // (64 * wgs)) == 0
