"""Stage A on a materialized twiddle (K3-legacy and S2) as the Hopper kernels
lay it out, against the JAX package, and their launch rules.

K3-legacy is K3's radix kernel reading the (n1, n2) table, so it takes K3's
launch shape (``kernels/fused.py: stage_a_launch_shape``) and K3's n1 limit.
S2 is the dense core of ``csrc/dense_f32.cuh`` on the stacked table of
``kernels/ablation.py: manual_tables``; a plain torch emulation of its
product and of its epilogue's row pairing is held here against the JAX
``stage_a`` on the legacy plan (Pallas in interpret mode), since the CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``).

Inputs come from ``np.random.default_rng(seed)``.  Tolerance: max |port -
JAX| <= 1e-5 * max |JAX| (both fp32, summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu.kernels.fused as jfused
import gpu_fft_tpu_torch.kernels.ablation as A
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.plan as tplan
from gpu_fft_tpu_torch.scripts import ablate_large as t_large

RTOL = 1e-5


def _legacy_plan(n, n1):
    return tplan.on_device(t_large.make_plan, n, n1, -1, device="cpu")


def _emulate_s2(x, tables):
    """The S2 kernel's arithmetic in plain torch: the stacked product
    P = f_stack^T x (2 n1, n2), then for each 64-row block g of it the pair
    (row r, row r + 32) as Re and Im of output row k1 = 32 g + r, times the
    twiddle of that row."""
    n1, n2 = x.shape
    p = tables["f_stack"].t() @ x  # (2 n1, n2), stacked rows
    blocks = p.reshape(n1 // 32, 2, 32, n2)  # (g, Re/Im, r, c)
    pr = blocks[:, 0].reshape(n1, n2)
    pi = blocks[:, 1].reshape(n1, n2)
    twr, twi = tables["twr"], tables["twi"]
    return pr * twr - pi * twi, pr * twi + pi * twr


def _close(got, want):
    want = [np.asarray(w, dtype=np.float64) for w in want]
    got = [np.asarray(g, dtype=np.float64) for g in got]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= RTOL * scale, f"max|d| {err:.3e} > {RTOL} * {scale:.3e}"


# ── S2: the stacked table and the kernel's pairing ───────────────────────────


@pytest.mark.parametrize("n1,n2", [(32, 64), (32, 256), (128, 64), (128, 128)])
def test_s2_emulation_matches_pallas_stage_a(n1, n2):
    """The stacked, interleaved, pre-transposed table through the kernel's
    product and twiddle pairing gives the JAX stage_a on the legacy plan."""
    n = n1 * n2
    jp = t_large.make_plan(n, n1, -1)  # numpy arrays: the JAX side takes them as they are
    x = np.random.default_rng(n1 + n2).standard_normal((n1, n2)).astype(np.float32)
    want = jfused.stage_a(jnp.asarray(x)[None], None, n1, n2, jp, tplan.stage_a_col_tile(n1, n2))
    got = _emulate_s2(torch.from_numpy(x), A.manual_tables(_legacy_plan(n, n1)))
    _close([g.numpy() for g in got], [np.asarray(w)[0] for w in want])


@pytest.mark.parametrize("n1", [32, 64, 128, 256])
def test_manual_tables_interleave_fr_and_fi_by_32_rows(n1):
    """f_stack is (n1, 2 n1), contiguous, and its column 64 g + r holds row
    32 g + r of Fr, column 64 g + 32 + r the same row of Fi: bit for bit."""
    plan = _legacy_plan(n1 * 64, n1)
    t = A.manual_tables(plan)
    fs = t["f_stack"]
    assert fs.shape == (n1, 2 * n1) and fs.is_contiguous() and fs.dtype == torch.float32
    for g in range(n1 // 32):
        assert torch.equal(fs[:, 64 * g : 64 * g + 32], plan["f1r"][32 * g : 32 * g + 32].t())
        assert torch.equal(fs[:, 64 * g + 32 : 64 * g + 64], plan["f1i"][32 * g : 32 * g + 32].t())
    assert all(t[k] is plan[k] for k in plan)  # the plan's own tables, unchanged


def test_manual_tables_refuse_n1_off_the_row_pairs():
    plan = _legacy_plan(16 * 64, 16)
    with pytest.raises(ValueError, match="multiple of 32"):
        A.manual_tables(plan)


# ── S2: the launch rule ──────────────────────────────────────────────────────


@pytest.mark.parametrize("n1,n2", [(32, 4096), (128, 8192), (256, 4096), (128, 64), (96, 192), (256, 1 << 14)])
def test_manual_launch_shapes_tile_the_product(n1, n2):
    """Every shape: a column tile of 64 or 128 dividing n2, the narrower
    first, the first the rule's pick, none listed twice; 128 wherever it
    divides n2."""
    shapes = A.manual_launch_shapes(n1, n2)
    assert shapes[0] == A.manual_geometry(n1, n2)
    assert len(set(shapes)) == len(shapes) and shapes == sorted(shapes)
    assert all(bn in (64, 128) and n2 % bn == 0 for bn in shapes)
    assert (128 in shapes) == (n2 % 128 == 0)


@pytest.mark.parametrize("n1,n2", [(128, 8192), (256, 4096), (32, 1 << 12), (128, 64), (96, 192)])
def test_manual_geometry_at_the_harness_shape(n1, n2):
    """2^20 with n1 = 128 and 256: the column tile ``time_stage_a.py --legacy
    --sweep`` marks as shipped on an H100 (the faster there), 64 columns;
    the same at every other shape the kernel takes."""
    assert A.manual_geometry(n1, n2) == 64


@pytest.mark.parametrize("n1,n2", [(16, 8192), (48, 4096), (288, 4096), (512, 2048), (128, 96), (128, 32)])
def test_manual_geometry_refuses_what_the_kernel_cannot_take(n1, n2):
    with pytest.raises(ValueError, match="stage_a_manual kernel needs"):
        A.manual_geometry(n1, n2)


# ── K3-legacy: K3's launch shape and limits ──────────────────────────────────


@pytest.mark.parametrize("n1", [12, 24, 96, 1024])
def test_legacy_kernel_refuses_n1_before_the_launch(n1):
    """n1 not a power of two in [8, 512] raises ValueError off the CPU
    before any device is touched (meta tensors: no card needed), and counts
    nothing."""
    n2 = 64
    legacy = {"twr": None, "twi": None}
    K.reset_counts()
    with pytest.raises(ValueError, match="n1 must be a power of two in"):
        K.stage_a(torch.empty(1, n1, n2, device="meta"), None, n1, n2, legacy, 32)
    assert K.COUNTS["stage_a_legacy"].launches == 0 and K.COUNTS["stage_a_legacy"].plain_calls == 0


def test_legacy_kernel_takes_any_n1_on_the_cpu():
    """The limit is the kernel's: the plain version still takes n1 = 24."""
    n1, n2 = 24, 64
    rng = np.random.default_rng(0)
    f1r, f1i, twr, twi = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                          for s in ((n1, n1), (n1, n1), (n1, n2), (n1, n2)))
    tables = {"f1r": f1r, "f1i": f1i, "twr": twr, "twi": twi}
    x = torch.from_numpy(rng.standard_normal((1, n1, n2)).astype(np.float32))
    yr, _ = K.stage_a(x, None, n1, n2, tables, 32)
    assert yr.shape == (1, n1, n2)


@pytest.mark.parametrize(
    "n,n1,col_tiles,rows",
    [(1 << 17, 16, None, None), (1 << 17, 128, None, 72), (1 << 17, 128, 1, None), (1 << 20, 128, None, None),
     (1 << 20, 256, 2, 136), (1 << 22, 128, None, 72), (1 << 22, 512, None, None)],
)
def test_legacy_and_factored_plans_take_one_launch_shape(n, n1, col_tiles, rows):
    """The radix kernel's launch shape depends on the kept columns, not on
    where the twiddle comes from: a legacy plan and a factored plan of one
    shape get the same rows, columns and stage_a_geometry."""
    n2 = n // n1
    ct = tplan.stage_a_col_tile(n1, n2)
    factored = {"two_r": None, "ct": ct}
    legacy = {"twr": None, "twi": None}
    got = [K.stage_a_launch_shape(1, n1, n2, t, ct, col_tiles, rows) for t in (factored, legacy)]
    assert got[0] == got[1]
    r, ncols, geometry = got[0]
    assert geometry == K.stage_a_geometry(1, n1, n2, ncols)
    assert r == (n1 if rows is None else rows) and ncols == (n2 if col_tiles is None else col_tiles * ct)
