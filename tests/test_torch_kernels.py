"""The plain versions of the port's kernels against the JAX Pallas kernels.

The JAX side runs as the JAX package's own tests run it on the CPU: Pallas in
interpret mode.  Inputs are made with numpy from a seed and handed to both.

Tolerance: max |port - JAX| <= 1e-5 * max |JAX|.  Both sides compute in fp32
from bit-identical tables (tests/test_torch_plan.py) but sum in a different
order (Pallas interpret-mode dots vs torch matmuls, Karatsuba vs schoolbook),
which costs a few fp32 ulps (~1e-7 relative); TF32 (~5e-4) would be ~50x
over this gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu.kernels.fused as jfused
import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.plan as tplan

RTOL = 1e-5


def _close(got, want):
    want = [np.asarray(w, dtype=np.float64) for w in want]
    got = [g.numpy().astype(np.float64) for g in got]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= RTOL * scale, f"max|d| {err:.3e} > {RTOL} * {scale:.3e}"


def _inputs(shape, complex_, seed):
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32) if complex_ else None
    return xr, xi


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


WHOLE = {
    "whole_transform": (jfused.whole_transform, K.whole_transform, jplan.get_whole_plan, tplan.get_whole_plan),
    "whole_transform_packed": (
        jfused.whole_transform_packed, K.whole_transform_packed,
        jplan.get_whole_packed_plan, tplan.get_whole_packed_plan,
    ),
}


@pytest.mark.parametrize("name", sorted(WHOLE))
@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("complex_", [False, True], ids=["real_fwd", "complex_inv_scaled"])
def test_whole_plain_matches_pallas(name, n, b, complex_):
    jkern, tkern, jget, tget = WHOLE[name]
    sign, scale = (1, 1.0 / n) if complex_ else (-1, None)
    xr, xi = _inputs((b, n), complex_, seed=n + b)
    want = jkern(_j(xr), _j(xi), jget(n, sign, scale=scale))
    K.reset_counts()
    got = tkern(_t(xr), _t(xi), tplan.on_device(tget, n, sign, scale, device="cpu"))
    _close(got, want)
    assert K.COUNTS[name].plain_calls == 1 and K.COUNTS[name].launches == 0


STAGE_A_CASES = {
    "real_rows72": dict(complex_=False, rows=72, col_tiles=None),
    "complex": dict(complex_=True, rows=None, col_tiles=None),
    "complex_col_tiles1": dict(complex_=True, rows=None, col_tiles=1),
    "real_col_tiles1": dict(complex_=False, rows=None, col_tiles=1),
}


@pytest.mark.parametrize("case", sorted(STAGE_A_CASES))
def test_stage_a_plain_matches_pallas(case):
    c = STAGE_A_CASES[case]
    n = 1 << 17
    ct = tplan.stage_a_ct_full_range(n)
    jp = jplan.get_stage_a_plan(n, -1, ct=ct)
    n1, n2 = jp["n1"], jp["n2"]
    xr, xi = _inputs((1, n1, n2), c["complex_"], seed=7)
    want = jfused.stage_a(_j(xr), _j(xi), n1, n2, jp, ct, col_tiles=c["col_tiles"], rows=c["rows"])
    K.reset_counts()
    tp = tplan.on_device(tplan.get_stage_a_plan, n, -1, ct, device="cpu")
    got = K.stage_a(_t(xr), _t(xi), n1, n2, tp, ct, col_tiles=c["col_tiles"], rows=c["rows"])
    _close(got, want)
    assert K.COUNTS["stage_a"].plain_calls == 1 and K.COUNTS["stage_a"].launches == 0


def test_stage_a_checks_match_the_jax_wrapper():
    n = 1 << 17
    tp = tplan.on_device(tplan.get_stage_a_plan, n, -1, 512, device="cpu")
    x = torch.zeros(1, tp["n1"], tp["n2"])
    with pytest.raises(ValueError, match="rows"):
        K.stage_a(x, None, tp["n1"], tp["n2"], tp, 512, rows=70)
    with pytest.raises(ValueError, match="col_tiles"):
        K.stage_a(x, None, tp["n1"], tp["n2"], tp, 512, col_tiles=3)
    with pytest.raises(ValueError, match="col_tile"):
        K.stage_a(x, None, tp["n1"], tp["n2"], tp, 256)
    # A legacy plan (materialized twiddle) now runs: the factored table
    # rebuilt in full gives the same result.
    o = tp["two_r"][:, :, None], tp["two_i"][:, :, None]
    i = tp["twi_r"][:, None, :], tp["twi_i"][:, None, :]
    legacy = {
        "f1r": tp["f1r"], "f1i": tp["f1i"],
        "twr": (o[0] * i[0] - o[1] * i[1]).reshape(tp["n1"], tp["n2"]),
        "twi": (o[0] * i[1] + o[1] * i[0]).reshape(tp["n1"], tp["n2"]),
    }
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(x.shape)).astype(np.float32))
    want = K.stage_a(x, None, tp["n1"], tp["n2"], tp, 512)
    _close(K.stage_a(x, None, tp["n1"], tp["n2"], legacy, 512), [w.numpy() for w in want])


@pytest.mark.parametrize("name", ["whole_transform", "whole_transform_packed", "stage_a", "stage_b"])
def test_wrapper_has_no_fallback_off_the_cpu(name):
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    plain version is taken only for CPU tensors."""
    staged = name in ("stage_a", "stage_b")
    x = torch.empty(1, 128, 1024, device="meta") if staged else torch.empty(1, 1024, device="meta")
    K.reset_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        if name == "stage_a":
            K.stage_a(x, None, 128, 1024, {}, 512)
        elif name == "stage_b":
            K.stage_b_kernel(x, x, 128, 1024, {"m1": 8, "m2": 128}, {})
        else:
            getattr(K, name)(x, None, {})
    assert K.COUNTS[name].plain_calls == 0 and K.COUNTS[name].launches == 0


@pytest.mark.parametrize("n1", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("b", [1, 3])
def test_whole_geometry_fits_and_covers(n1, b):
    """The whole kernel's launch rule: one cluster of at most 16 blocks per
    row, each block within the H100's 1,024 threads and 232,448 bytes of
    shared memory, 8 complex values per thread; the blocks' column slices
    (stage 1) and row slices (stage 2) cover the (n1, 128) view exactly once."""
    cluster, threads, smem = K.whole_geometry(b, n1)
    assert cluster & (cluster - 1) == 0 and 1 <= cluster <= min(16, n1)
    assert threads <= 1024 and threads * 8 * cluster == n1 * 128
    assert smem <= 232_448
    assert smem >= 8 * (n1 * 128 // cluster + n1 + 128)  # the tile and both root tables
    slices = K.whole_slices(n1, cluster)
    assert len(slices) == cluster
    assert sorted(c for cols, _ in slices for c in cols) == list(range(128))
    assert sorted(r for _, rows in slices for r in rows) == list(range(n1))
    # Each block's stage-1 tile and stage-2 tile hold n / cluster values.
    assert all(len(cols) * n1 == len(rows) * 128 == threads * 8 for cols, rows in slices)


@pytest.mark.parametrize("n1", [4, 12])
def test_whole_kernel_rejects_bad_n1(n1):
    with pytest.raises(ValueError, match=r"n1 = n/128"):
        K._whole_args("whole_transform", torch.empty(1, 128 * n1), None, {"n1": n1, "n2": 128})


@pytest.mark.parametrize("n1", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("n2", [1024, 8192, 65536])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_stage_a_geometry_fits_and_covers(n1, n2, b):
    """K3's launch rule: one block per row and tile of ``width`` columns,
    within the H100's 1,024 threads and 232,448 bytes of shared memory, 8
    complex values per thread, so a block holds every row of its columns;
    the tiles cover the kept columns exactly once and their loads stay
    inside the row.  n2 from 2^17 / 128 (n1 = 128, or 256 by the
    calibration's digit) to 2^24 / 256."""
    for ncols in (n2, 512, 4):  # every column, one plan tile, the narrowest
        width, threads, smem = K.stage_a_geometry(b, n1, n2, ncols)
        assert width & (width - 1) == 0 and n2 % width == 0
        assert threads <= 1024 and threads * 8 == n1 * width
        assert 8 * (n1 * width + n1) <= smem <= 232_448
        tiles = -(-ncols // width)
        assert tiles * width <= n2
        cols = [c for g in range(tiles) for c in range(g * width, (g + 1) * width) if c < ncols]
        assert cols == list(range(ncols))


@pytest.mark.parametrize("n1", [4, 12, 96, 1024])
def test_stage_a_geometry_rejects_bad_n1(n1):
    with pytest.raises(ValueError, match="n1 must be a power of two"):
        K.stage_a_geometry(1, n1, 8192, 8192)


# ── K4: stage B ──────────────────────────────────────────────────────────────


def _stage_b_cover(n1, m1, shape):
    """Replays ``csrc/stage_b.cu``'s index arithmetic for one cluster of a
    (G, C) launch: for each stored (k2, row q), the block and shared-memory
    slot it is gathered from, and the (row, k2) that block's last pass left
    in that slot."""
    g_rows, c = shape
    rows, cluster, threads, _ = K.stage_b_geometry(n1, m1, shape)
    assert (rows, cluster) == (g_rows, g_rows * c)
    n2, m2 = m1 * 128, m1 // c  # m2: the rows k of the (m1, 128) view a block takes in stage 2
    t = np.arange(threads)
    lane, warp, nw = t & 31, t >> 5, threads >> 5
    stored = []
    for rank in range(cluster):
        for u in range(8):
            p = rank * (n2 // cluster) + (lane // g_rows) + (warp + u * nw) * (32 // g_rows)
            q = lane % g_rows
            k = p % m1
            owner = q * c + k // m2
            slot = (p // m1) * m2 + k % m2
            # Block (g, r) = divmod(owner, c) left output j of row k = r m2 + m at slot j m2 + m.
            g, r = np.divmod(owner, c)
            j, m = np.divmod(slot, m2)
            assert (slot < m2 * 128).all()
            stored.append(np.stack([p, q, g, j * m1 + r * m2 + m]))
    return np.concatenate(stored, axis=1)


@pytest.mark.parametrize("n1", [128, 256])
@pytest.mark.parametrize("m1", [8, 16, 32, 64, 128, 256, 512])
def test_stage_b_geometry_fits_and_covers(n1, m1):
    """K4's launch rule and every launch shape a sweep may take: a cluster of
    G rows k1 and C blocks a row, at most 16 blocks; each block within the
    H100's 1,024 threads (at least a warp) and 232,448 bytes of shared
    memory, 8 complex values a thread; the store writes every (k2, row) of
    the cluster exactly once, each from the block and slot that holds that
    row's output k2, and a warp's G lanes of one k2 write neighbouring k1."""
    shapes = K.stage_b_launch_shapes(n1, m1)
    assert K.stage_b_geometry(n1, m1)[:2] in {(g, g * c) for g, c in shapes}
    for shape in shapes:
        g_rows, c = shape
        rows, cluster, threads, smem = K.stage_b_geometry(n1, m1, shape)
        assert cluster <= min(16, m1) and 32 <= threads <= 1024 and threads * 8 * c == m1 * 128
        assert 8 * (m1 * 128 // c + m1 + 128) <= smem <= 232_448
        p, q, g, k2 = _stage_b_cover(n1, m1, shape)
        assert (g == q).all() and (k2 == p).all()
        assert len(set(zip(p.tolist(), q.tolist()))) == p.size == m1 * 128 * g_rows


@pytest.mark.parametrize("bad", [(4, None), (1024, None), (64, (16, 1)), (64, (8, 4)), (8, (1, 8))])
def test_stage_b_geometry_rejects_what_the_kernel_does_not_take(bad):
    m1, shape = bad
    with pytest.raises(ValueError):
        K.stage_b_geometry(128, m1, shape)


def _stage_b_inputs(b, n, sign, seed=0):
    plan = tplan.on_device(tplan.get_stage_a_plan, n, sign, None, device="cpu")
    tw = tplan.on_device(tplan.get_stage_b_twiddle, plan["n2"], sign, device="cpu")
    g = torch.Generator().manual_seed(seed)
    yr, yi = (torch.randn(b, plan["n1"], plan["n2"], generator=g) for _ in "ri")
    return yr, yi, plan, tw


def test_stage_b_wrapper_rejects_a_bad_shape_or_layout():
    yr, yi, plan, tw = _stage_b_inputs(1, 1 << 17, 1)
    n1, n2, t = plan["n1"], plan["n2"], plan["stage_b"]
    K.reset_counts()
    with pytest.raises(ValueError, match=r"\(B, 128, 1024\)"):
        K.stage_b_kernel(yr[:, :, :1000], yi[:, :, :1000], n1, n2, t, tw)
    with pytest.raises(ValueError, match="both"):
        K.stage_b_kernel(yr, None, n1, n2, t, tw)
    with pytest.raises(ValueError, match="contiguous"):
        K.stage_b_kernel(yr.transpose(1, 2).contiguous().transpose(1, 2), yi, n1, n2, t, tw)
    with pytest.raises(ValueError, match="float32"):
        K.stage_b_kernel(yr, yi.double(), n1, n2, t, tw)
    with pytest.raises(ValueError, match="plan"):
        K.stage_b_kernel(yr.reshape(1, 256, 512).contiguous(), yi.reshape(1, 256, 512).contiguous(), 256, 512, t, tw)
    assert K.COUNTS["stage_b"].plain_calls == 0


@pytest.mark.parametrize("sign,scaled", [(-1, False), (1, False), (1, True)])
def test_stage_b_plain_is_the_torch_engine_and_the_digit_reversed_dft(sign, scaled):
    """On a CPU tensor the wrapper (and the operator's CPU kernel) is the
    torch ``stage_b`` times the scale, bit for bit, counted as a plain call;
    it is each row's DFT stored at k1 + n1 k2 (float64, 5 log2(n2) eps)."""
    from gpu_fft_tpu_torch.kernels.fused_torch import stage_b

    n = 1 << 17
    yr, yi, plan, tw = _stage_b_inputs(2, n, sign, seed=3)
    n1, n2, t = plan["n1"], plan["n2"], plan["stage_b"]
    scale = 1.0 / n if scaled else None
    K.reset_counts()
    got = K.stage_b_kernel(yr, yi, n1, n2, t, tw, scale)
    assert (K.COUNTS["stage_b"].plain_calls, K.COUNTS["stage_b"].launches) == (1, 0)
    want = stage_b(yr, yi, n1, n2, t)
    for g, w in zip(got, want):
        assert torch.equal(g, w * scale if scaled else w)
    op = torch.ops.gpu_fft_tpu_torch.stage_b(yr, yi, K.stage_b_tables(t, tw), n1, 1.0 if scale is None else scale)
    assert all(torch.equal(a, b) for a, b in zip(op, got))
    z = torch.complex(yr.double(), yi.double())
    ref = (torch.fft.fft(z) if sign < 0 else torch.fft.ifft(z) * n2) * (scale or 1.0)
    ref = ref.transpose(1, 2).reshape(2, n)
    err = max(float((got[0] - ref.real).abs().max()), float((got[1] - ref.imag).abs().max()))
    assert err <= 5 * np.log2(n2) * np.finfo(np.float32).eps * float(ref.abs().max())


def test_stage_b_twiddle_is_the_plans_transposed():
    """K4's twiddle (m1, 128) holds the stage-B plan's (128, m1) values."""
    for n in (1 << 17, 1 << 20, 1 << 24):
        plan = tplan.get_stage_a_plan(n, 1)
        tw = tplan.get_stage_b_twiddle(plan["n2"], 1)
        for k in ("twr", "twi"):
            assert np.array_equal(tw[k], plan["stage_b"][k].T)
