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


@pytest.mark.parametrize("name", ["whole_transform", "whole_transform_packed", "stage_a"])
def test_wrapper_has_no_fallback_off_the_cpu(name):
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    plain version is taken only for CPU tensors."""
    x = torch.empty(1, 128, 1024, device="meta") if name == "stage_a" else torch.empty(1, 1024, device="meta")
    K.reset_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        if name == "stage_a":
            K.stage_a(x, None, 128, 1024, {}, 512)
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
