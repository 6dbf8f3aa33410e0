"""The port's parallel layer (``gpu_fft_tpu_torch.parallel``) on a gloo world
of 8 CPU ranks, against the JAX package's on the conftest's 8-device
virtual mesh.

One module-scoped fixture spawns the 8 ranks once (``init_method`` a file
under pytest's tmp dir, so xdist workers never share a port).  Each rank
builds the meshes ``("dp",)`` x 8 (``default_mesh(device="cpu")``) and
``("dp", "sp")`` 2 x 4, runs every case of :data:`CASES` on the mesh the
JAX test uses, and rank 0 hands back each output's ``full_tensor()`` and
placements, or the ValueError it raised.  The parent holds each output
against the JAX function on the same seeded input, at the shapes of
``tests/test_parallel.py``, within 1e-5 * max|JAX|, and against that
test's own oracle.
"""

import datetime
import multiprocessing
import os
import pickle
import re

import numpy as np
import pytest
import torch

WORLD = 8
TOL = 1e-5  # relative to max|JAX|: both fp32 through the same factorizations


def _rng(seed):
    return np.random.default_rng(seed)


def _real(seed, *shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


# ── The cases: (mesh, port call, JAX call); each builds its own input ────────
#
# A call takes (module, mesh) where module is gpu_fft_tpu_torch.parallel or
# gpu_fft_tpu.parallel, and returns an array, a tuple of arrays, or
# (freqs, psd) for Welch.

def _fft_batch(m, mesh):
    return m.fft_batch_sharded(_real(1, 16, 1024), mesh)


def _ifft_batch_roundtrip(m, mesh):
    yr, yi = m.fft_batch_sharded(_real(2, 8, 512), mesh)
    return m.ifft_batch_sharded(yr, yi, mesh)


def _distributed(m, mesh):
    return m.distributed_fft(_real(3, 4, 4096), mesh, sp_axis="sp", dp_axis="dp")


def _distributed_roundtrip(m, mesh):
    yr, yi = m.distributed_fft(_real(4, 2, 1024), mesh, sp_axis="sp", dp_axis="dp")
    return m.distributed_ifft(yr, yi, mesh, sp_axis="sp", dp_axis="dp")


def _distributed_bad_factor(m, mesh):
    return m.distributed_fft(np.zeros((1, 8), np.float32), mesh, sp_axis="sp")


def _distributed_split(n):
    def call(m, mesh):
        return m.distributed_fft(_real(5 + n, 2, n), mesh, sp_axis="sp", dp_axis="dp")
    return call


def _distributed_large(m, mesh):
    return m.distributed_fft(_real(6, 2, 1 << 18), mesh, sp_axis="sp", dp_axis="dp")


def _distributed_staged(m, mesh):
    # The local transforms through the staged path: FUSED_MAX shrunk to 256
    # (the caller patches it), so both 512-point locals of 2^18 are staged.
    return m.distributed_fft(_real(7, 1, 1 << 18), mesh, sp_axis="sp")


def _distributed_indivisible(m, mesh):
    return m.distributed_fft(np.zeros((3, 4096), np.float32), mesh, sp_axis="sp", dp_axis="dp")


def _welch_signal(m, mesh):
    return m.welch_sharded(_real(8, 128 * 65 + 64), mesh, nperseg=256, fs=10.0)


def _welch_segments(num_seg):
    def call(m, mesh):
        return m.welch_sharded(_real(9 + num_seg, 64 * (num_seg - 1) + 128), mesh, nperseg=128)
    return call


def _welch_short(m, mesh):
    return m.welch_sharded(np.zeros(200, np.float32), mesh, nperseg=256)


def _welch_2d(m, mesh):
    return m.welch_sharded(np.zeros((4, 4096), np.float32), mesh)


def _fft2_batch(m, mesh):
    return m.fft2_batch_sharded(_real(10, 8, 16, 100), mesh)


def _fft2_batch_indivisible(m, mesh):
    return m.fft2_batch_sharded(np.zeros((3, 16, 16), np.float32), mesh)


def _oaconvolve(m, mesh):
    return m.oaconvolve_sharded(_real(11, 40000), _real(12, 129), mesh)


def _oaconvolve_again(m, mesh):
    # JAX: the function under jax.jit equals the eager call.  Here: the
    # signal handed over as a sharded DTensor equals the plain global array.
    x, h = _real(13, 16384), _real(14, 64)
    if hasattr(m, "_sharding"):
        x = m._sharding.from_local(
            torch.from_numpy(x).chunk(8)[mesh.get_local_rank("dp")], mesh,
            m._sharding.placements(mesh, {"dp": 0}), (16384,))
        return m.oaconvolve_sharded(x, h, mesh)
    import jax

    return jax.jit(lambda a: m.oaconvolve_sharded(a, h, mesh))(x)


def _oaconvolve_one_tap(m, mesh):
    return m.oaconvolve_sharded(np.ones(1024, np.float32), np.ones(1, np.float32), mesh)


def _oaconvolve_long_taps(m, mesh):
    return m.oaconvolve_sharded(np.ones(64, np.float32), np.ones(32, np.float32), mesh)


def _fft2_pencil(m, mesh):
    yr, yi = m.fft2_sharded(_real(15, 64, 128), mesh, sp_axis="dp")
    br, bi = m.ifft2_sharded(yr, yi, mesh, sp_axis="dp")
    return yr, yi, br, bi


def _fft2_complex_batch(m, mesh):
    return m.fft2_sharded(_real(16, 4, 32, 64), mesh, dp_axis="dp", imag=_real(17, 4, 32, 64))


def _fft2_layout(m, mesh):
    return m.fft2_sharded(_real(18, 64, 64), mesh, sp_axis="dp")


def _fft2_not_pow2(m, mesh):
    return m.fft2_sharded(np.ones((48, 64), np.float32), mesh, sp_axis="dp")


def _fft2_not_divisible(m, mesh):
    return m.fft2_sharded(np.ones((4, 64), np.float32), mesh, sp_axis="dp")


def _fft2_imag_shape(m, mesh):
    return m.fft2_sharded(np.ones((64, 64), np.float32), mesh, sp_axis="dp", imag=np.ones((64, 32), np.float32))


def _fftn_slab(m, mesh):
    yr, yi = m.fftn_sharded(_real(19, 16, 32, 64), mesh, sp_axis="dp")
    br, bi = m.ifftn_sharded(yr, yi, mesh, sp_axis="dp")
    return yr, yi, br, bi


def _fftn_complex(m, mesh):
    return m.fftn_sharded(_real(20, 8, 16, 32), mesh, sp_axis="dp", imag=_real(21, 8, 16, 32))


def _fftn_not_volume(m, mesh):
    return m.fftn_sharded(np.ones((8, 8), np.float32), mesh, sp_axis="dp")


def _fftn_depth(m, mesh):
    return m.fftn_sharded(np.ones((24, 16, 16), np.float32), mesh, sp_axis="dp")


def _fftn_not_divisible(m, mesh):
    return m.fftn_sharded(np.ones((16, 4, 16), np.float32), mesh, sp_axis="dp")


def _butter():
    import scipy.signal as ss

    return ss.butter(4, 0.15)


def _lfilter(m, mesh):
    b, a = _butter()
    return m.lfilter_sharded(b, a, _real(22, 65536), mesh, "dp")


def _lfilter_fir(m, mesh):
    return m.lfilter_sharded([2.0], [1.0], _real(23, 4096), mesh, "dp")


def _lfilter_indivisible(m, mesh):
    return m.lfilter_sharded([1.0, 0.5], [1.0], np.ones(1001, np.float32), mesh, "dp")


def _lfilter_2d(m, mesh):
    return m.lfilter_sharded([1.0, 0.5], [1.0], np.ones((2, 8), np.float32), mesh, "dp")


#: name -> (mesh, call); "mesh8" is ("dp",) x 8, "mesh2x4" ("dp", "sp").
CASES = {
    "fft_batch": ("mesh8", _fft_batch),
    "ifft_batch_roundtrip": ("mesh8", _ifft_batch_roundtrip),
    "distributed": ("mesh2x4", _distributed),
    "distributed_roundtrip": ("mesh2x4", _distributed_roundtrip),
    "distributed_bad_factor": ("mesh2x4", _distributed_bad_factor),
    "distributed_split_16": ("mesh2x4", _distributed_split(16)),
    "distributed_split_32": ("mesh2x4", _distributed_split(32)),
    "distributed_large": ("mesh2x4", _distributed_large),
    "distributed_staged": ("mesh2x4", _distributed_staged),
    "distributed_indivisible": ("mesh2x4", _distributed_indivisible),
    "welch": ("mesh8", _welch_signal),
    **{f"welch_segments_{k}": ("mesh8", _welch_segments(k)) for k in (1, 7, 8, 9)},
    "welch_short": ("mesh8", _welch_short),
    "welch_2d": ("mesh8", _welch_2d),
    "fft2_batch": ("mesh8", _fft2_batch),
    "fft2_batch_indivisible": ("mesh8", _fft2_batch_indivisible),
    "oaconvolve": ("mesh8", _oaconvolve),
    "oaconvolve_again": ("mesh8", _oaconvolve_again),
    "oaconvolve_one_tap": ("mesh8", _oaconvolve_one_tap),
    "oaconvolve_long_taps": ("mesh8", _oaconvolve_long_taps),
    "fft2_pencil": ("mesh8", _fft2_pencil),
    "fft2_complex_batch": ("mesh2x4", _fft2_complex_batch),
    "fft2_layout": ("mesh8", _fft2_layout),
    "fft2_not_pow2": ("mesh8", _fft2_not_pow2),
    "fft2_not_divisible": ("mesh8", _fft2_not_divisible),
    "fft2_imag_shape": ("mesh8", _fft2_imag_shape),
    "fftn_slab": ("mesh8", _fftn_slab),
    "fftn_complex": ("mesh8", _fftn_complex),
    "fftn_not_volume": ("mesh8", _fftn_not_volume),
    "fftn_depth": ("mesh8", _fftn_depth),
    "fftn_not_divisible": ("mesh8", _fftn_not_divisible),
    "lfilter": ("mesh8", _lfilter),
    "lfilter_fir": ("mesh8", _lfilter_fir),
    "lfilter_indivisible": ("mesh8", _lfilter_indivisible),
    "lfilter_2d": ("mesh8", _lfilter_2d),
}


# ── The gloo world ───────────────────────────────────────────────────────────


def _gather(out):
    """Every DTensor of an output as (numpy, placements); collective."""
    from torch.distributed.tensor import DTensor

    if isinstance(out, tuple):
        return tuple(_gather(o) for o in out)
    if isinstance(out, DTensor):
        return out.full_tensor().numpy(), [f"Shard({p.dim})" if p.is_shard() else type(p).__name__
                                           for p in out.placements]
    return np.asarray(out), None


def _run_case(name, meshes):
    import gpu_fft_tpu_torch.kernels.large as large
    import gpu_fft_tpu_torch.parallel as tp
    import gpu_fft_tpu_torch.plan as plan

    mesh_name, call = CASES[name]
    patched = name == "distributed_staged"
    if patched:
        large.FUSED_MAX = plan.FUSED_MAX = 256
        plan.get_stage_a_plan.cache_clear()
        plan.clear_device_cache()
    try:
        return _gather(call(tp, meshes[mesh_name]))
    except ValueError as e:
        return ("ValueError", str(e))
    finally:
        if patched:
            from gpu_fft_tpu_torch.config import FUSED_MAX

            large.FUSED_MAX = plan.FUSED_MAX = FUSED_MAX
            plan.get_stage_a_plan.cache_clear()
            plan.clear_device_cache()


def _rank_main(rank, init_file, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import gpu_fft_tpu_torch.parallel as tp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        try:
            tp.default_mesh()  # the card by default: refused where there is none
            results["default_mesh_cuda"] = "built"
        except RuntimeError as e:
            results["default_mesh_cuda"] = str(e)
        meshes = {"mesh8": tp.default_mesh(device="cpu"),
                  "mesh2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=("dp", "sp"))}
        for name in CASES:
            results[name] = _run_case(name, meshes)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's output on the 8-rank gloo world: name -> result."""
    tmp = tmp_path_factory.mktemp("gloo")
    out_path = tmp / "results.pkl"
    ctx = multiprocessing.get_context("spawn")
    env = os.environ.get("GPU_FFT_TPU_TORCH_DEVICE")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "init"), str(out_path))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert env == os.environ.get("GPU_FFT_TPU_TORCH_DEVICE")
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(out_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_meshes():
    import jax
    from jax.sharding import Mesh

    import gpu_fft_tpu.parallel as jp

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return {"mesh8": jp.default_mesh(), "mesh2x4": Mesh(np.asarray(devs[:8]).reshape(2, 4), ("dp", "sp"))}


def _jax(name, jax_meshes):
    """The JAX package's output of case ``name``, as numpy."""
    import gpu_fft_tpu.kernels.large as jlarge
    import gpu_fft_tpu.parallel as jp
    import gpu_fft_tpu.plan as jplan

    mesh_name, call = CASES[name]
    if name == "distributed_staged":
        saved = jlarge.FUSED_MAX, jplan.FUSED_MAX
        jlarge.FUSED_MAX = jplan.FUSED_MAX = 256
        jplan.get_stage_a_plan.cache_clear()
        try:
            out = call(jp, jax_meshes[mesh_name])
        finally:
            jlarge.FUSED_MAX, jplan.FUSED_MAX = saved
            jplan.get_stage_a_plan.cache_clear()
    else:
        out = call(jp, jax_meshes[mesh_name])
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port(world, name):
    got = world[name]
    assert not isinstance(got[0], str), got
    return got


def _close(got, want, what, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max|d| {err:.3e} > {TOL} * {scale:.3e}"


def _check_against_jax(world, jax_meshes, name):
    got = _port(world, name)
    want = _jax(name, jax_meshes)
    if isinstance(want, tuple) and name.startswith("welch"):
        np.testing.assert_allclose(got[0][0], want[0], rtol=1e-12)
        _close(got[1][0], want[1], f"{name} psd", float(np.abs(want[1]).max()))
        return got
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    # max|JAX| over the whole output: a roundtrip's imaginary part is
    # rounding noise on the scale of its real part.
    scale = max(float(np.abs(w).max()) for w in want)
    for i, ((g, _), w) in enumerate(zip(got, want)):
        _close(g, w, f"{name}[{i}]", scale)
    return got


# ── Oracles (tests/test_parallel.py) and the JAX package ─────────────────────


def test_default_mesh_runs_on_the_card_unless_asked(world):
    assert "torch.cuda.is_available() is False" in world["default_mesh_cuda"]


def test_fft_batch_sharded_matches_oracle(world, jax_meshes):
    (yr, p), (yi, _) = _check_against_jax(world, jax_meshes, "fft_batch")
    ref = np.fft.fft(_real(1, 16, 1024).astype(np.float64), axis=-1)
    assert np.abs(yr - ref.real).max() < 1e-2 and np.abs(yi - ref.imag).max() < 1e-2
    assert p == ["Shard(0)"]


def test_ifft_batch_sharded_roundtrip(world, jax_meshes):
    (rr, _), (ri, _) = _check_against_jax(world, jax_meshes, "ifft_batch_roundtrip")
    assert np.abs(rr - _real(2, 8, 512)).max() <= 1e-3
    assert np.abs(ri).max() < 1e-3


def test_distributed_fft_matches_oracle(world, jax_meshes):
    (yr, p), (yi, _) = _check_against_jax(world, jax_meshes, "distributed")
    ref = np.fft.fft(_real(3, 4, 4096).astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 1e-5 and np.abs(yi - ref.imag).max() / scale < 1e-5
    assert p == ["Shard(0)", "Shard(1)"]


def test_distributed_roundtrip(world, jax_meshes):
    (rr, _), (ri, _) = _check_against_jax(world, jax_meshes, "distributed_roundtrip")
    assert np.abs(rr - _real(4, 2, 1024)).max() <= 1e-3
    assert np.abs(ri).max() < 1e-3


@pytest.mark.parametrize("name,match", [
    ("distributed_bad_factor", "n >= d\\^2"),
    ("distributed_indivisible", "not divisible"),
])
def test_distributed_rejects(world, jax_meshes, name, match):
    assert world[name][0] == "ValueError" and re.search(match, world[name][1]), world[name]
    with pytest.raises(ValueError, match=match):
        _jax(name, jax_meshes)


@pytest.mark.parametrize("n", [16, 32])
def test_distributed_mesh_aware_split(world, jax_meshes, n):
    (yr, _), (yi, _) = _check_against_jax(world, jax_meshes, f"distributed_split_{n}")
    ref = np.fft.fft(_real(5 + n, 2, n).astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 1e-5 and np.abs(yi - ref.imag).max() / scale < 1e-5


def test_distributed_large_n_beyond_fused_max(world, jax_meshes):
    (yr, _), (yi, _) = _check_against_jax(world, jax_meshes, "distributed_large")
    ref = np.fft.fft(_real(6, 2, 1 << 18).astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 2e-5 and np.abs(yi - ref.imag).max() / scale < 2e-5


def test_distributed_staged_local_transforms(world, jax_meshes):
    (yr, _), _ = _check_against_jax(world, jax_meshes, "distributed_staged")
    ref = np.fft.fft(_real(7, 1, 1 << 18).astype(np.float64), axis=-1)
    assert np.abs(yr - ref.real).max() / np.abs(ref).max() < 2e-5


def _welch_ref(x, **kw):
    from gpu_fft_tpu_torch import welch_device

    f, p = welch_device(torch.from_numpy(x), **kw)
    return np.asarray(f), p.numpy()


def test_welch_sharded_matches_single_chip(world, jax_meshes):
    (f, _), (p, places) = _check_against_jax(world, jax_meshes, "welch")
    f_ref, p_ref = _welch_ref(_real(8, 128 * 65 + 64), nperseg=256, fs=10.0)
    np.testing.assert_allclose(f, f_ref, atol=1e-9)
    scale = p_ref.max()
    assert np.abs(p / scale - p_ref / scale).max() <= 1e-4
    assert places == ["Replicate"]


@pytest.mark.parametrize("num_seg", [1, 7, 8, 9])
def test_welch_sharded_any_segment_count(world, jax_meshes, num_seg):
    _, (p, _) = _check_against_jax(world, jax_meshes, f"welch_segments_{num_seg}")
    _, p_ref = _welch_ref(_real(9 + num_seg, 64 * (num_seg - 1) + 128), nperseg=128)
    scale = p_ref.max()
    assert np.abs(p / scale - p_ref / scale).max() <= 1e-4


@pytest.mark.parametrize("name", ["welch_short", "welch_2d"])
def test_welch_sharded_contracts(world, jax_meshes, name):
    assert world[name][0] == "ValueError"
    with pytest.raises(ValueError):
        _jax(name, jax_meshes)


def test_fft2_batch_sharded_matches_oracle(world, jax_meshes):
    (yr, _), (yi, _) = _check_against_jax(world, jax_meshes, "fft2_batch")
    ref = np.fft.fft2(_real(10, 8, 16, 100).astype(np.float64), axes=(-2, -1))
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5 and np.abs(yi - ref.imag).max() / scale < 3e-5
    assert world["fft2_batch_indivisible"][0] == "ValueError"
    with pytest.raises(ValueError):
        _jax("fft2_batch_indivisible", jax_meshes)


def test_oaconvolve_sharded_matches_oracle(world, jax_meshes):
    ((got, places),) = _check_against_jax(world, jax_meshes, "oaconvolve")
    ref = np.convolve(_real(11, 40000).astype(np.float64), _real(12, 129).astype(np.float64))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-5
    assert places == ["Shard(0)"]


def test_oaconvolve_sharded_jit(world, jax_meshes):
    """JAX: under jax.jit as eager.  Port: a sharded DTensor input as the
    plain global array, and both as the JAX call under jit."""
    ((got, _),) = _check_against_jax(world, jax_meshes, "oaconvolve_again")
    ref = np.convolve(_real(13, 16384).astype(np.float64), _real(14, 64).astype(np.float64))
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


@pytest.mark.parametrize("name", ["oaconvolve_one_tap", "oaconvolve_long_taps"])
def test_oaconvolve_sharded_contracts(world, jax_meshes, name):
    assert world[name][0] == "ValueError"
    with pytest.raises(ValueError):
        _jax(name, jax_meshes)


def test_fft2_sharded_pencil_matches_oracle(world, jax_meshes):
    (yr, _), (yi, _), (br, _), (bi, _) = _check_against_jax(world, jax_meshes, "fft2_pencil")
    x = _real(15, 64, 128)
    ref = np.fft.fft2(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5 and np.abs(yi - ref.imag).max() / scale < 3e-5
    assert np.abs(br - x).max() < 1e-4 and np.abs(bi).max() < 1e-4


def test_fft2_sharded_complex_and_batch(world, jax_meshes):
    (yr, p), (yi, _) = _check_against_jax(world, jax_meshes, "fft2_complex_batch")
    ref = np.fft.fft2((_real(16, 4, 32, 64) + 1j * _real(17, 4, 32, 64)).astype(np.complex128))
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5 and np.abs(yi - ref.imag).max() / scale < 3e-5
    assert p == ["Shard(0)", "Shard(1)"]


def test_fft2_sharded_layout_stays_row_sharded(world, jax_meshes):
    (yr, places), _ = _check_against_jax(world, jax_meshes, "fft2_layout")
    assert places == ["Shard(0)"]  # rows, as JAX's P("dp", None): no silent gather


@pytest.mark.parametrize("name,match", [
    ("fft2_not_pow2", "power-of-two"), ("fft2_not_divisible", "divide"), ("fft2_imag_shape", "shapes differ"),
])
def test_fft2_sharded_contracts(world, jax_meshes, name, match):
    assert world[name][0] == "ValueError" and match in world[name][1], world[name]
    with pytest.raises(ValueError, match=match):
        _jax(name, jax_meshes)


def test_fftn_sharded_slab_matches_oracle(world, jax_meshes):
    (yr, places), (yi, _), (br, _), (bi, _) = _check_against_jax(world, jax_meshes, "fftn_slab")
    x = _real(19, 16, 32, 64)
    ref = np.fft.fftn(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5 and np.abs(yi - ref.imag).max() / scale < 3e-5
    assert np.abs(br - x).max() < 1e-4 and np.abs(bi).max() < 1e-4
    assert places == ["Shard(0)"]  # keeps the slab sharding


def test_fftn_sharded_complex_input(world, jax_meshes):
    (yr, _), (yi, _) = _check_against_jax(world, jax_meshes, "fftn_complex")
    ref = np.fft.fftn((_real(20, 8, 16, 32) + 1j * _real(21, 8, 16, 32)).astype(np.complex128))
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 3e-5 and np.abs(yi - ref.imag).max() / scale < 3e-5


@pytest.mark.parametrize("name,match", [
    ("fftn_not_volume", "volume"), ("fftn_depth", "power-of-two D"), ("fftn_not_divisible", "divide"),
])
def test_fftn_sharded_contracts(world, jax_meshes, name, match):
    assert world[name][0] == "ValueError" and match in world[name][1], world[name]
    with pytest.raises(ValueError, match=match):
        _jax(name, jax_meshes)


def test_lfilter_sharded_matches_scipy(world, jax_meshes):
    import scipy.signal as ss

    ((got, places),) = _check_against_jax(world, jax_meshes, "lfilter")
    b, a = _butter()
    ref = ss.lfilter(b, a, _real(22, 65536).astype(np.float64))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 5e-5
    assert places == ["Shard(0)"]


def test_lfilter_sharded_fir_and_contracts(world, jax_meshes):
    ((got, _),) = _check_against_jax(world, jax_meshes, "lfilter_fir")
    assert np.abs(got - 2.0 * _real(23, 4096)).max() < 1e-6
    for name in ("lfilter_indivisible", "lfilter_2d"):
        assert world[name][0] == "ValueError", name
        with pytest.raises(ValueError):
            _jax(name, jax_meshes)


def test_parallel_all_matches_jax():
    import gpu_fft_tpu.parallel as jp
    import gpu_fft_tpu_torch.parallel as tp

    assert tp.__all__ == jp.__all__
    assert all(callable(getattr(tp, n)) for n in tp.__all__)
