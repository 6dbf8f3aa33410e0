"""The stage-A variants of the port (K3-legacy, S2, S3) and the harness
plumbing around them, against the JAX package and its ablation scripts.

Inputs come from ``np.random.default_rng(seed)`` and go to both sides.  The
JAX side runs on the CPU, Pallas in interpret mode.  The JAX scripts under
``scripts/`` are imported by path; their ``__main__`` guards keep ``main``
from running.

Tolerance: max |port - JAX| <= 1e-5 * max |JAX|.  Both sides compute in fp32
(bf16 parts are exact in fp32, and so is each bf16 x bf16 product) and differ
only in summation order, a few fp32 ulps; TF32 (~5e-4) would be ~50x over.
Against numpy float64, a whole transform meets 5 * log2(N) * eps.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import gpu_fft_tpu.kernels.fused as jfused
import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu.utils.profiling as jprof
import gpu_fft_tpu_torch.kernels.ablation as A
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.plan as tplan
import gpu_fft_tpu_torch.utils.profiling as tprof
from gpu_fft_tpu_torch.scripts import ablate_2e20_levers as t_levers
from gpu_fft_tpu_torch.scripts import ablate_large as t_large
from gpu_fft_tpu_torch.scripts import ablate_mosaic_x6 as t_x6

RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
ROOT = Path(__file__).resolve().parent.parent
N17 = 1 << 17


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def j_large():
    return _script("ablate_large")


@pytest.fixture(scope="module")
def j_x6():
    return _script("ablate_mosaic_x6")


def _close(got, want, rtol=RTOL):
    want = [np.asarray(w, dtype=np.float64) for w in want]
    got = [np.asarray(g, dtype=np.float64) for g in got]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= rtol * scale, f"max|d| {err:.3e} > {rtol} * {scale:.3e}"


def _np(ts):
    return [t.numpy() for t in ts]


# ── K3-legacy: stage_a on a materialized-twiddle plan ────────────────────────


@pytest.mark.parametrize("n1", [16, 128])
def test_make_plan_is_bit_equal_to_the_script(j_large, n1):
    want = j_large.make_plan(N17, n1, -1)
    got = t_large.make_plan(N17, n1, -1)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


LEGACY_CASES = {
    "real": dict(complex_=False, half_rows=False, col_tiles=None),
    "real_half_rows": dict(complex_=False, half_rows=True, col_tiles=None),
    "complex": dict(complex_=True, half_rows=False, col_tiles=None),
    "complex_col_tiles1": dict(complex_=True, half_rows=False, col_tiles=1),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
@pytest.mark.parametrize("n1", [16, 128])
def test_stage_a_legacy_plain_matches_pallas(j_large, n1, case):
    """``rows`` is a real input's half-spectrum count: 72 at n1 = 128, 16 at
    n1 = 16; ``col_tile`` is the script's ``stage_a_col_tile`` (512)."""
    c = LEGACY_CASES[case]
    jp = j_large.make_plan(N17, n1, -1)
    n2 = jp["n2"]
    ct = tplan.stage_a_col_tile(n1, n2)
    rows = tplan.stage_a_real_rows(n1) if c["half_rows"] else None
    rng = np.random.default_rng(n1 + len(case))
    xr = rng.standard_normal((1, n1, n2)).astype(np.float32)
    xi = rng.standard_normal((1, n1, n2)).astype(np.float32) if c["complex_"] else None
    want = jfused.stage_a(
        jnp.asarray(xr), None if xi is None else jnp.asarray(xi), n1, n2, jp, ct,
        col_tiles=c["col_tiles"], rows=rows,
    )
    tp = tplan.on_device(t_large.make_plan, N17, n1, -1, device="cpu")
    K.reset_counts()
    got = K.stage_a(
        torch.from_numpy(xr), None if xi is None else torch.from_numpy(xi), n1, n2, tp, ct,
        col_tiles=c["col_tiles"], rows=rows,
    )
    _close(_np(got), want)
    assert K.COUNTS["stage_a_legacy"].plain_calls == 1
    assert K.COUNTS["stage_a_legacy"].launches == 0 and K.COUNTS["stage_a"].plain_calls == 0


def test_stage_a_legacy_takes_any_col_tile():
    """A legacy plan has no ``ct``: the caller's col_tile only tiles the
    columns, and ``col_tiles`` keeps the first tiles."""
    tp = tplan.on_device(t_large.make_plan, N17, 128, -1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 128, 1024)).astype(np.float32))
    full = K.stage_a(x, None, 128, 1024, tp, 256)
    part = K.stage_a(x, None, 128, 1024, tp, 128, col_tiles=3)
    assert part[0].shape == (1, 128, 384)
    _close(_np(part), [full[0][:, :, :384].numpy(), full[1][:, :, :384].numpy()])


# ── S2: stage_a_manual ───────────────────────────────────────────────────────


def test_stage_a_manual_plain_matches_pallas_stage_a(j_large):
    """S2's JAX code is a closure inside the script's ``main``; it computes
    the JAX ``stage_a`` on the legacy plan at B = 1, real input."""
    n1 = 128
    jp = j_large.make_plan(N17, n1, -1)
    n2 = jp["n2"]
    x = np.random.default_rng(11).standard_normal((n1, n2)).astype(np.float32)
    want = jfused.stage_a(jnp.asarray(x)[None], None, n1, n2, jp, tplan.stage_a_col_tile(n1, n2))
    tp = tplan.on_device(t_large.make_plan, N17, n1, -1, device="cpu")
    A.reset_counts()
    got = A.stage_a_manual(torch.from_numpy(x), tp)
    _close(_np(got), [w[0] for w in want])
    assert A.COUNTS["stage_a_manual"].plain_calls == 1 and A.COUNTS["stage_a_manual"].launches == 0


# ── S3: the stage-A dot in three precisions ──────────────────────────────────


def _bits(parts):
    return [np.asarray(p).view(np.uint16) for p in parts]


def test_split3_bf16_is_bit_equal_to_the_script(j_x6):
    a = (np.random.default_rng(5).standard_normal((32, 64)) * 3.0).astype(np.float32)
    want = _bits(j_x6.split3_bf16(a))
    got = [p.view(torch.int16).numpy().view(np.uint16) for p in A.split3_bf16(torch.from_numpy(a))]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _pallas_x6(j_x6, variant, x, fr, fi, ct):
    """The script's kernel bodies through an interpret-mode pallas_call with
    BlockSpecs that pin no memory space (the script's ``build`` pins VMEM)."""
    _, n1, n2 = x.shape
    x_spec = pl.BlockSpec((1, n1, ct), lambda i, j: (i, 0, j))
    f_spec = pl.BlockSpec((n1, n1), lambda i, j: (0, 0))
    if variant == "bf16_x6":
        tabs = [jnp.asarray(t) for t in j_x6.split3_bf16(fr) + j_x6.split3_bf16(fi)]
        kern = j_x6.kern_x6
    else:
        tabs = [jnp.asarray(fr), jnp.asarray(fi)]
        kern = j_x6.kern_x1 if variant == "bf16_x1" else j_x6.kern_f32
    call = pl.pallas_call(
        kern,
        grid=(1, n2 // ct),
        in_specs=[x_spec] + [f_spec] * len(tabs),
        out_specs=[x_spec, x_spec],
        out_shape=[jax.ShapeDtypeStruct((1, n1, n2), jnp.float32)] * 2,
        interpret=True,
    )
    return call(jnp.asarray(x), *tabs)


@pytest.mark.parametrize("variant", A.VARIANTS)
@pytest.mark.parametrize("n1,n2", [(32, 256), (32, 1024), (128, 256), (128, 1024)])
def test_stage_a_dot_plain_matches_script_kernels(j_x6, variant, n1, n2):
    rng = np.random.default_rng(n1 + n2)
    fr = rng.standard_normal((n1, n1)).astype(np.float32) * (1.0 / n1)
    fi = rng.standard_normal((n1, n1)).astype(np.float32) * (1.0 / n1)
    x = rng.standard_normal((1, n1, n2)).astype(np.float32)
    want = _pallas_x6(j_x6, variant, x, fr, fi, ct=min(256, n2))
    run = t_x6.build(variant, n1, n2, min(256, n2), fr, fi, device="cpu")
    A.reset_counts()
    got = run(torch.from_numpy(x))
    _close(_np(got), want)
    assert A.COUNTS[f"stage_a_dot_{variant}"].plain_calls == 1
    assert A.COUNTS[f"stage_a_dot_{variant}"].launches == 0


def test_stage_a_dot_ladder_is_accurate_and_x1_is_not():
    """bf16_x6 and f32 meet 5 log2(n1) eps against float64; bf16_x1 keeps
    about three digits."""
    n1, n2 = 32, 512
    rng = np.random.default_rng(9)
    fr = rng.standard_normal((n1, n1)).astype(np.float32) / n1
    x = rng.standard_normal((1, n1, n2)).astype(np.float32)
    ref = fr.astype(np.float64) @ x[0].astype(np.float64)
    tables = A.dot_tables(torch.from_numpy(fr), torch.from_numpy(fr))
    err = {}
    for v in A.VARIANTS:
        yr, _ = A.stage_a_dot_plain(torch.from_numpy(x), tables, v)
        err[v] = np.abs(yr[0].numpy() - ref).max() / np.abs(ref).max()
    gate = 5 * np.log2(n1) * EPS32
    assert err["f32_highest"] <= gate and err["bf16_x6"] <= gate, err
    assert 1e-4 < err["bf16_x1"] < 1e-2, err


# ── Harness plumbing ─────────────────────────────────────────────────────────


@pytest.mark.parametrize("n1", [16, 128])
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_staged_fft_matches_the_script_and_numpy(j_large, n1, engine):
    x = np.random.default_rng(n1).standard_normal((1, N17)).astype(np.float32)
    j_engine = {"kernel": "pallas", "torch": "jnp"}[engine]
    want = j_large.staged_fft(jnp.asarray(x), j_large.make_plan(N17, n1, -1), j_engine)
    tp = tplan.on_device(t_large.make_plan, N17, n1, -1, device="cpu")
    got = _np(t_large.staged_fft(torch.from_numpy(x), tp, engine))
    ref = np.fft.fft(x[0].astype(np.float64))
    gate = 5 * np.log2(N17) * EPS32
    _close(got, want, rtol=gate)
    _close(got, [ref.real[None], ref.imag[None]], rtol=gate)


def test_staged_fft_rejects_an_unknown_engine():
    tp = tplan.on_device(t_large.make_plan, N17, 128, -1, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        t_large.staged_fft(torch.zeros(1, N17), tp, "pallas")


@pytest.mark.parametrize(
    "name", ["fft_forward_step", "fft_inverse_step", "fft_roundtrip_step"]
)
def test_steps_match_the_jax_steps(name):
    n = 4096
    x = np.random.default_rng(2).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(getattr(jprof, name)(n)(jnp.asarray(x)))
    got = getattr(tprof, name)(n)(torch.from_numpy(x)).numpy()
    _close([got], [want])


@pytest.mark.parametrize("kind", ["fft", "ifft", "roundtrip"])
def test_sequential_steps_match_the_batched_step(kind):
    n = 1024
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, n)).astype(np.float32))
    batched_name = {"fft": "forward", "ifft": "inverse", "roundtrip": "roundtrip"}[kind]
    batched = getattr(tprof, f"fft_{batched_name}_step")(n)(x)
    seq = getattr(tprof, f"{kind}_sequential_step")(n)(x)
    _close([seq.numpy()], [batched.numpy()])


@pytest.mark.parametrize("kind", ["forward", "inverse", "roundtrip"])
def test_torch_fft_steps_match_the_xla_steps(kind):
    n = 1024
    x = np.random.default_rng(6).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(getattr(jprof, f"xla_fft_{kind}_step")(n)(jnp.asarray(x)))
    got = getattr(tprof, f"torch_fft_{kind}_step")(n)(torch.from_numpy(x)).numpy()
    _close([got], [want])


def test_chained_step_stats_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tprof.chained_step_stats(lambda x: x, torch.zeros(4))


def test_benchmark_and_trace_on_the_cpu(tmp_path):
    step = tprof.fft_forward_step(1024)
    with tprof.trace(str(tmp_path / "t")):
        step(torch.zeros(1, 1024))
    assert (tmp_path / "t" / "trace.json").is_file()
    with pytest.raises(ValueError, match="CUDA"):
        tprof.benchmark(step, torch.zeros(1, 1024))
    r = tprof.BenchResult(seconds=2e-6, elements=1024)
    assert r.microseconds == pytest.approx(2.0) and r.melem_per_s == pytest.approx(512.0)


def test_clear_device_cache_drops_uploaded_plans():
    a = tplan.on_device(t_large.make_plan, N17, 16, -1, device="cpu")
    assert tplan.on_device(t_large.make_plan, N17, 16, -1, device="cpu") is a
    tplan.clear_device_cache()
    assert tplan.on_device(t_large.make_plan, N17, 16, -1, device="cpu") is not a


def test_lever_errors_allow_only_the_unported_irfft_rows():
    """The L4 irfft rows are ported now: no row may hold an error, and a
    "not ported" row is one too."""
    rows = {
        "L0_shipped": {"us": 1.0},
        "L4_irfft_n131072_ct512": {"error": "not ported"},
        "L4_fft_n131072_ct512": {"error": "RuntimeError: boom"},
        "L4_irfft_n262144_ct512": {"error": "TypeError: x"},
        "L4_irfft_n262144_ct1024": {"us": 1.0, "parity": 0.0},
    }
    assert sorted(t_levers.unexpected_errors({"rows": rows})) == [
        "L4_fft_n131072_ct512", "L4_irfft_n131072_ct512", "L4_irfft_n262144_ct512",
    ]


@pytest.mark.parametrize("mode,limit", [(None, t_levers.PARITY_LIMIT), ("full", t_levers.PARITY_LIMIT),
                                        ("high", 4e-4), ("fast", 4e-2)])
def test_lever_parity_limit_follows_the_results_mode(mode, limit):
    """The gate is the fp32 one under "full" (and where the results name no
    mode); twice the JAX package's band under "high" and "fast", where the
    re-blocked plans round other operands to bf16."""
    assert t_levers.parity_limit(mode or "full") == limit
    rows = {"L0_shipped": {"us": 1.0, "parity": 0.0},
            "L2_m32x256": {"us": 1.0, "parity": limit / 2},
            "L3_stageA_emit_pipeline": {"us": 1.0, "parity": limit * 2}}
    results = {"rows": rows} if mode is None else {"mode": mode, "rows": rows}
    assert sorted(t_levers.parity_failures(results)) == ["L3_stageA_emit_pipeline"]


def test_lever_parity_failures_flag_rows_over_the_gate_or_without_parity():
    limit = t_levers.PARITY_LIMIT
    rows = {
        "L0_shipped": {"us": 1.0, "parity": 0.0},
        "L4_fft_n262144_ct1024": {"us": 1.0, "parity": limit / 2},
        "L4_fft_n262144_ct2048": {"us": 1.0, "parity": limit * 2},
        "L4_fft_n131072_ct512": {"us": 1.0},
        "L4_irfft_n131072_ct512": {"error": "RuntimeError: boom"},
    }
    assert sorted(t_levers.parity_failures({"rows": rows})) == [
        "L4_fft_n131072_ct512", "L4_fft_n262144_ct2048",
    ]


# ── No fallback off the CPU ──────────────────────────────────────────────────


def _meta_calls():
    legacy = {"twr": None, "twi": None}
    return {
        "stage_a_legacy": lambda: K.stage_a(torch.empty(1, 16, 64, device="meta"), None, 16, 64, legacy, 32),
        "stage_a_manual": lambda: A.stage_a_manual(torch.empty(128, 1024, device="meta"), legacy),
        "stage_a_legacy_bf16": lambda: K.stage_a_bf16(torch.empty(1, 16, 64, device="meta"), None, 16, 64,
                                                      {**legacy, **dict.fromkeys(("f1r", "f1i", "f1s", "f1d"))},
                                                      32),
        "stage_a_manual_bf16": lambda: A.stage_a_manual_bf16(torch.empty(128, 1024, device="meta"), legacy),
        **{
            f"stage_a_dot_{v}": (lambda v=v: A.stage_a_dot(torch.empty(1, 32, 64, device="meta"), {}, v))
            for v in A.VARIANTS
        },
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_new_wrappers_have_no_fallback_off_the_cpu(name):
    K.reset_counts()
    A.reset_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    counts = {**K.COUNTS, **A.COUNTS}[name]
    assert counts.plain_calls == 0 and counts.launches == 0


def test_stage_a_dot_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        A.stage_a_dot(torch.zeros(1, 32, 64), {}, "tf32")
