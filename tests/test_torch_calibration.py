"""The calibration path of the port (S1, S4, S5 and the five scripts that
reach them or that they feed) against the JAX package's scripts.

The JAX scripts cannot all be imported: ``scripts/ablate_engines.py`` asks
``gpu_fft_tpu.kernels.fused`` for ``fused_fft`` and ``fused_rfft`` and
``gpu_fft_tpu.plan`` for ``batch_tile``, which the package no longer has,
and the S4/S5 kernels are closures inside their scripts' ``main``.  So the
functions are pulled out of each script's source with ``ast`` and run in a
namespace that supplies what they use: the JAX package's ``_dot``,
``_cmatmul``, ``_vmem_spec``, ``_const_spec``, a batch tile of 1, and a
``pallas_call`` in interpret mode.

Inputs come from ``np.random.default_rng(seed)`` and go to both sides.
Tolerance: max |port - JAX| <= 1e-5 * max |JAX| (both fp32, summation order
differs); against numpy float64 a whole transform meets 5 * log2(N) * eps.
The scripts are rehearsed on the CPU with the card-only calls (the chained
timer, the kernel count, the device name and synchronise) replaced.
"""

import ast
import dataclasses
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

import gpu_fft_tpu.kernels.fused as jfused
import gpu_fft_tpu.kernels.tables as jtables
import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu_torch.kernels.engines as E
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.kernels.probes as Pr
import gpu_fft_tpu_torch.plan as tplan
from gpu_fft_tpu_torch.scripts import (
    ablate_engines,
    ablate_whole_packed,
    calibrate_chip,
    calibrate_latency,
    calibrate_matmul,
)
from gpu_fft_tpu_torch.tuning import ChipTuning, get_tuning
from gpu_fft_tpu_torch.utils import profiling as tprof
from gpu_fft_tpu_torch.utils import roofline as troof

RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
INTERPRET_PL = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True))


def _pull(script: str, names, inside: str | None = None, **env) -> dict:
    """The named function definitions of ``scripts/<script>.py`` (top level,
    or nested anywhere in the function ``inside``), executed in ``env``."""
    tree = ast.parse((SCRIPTS / script).read_text())
    scope = tree
    if inside is not None:
        scope = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == inside)
    found = {n.name: n for n in ast.walk(scope) if isinstance(n, ast.FunctionDef) and n.name in names}
    ns = dict(env)
    exec(compile(ast.Module(body=[found[n] for n in names], type_ignores=[]), script, "exec"), ns)
    return ns


def _close(got, want, rtol=RTOL):
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= rtol * scale, f"max|d| {err:.3e} > {rtol} * {scale:.3e}"


# ── S1: the left-matmul fused four-step ──────────────────────────────────────


@pytest.fixture(scope="module")
def j_engines():
    return _pull(
        "ablate_engines.py",
        ["lm_tables", "_lm_real_kernel", "fused_fft_pallas_lm", "fused_fft_jnp_lm"],
        jax=jax, jnp=jnp, pl=pl, _HI=lax.Precision.HIGHEST,
        _dot=jfused._dot, _cmatmul=jfused._cmatmul, _vmem_spec=jfused._vmem_spec,
        _const_spec=jfused._const_spec, _interpret=lambda: True,
        balanced_split=jplan.balanced_split, dft_matrix_ext=jtables.dft_matrix_ext,
        twiddle_table=jtables.twiddle_table, batch_tile=lambda n, complex_input: 1,
    )


S1_CASES = [(1, 4096), (3, 4096), (1, 16384)]


@pytest.fixture(scope="module")
def s1_jax(j_engines):
    """Per case: the input and the JAX script's kernel through an
    interpret-mode pallas_call (batch tile 1)."""
    out = {}
    for b, n in S1_CASES:
        x = np.random.default_rng(b * n).standard_normal((b, n)).astype(np.float32)
        t = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in j_engines["lm_tables"](n, -1).items()}
        out[(b, n)] = x, [np.asarray(y) for y in j_engines["fused_fft_pallas_lm"](jnp.asarray(x), t)]
    return out


@pytest.mark.parametrize("n", [4096, 16384, 32768])
def test_lm_tables_are_bit_equal_to_the_script(j_engines, n):
    want = j_engines["lm_tables"](n, -1)
    got = E.lm_tables(n, -1)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("b,n", S1_CASES)
@pytest.mark.parametrize("fn", ["fused_fft_lm", "fused_fft_lm_plain"])
def test_s1_matches_the_pallas_kernel_and_float64(s1_jax, b, n, fn):
    x, want = s1_jax[(b, n)]
    t = tplan.on_device(E.lm_tables, n, -1, device="cpu")
    E.reset_counts()
    got = [y.numpy() for y in getattr(E, fn)(torch.from_numpy(x), t)]
    _close(got, want)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    _close(got, [ref.real, ref.imag], rtol=5 * np.log2(n) * EPS32)
    through_wrapper = fn == "fused_fft_lm"
    assert E.COUNTS["fused_fft_lm"].plain_calls == int(through_wrapper)
    assert E.COUNTS["fused_fft_lm"].launches == 0


def test_torch_lm_matches_the_scripts_jnp_lm(j_engines, s1_jax):
    x, _ = s1_jax[(3, 4096)]
    t = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in j_engines["lm_tables"](4096, -1).items()}
    want = j_engines["fused_fft_jnp_lm"](jnp.asarray(x), t)
    got = E.fused_fft_lm_plain(torch.from_numpy(x), tplan.on_device(E.lm_tables, 4096, -1, device="cpu"))
    _close([y.numpy() for y in got], want)


# ── S4 and S5: the launch-floor probes ───────────────────────────────────────


@pytest.fixture(scope="module")
def probe_tables():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((128, 128)).astype(np.float32) for _ in range(8)]


@pytest.mark.parametrize("k", Pr.PROBE_KS)
def test_operand_probe_matches_the_script_kernel(probe_tables, k):
    ns = _pull("ablate_whole_packed.py", ["probe"], inside="main", jax=jax, jnp=jnp, np=np,
               pl=INTERPRET_PL, tables=[jnp.asarray(t) for t in probe_tables])
    x = np.random.default_rng(k).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(ns["probe"](k)(jnp.asarray(x)))
    Pr.reset_counts()
    got = Pr.operand_probe(torch.from_numpy(x), [torch.from_numpy(t) for t in probe_tables[:k]]).numpy()
    # The script's formula with each product and sum rounded on its own, in
    # its order: the plain version (and the kernel) bit for bit.
    steps = x * np.float32(Pr.SCALE)
    for t in probe_tables[:k]:
        steps = steps + t[:8] * np.float32(Pr.TABLE_SCALE)
    assert np.array_equal(got, steps)
    # XLA on the CPU fuses the script's first add into an FMA, one rounding
    # fewer: its kernel is within one ulp of each element.  A table left out
    # (t * 2^-24 against x) or the scale left out (x * 2^-20) misses by more.
    ulp = np.maximum(np.spacing(np.abs(want)), np.spacing(np.abs(got)))
    assert np.all(np.abs(got - want) <= ulp)
    assert Pr.COUNTS["operand_probe"].plain_calls == 1 and Pr.COUNTS["operand_probe"].launches == 0


def test_copy_min_matches_the_script_kernel():
    ns = _pull("calibrate_latency.py", ["_copy_kernel", "pallas_min"], inside="main",
               jax=jax, jnp=jnp, pl=INTERPRET_PL)
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(ns["pallas_min"](jnp.asarray(x)))
    Pr.reset_counts()
    got = Pr.copy_min(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    assert Pr.COUNTS["copy_min"].plain_calls == 1 and Pr.COUNTS["copy_min"].launches == 0


def test_operand_probe_takes_only_the_swept_counts():
    with pytest.raises(ValueError, match="k in"):
        Pr.operand_probe(torch.zeros(8, 128), [torch.zeros(128, 128)] * 3)


def _meta_calls():
    return {
        "fused_fft_lm": lambda: E.fused_fft_lm(torch.empty(1, 4096, device="meta"), {}),
        "operand_probe": lambda: Pr.operand_probe(torch.empty(8, 128, device="meta"), []),
        "copy_min": lambda: Pr.copy_min(torch.empty(8, 128, device="meta")),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_calibration_wrappers_have_no_fallback_off_the_cpu(name):
    E.reset_counts()
    Pr.reset_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    c = {**E.COUNTS, **Pr.COUNTS}[name]
    assert c.launches == 0 and c.plain_calls == 0


# Every (n1, n2) of the kernel's range: n1 <= n2 a power of two >= 8 (the
# balanced splits of 2,048 ... 65,536 among them).
LM_SPLITS = [(n1, n2) for n2 in E.LM_N2 for n1 in (8, 16, 32, 64, 128, 256) if n1 <= n2]


@pytest.mark.parametrize("n1,n2", LM_SPLITS)
@pytest.mark.parametrize("b", [1, 3, 16])
def test_lm_geometry_fits_and_covers(n1, n2, b):
    """S1's launch rule (the whole kernel at n2 = 64, 128, 256): one cluster
    of at most 16 blocks per row, each within the H100's 1,024 threads and
    232,448 bytes of shared memory, 8 complex values per thread; the blocks'
    column slices (stage 1) and row slices (stage 2) cover the (n1, n2) view
    exactly once."""
    cluster, threads, smem = K.lm_geometry(b, n1, n2)
    assert cluster & (cluster - 1) == 0 and 1 <= cluster <= min(16, n1)
    assert threads <= 1024 and threads * 8 * cluster == n1 * n2
    assert 8 * (n1 * n2 // cluster + n1 + n2) <= smem <= 232_448
    slices = K.whole_slices(n1, cluster, n2)
    assert sorted(c for cols, _ in slices for c in cols) == list(range(n2))
    assert sorted(r for _, rows in slices for r in rows) == list(range(n1))
    assert all(len(cols) * n1 == len(rows) * n2 == threads * 8 for cols, rows in slices)
    if n1 * n2 >= 2048:
        assert tplan.balanced_split(n1 * n2) in LM_SPLITS


@pytest.mark.parametrize("n1,n2", [(12, 256), (4, 64), (48, 128), (512, 256), (16, 96)])
def test_lm_geometry_rejects_what_the_kernel_cannot_take(n1, n2):
    with pytest.raises(ValueError, match="power of two"):
        K.lm_geometry(1, n1, n2)


# ── The scripts' arithmetic ──────────────────────────────────────────────────


def test_clock_summary_reads_nvidia_smi_lines():
    text = "1980, 1980\n1755, 1980\n[Unknown Error]\n1980, 1980\n"
    assert calibrate_latency.clock_summary(text) == {
        "samples": 3, "median_mhz": 1980.0, "min_mhz": 1755.0, "max_mhz": 1980.0, "max_clock_mhz": 1980.0}
    assert calibrate_latency.clock_summary("") is None


def test_eff_passes_of_is_the_jax_formula():
    # 67 MFLOP in 1 us is 67 TFLOP/s: 989 / 67 passes.
    assert calibrate_matmul.eff_passes_of(1e-6, 67e6, 989.0) == pytest.approx(989.0 / 67.0)


def test_whole_packed_parity_failures():
    limit = 5 * np.log2(1024) * EPS32
    rows = [{"kind": "real", "n": 1024, "parity": limit / 2}, {"kind": "real", "n": 2048, "parity": 1e-3},
            {"kind": "complex", "n": 1024}]
    assert sorted(ablate_whole_packed.parity_failures({"rows": rows})) == ["complex_n1024", "real_n2048"]


def test_engine_errors_allow_only_the_retired_rows():
    entries = [
        {"group": "accuracy", "variant": "pallas", "error": ablate_engines.RETIRED},
        {"group": "accuracy", "variant": "jnp", "n": 65536, "rel_err": 1e-7},
        {"group": "accuracy", "variant": "pallas_lm", "n": 65536, "rel_err": 1e-3},
        {"group": "engine", "variant": "pallas_lm", "error": "RuntimeError: boom"},
    ]
    res = {"entries": entries}
    assert ablate_engines.unexpected_errors(res) == [entries[3]]
    assert ablate_engines.accuracy_failures(res) == [entries[2]]


def test_tuning_entry_is_a_chip_tuning():
    text = calibrate_chip.tuning_entry(get_tuning(), 16, 256, calibrate_chip.NEVER, 1 << 16, 8192)
    t = eval(text, {"ChipTuning": ChipTuning})
    assert t == dataclasses.replace(get_tuning(), wide_batch_min=16, stage_a_n1=256,
                                    half_spectrum_min=1 << 62, irfft_half_min=1 << 16,
                                    oa_block_min=8192, calibrated=True, note=t.note)


# ── The scripts, rehearsed on the CPU ────────────────────────────────────────


@pytest.fixture
def rehearsal(monkeypatch):
    """Replace the card-only calls: the chained timer runs the step once and
    checks it keeps its shape; the kernel count is fixed."""
    timed = []

    def fake_stats(step, x0, **kw):
        assert step(x0).shape == x0.shape
        timed.append(kw)
        return tprof.TimingStats(2e-6, 1e-8, 2e-6, 2e-6, 1, 10, False)

    monkeypatch.setattr(tprof, "chained_step_stats", fake_stats)
    monkeypatch.setattr(troof, "compiled_stats", lambda step, x0: {
        "n_kernels": 2, "n_own_kernels": 1, "own_kernels": {"whole_transform_packed": 1},
        "kernel_names": ["mul"], "fingerprint": "0"})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu rehearsal")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    E.reset_counts()
    Pr.reset_counts()
    return timed


def test_calibrate_latency_rehearsal(rehearsal, tmp_path):
    res = calibrate_latency.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert sorted(res["rows"]) == sorted([
        "scale_8x128", "scale_256x1024", "dot_128x128", "kernel_copy_8x128", "kernel_whole_n1024",
        "fft_n1024", "fft_n4096"])
    assert res["kernel_call_us"] == pytest.approx(2.0)
    assert [res["launch_chain"][str(d)]["per_kernel_us"] for d in calibrate_latency.CHAIN_DEPTHS] == \
        pytest.approx([2.0, 1.0, 0.5, 0.25])
    assert res["sm_clock"] is None  # no card to sample
    assert res["roofline"]["fft_n1024"]["bound"] == "latency"
    assert Pr.COUNTS["copy_min"].plain_calls > 0 and Pr.COUNTS["copy_min"].launches == 0
    assert (tmp_path / "calibrate_latency_results.json").is_file()


def test_calibrate_matmul_rehearsal(rehearsal, tmp_path):
    res = calibrate_matmul.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert sorted(res["classes"], key=int) == [str(k) for k in calibrate_matmul.CONTRACTIONS]
    assert sorted(res["patterns"]) == ["pair_k128", "pair_k256", "triple_k128", "triple_k256"]
    assert res["tf32"] is False
    assert (tmp_path / "calibrate_matmul_results.json").is_file()


def test_ablate_whole_packed_rehearsal(rehearsal, tmp_path):
    res = ablate_whole_packed.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert sorted(res["operand_probe"], key=int) == [str(k) for k in Pr.PROBE_KS]
    assert [(r["kind"], r["n"]) for r in res["rows"]] == [
        (kind, n) for kind in ("real", "complex") for n in ablate_whole_packed.SIZES]
    assert not ablate_whole_packed.parity_failures(res)
    assert Pr.COUNTS["operand_probe"].plain_calls == len(Pr.PROBE_KS)


def test_ablate_engines_rehearsal(rehearsal, tmp_path):
    res = ablate_engines.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert not ablate_engines.unexpected_errors(res) and not ablate_engines.accuracy_failures(res)
    retired = [e for e in res["entries"] if e.get("error") == ablate_engines.RETIRED]
    assert {e["group"] for e in retired} == {"accuracy", "engine"}
    timed = {(e["variant"], e["batch"], e["n"]) for e in res["entries"] if "best_us" in e}
    assert timed == {(v, b, n) for v in ("jnp", "jnp_lm", "pallas_lm") for b, n in ablate_engines.QUICK_CONFIGS}
    assert E.COUNTS["fused_fft_lm"].plain_calls > 0 and E.COUNTS["fused_fft_lm"].launches == 0


def test_calibrate_chip_rehearsal(rehearsal, tmp_path):
    orig = tplan._stage_a_n1
    res = calibrate_chip.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert tplan._stage_a_n1 is orig  # the patched digit is restored
    assert [r["block"] for r in res["oa_block"]] == list(calibrate_chip.OA_BLOCKS)
    assert all(r["us"] > 0 for r in res["oa_block"])
    assert [r["n"] for r in res["irfft_fold"]] == [1 << 14, 1 << 15]
    assert all(r["full_us"] > 0 and r["fold_us"] > 0 for r in res["irfft_fold"])
    assert [r["n1"] for r in res["stage_a_digit"]] == [128, 256]
    assert len(res["wide_split"]) == 9 and len(res["half_spectrum"]) == 2
    assert "ChipTuning(" in res["tuning_entry"]
    # Equal (fake) times: the fold never wins, so its gate stays closed.
    assert f"irfft_half_min={calibrate_chip.NEVER}," in res["tuning_entry"]


def test_calibrate_chip_oa_block_section_rehearsal(rehearsal, monkeypatch, tmp_path):
    """The overlap-add section times ``oaconvolve_device`` of the JAX
    script's 262,144-sample signal with 257 taps at each block and pastes
    the fastest into the entry.  Each timed step is held against the JAX
    package's oaconvolve at that block (2e-3 of max(1, max|ref|),
    ``tests/test_filter.py``'s gate); the fake times make 8,192 the
    fastest."""
    from gpu_fft_tpu.ops.filter import firwin as jfirwin
    from gpu_fft_tpu.ops.filter import oaconvolve_device as joa

    fake_us = dict(zip(calibrate_chip.OA_BLOCKS, (5.0, 3.0, 4.0, 6.0)))
    oa_steps = []

    def fake_stats(step, x0, **kw):
        y = step(x0)
        assert y.shape == x0.shape
        us = 2.0
        if x0.shape == (1, 1 << 18):
            oa_steps.append((x0, y))
            if len(oa_steps) > 2:  # the two stage-A digit rows come first at this shape
                us = fake_us[calibrate_chip.OA_BLOCKS[len(oa_steps) - 3]]
        return tprof.TimingStats(us * 1e-6, 1e-8, us * 1e-6, us * 1e-6, 1, 10, False)

    monkeypatch.setattr(tprof, "chained_step_stats", fake_stats)
    res = calibrate_chip.main(quick=True, out_dir=str(tmp_path), device="cpu")
    assert [r["us"] for r in res["oa_block"]] == pytest.approx([fake_us[b] for b in calibrate_chip.OA_BLOCKS])
    assert "oa_block_min=8192," in res["tuning_entry"]
    taps = jfirwin(257, 0.3).astype(np.float32)
    for (x0, y), blk in zip(oa_steps[2:], calibrate_chip.OA_BLOCKS):
        x = x0.numpy()
        want = np.asarray(joa(x, taps, block=blk))[:, : x.shape[1]]
        assert np.abs(y.numpy() - want).max() / max(1.0, np.abs(want).max()) < 2e-3
