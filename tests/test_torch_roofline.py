"""The port's roofline accounting (``gpu_fft_tpu_torch/utils/roofline.py``)
against the JAX package's, and the parts of the timing layer that run
without a card.

Both packages' CPU tuning rows carry the same gates
(``gpu_fft_tpu/tuning.py`` "cpu-approx", ``gpu_fft_tpu_torch/tuning.py``),
so every ported cost kind must give the JAX package's FLOPs, bytes and
stages (rel 1e-12) on the same (B, n), and every other JAX kind is named
as not ported.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_fft_tpu.utils import roofline as jroof
from gpu_fft_tpu_torch import plan as tplan
from gpu_fft_tpu_torch.utils import profiling as tprof
from gpu_fft_tpu_torch.utils import roofline as roof

ROOT = Path(__file__).resolve().parent.parent
PORTED_KINDS = ("fft", "ifft", "roundtrip", "irfft", "grad_fft", "welch", "stft_roundtrip", "fft_exact",
                "hilbert", "dct_roundtrip", "resample", "oaconvolve", "fftfilt")
GRID = [(1, 1 << k) for k in range(8, 23)] + [(2, 16384), (16, 4096), (16, 65536)]
H100 = roof.CHIPS["h100"]


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_transform_cost_matches_the_jax_package(kind):
    for b, n in GRID:
        want = jroof.transform_cost(b, n, kind)
        got = roof.transform_cost(b, n, kind)
        assert got["bytes"] == want["bytes"], (kind, b, n)
        assert got["flops"] == pytest.approx(want["flops"], rel=1e-12), (kind, b, n)
        assert got["elem_flops"] == pytest.approx(want["elem_flops"], rel=1e-12, abs=0.0), (kind, b, n)
        assert [k for _, k in got["stages"]] == [k for _, k in want["stages"]], (kind, b, n)
        assert [f for f, _ in got["stages"]] == pytest.approx([f for f, _ in want["stages"]], rel=1e-12)


@pytest.mark.parametrize("n", [6, 1000, 44100, 48000, 65537, 997 * 1009, 1000003])
@pytest.mark.parametrize("b", [1, 3])
def test_fft_exact_cost_matches_the_jax_package_off_powers_of_two(b, n):
    """The mixed four-step's two stages, or Bluestein's two m-point
    transforms, as the JAX package charges them (GRID holds powers of two
    only)."""
    got, want = roof.transform_cost(b, n, "fft_exact"), jroof.transform_cost(b, n, "fft_exact")
    assert got["bytes"] == want["bytes"]
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12)
    assert got["stages"] == pytest.approx(want["stages"], rel=1e-12)


@pytest.mark.parametrize("kind", sorted(roof.NOT_PORTED_KINDS))
def test_unported_kinds_raise_not_implemented(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        roof.transform_cost(1, 4096, kind)


@pytest.mark.parametrize("kind", sorted(roof.NOT_PORTED_KINDS))
def test_unported_kinds_are_the_jax_packages(kind):
    assert jroof.transform_cost(16, 65536, kind)["flops"] > 0


@pytest.mark.parametrize("b,n", [(1, 16), (1, 1 << 15), (3, 1 << 16), (1, 1 << 17), (2, 1 << 18),
                                 (1, 1 << 20), (1, 1 << 24)])
def test_irfft_stages_match_the_jax_package(b, n):
    """The irfft stage list on both sides of both gates, up to 2^24 (which
    GRID does not reach): the staged fold counts the stage-A columns of the
    plan's default tile, ceil((n2/2 + 1) / ct) * ct."""
    got, want = roof.irfft_stages(b, n), jroof.irfft_stages(b, n)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-12) and got[2] == want[2]
    if n >= 1 << 18:
        n1 = tplan._stage_a_n1(n)
        n2 = n // n1
        ct = tplan.stage_a_col_tile(n1, n2)
        assert got[2] == -(-(n2 // 2 + 1) // ct) * ct / n2


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown"):
        roof.transform_cost(1, 1024, "nope")


def test_transform_cost_direct_whole_and_half():
    c = roof.transform_cost(8, 256, "fft")
    assert c["stages"] == [(2 * 2.0 * 8 * 256 * 256, 256)] and c["bytes"] == 8 * 256 * 4 * 3
    # (1, 16,384) is the whole-kernel band: n2 = 128, one twiddle.
    c3 = roof.transform_cost(1, 16384, "fft")
    assert c3["flops"] == pytest.approx(2 * 2.0 * 16384 * 128 + 3 * 2.0 * 16384 * 128 + 6.0 * 16384)
    # (1, 65,536) real: the half-spectrum route of the balanced split.
    frac = (256 // 2 + 1) / 256
    expected = 2 * 2.0 * 65536 * 256 + 3 * 2.0 * 65536 * 256 * frac + 11.0 * 65536 * frac + 2.0 * 65536
    assert roof.transform_cost(1, 65536, "fft")["flops"] == pytest.approx(expected)


def test_costs_grow_with_the_work():
    assert roof.transform_cost(1, 1 << 20, "fft")["flops"] > roof.transform_cost(1, 65536, "fft")["flops"]
    assert roof.transform_cost(1, 4096, "roundtrip")["flops"] > roof.transform_cost(1, 4096, "fft")["flops"]
    assert roof.transform_cost(1, 4096, "ifft")["flops"] > roof.transform_cost(1, 4096, "fft")["flops"]
    assert roof.transform_cost(64, 4096, "roundtrip")["flops"] > roof.transform_cost(16, 4096, "roundtrip")["flops"]


def test_transform_stages_follow_a_patched_digit(monkeypatch):
    """The staged cost reads ``plan._stage_a_n1`` at call time, so a
    harness that patches the digit (calibrate_chip) is costed with it."""
    n = 1 << 20
    base = roof.transform_stages(1, n, real_input=False)[0][0][1]
    monkeypatch.setattr(tplan, "_stage_a_n1", lambda n: 256)
    assert base == 128 and roof.transform_stages(1, n, real_input=False)[0][0][1] == 256


def test_eff_passes_classes():
    nominal = 989.0 / 67.0
    table = roof.EFF_PASSES["h100"]
    assert sorted(table) == [32, 64, 128, 256, 512]
    for k in table:
        assert roof.eff_passes("h100", k) == table[k]
    assert roof.eff_passes("h100", 200) == table[256]  # nearest class
    assert roof.eff_passes("cpu-approx", 128) == table[128]  # unknown chips read the h100 table
    assert min(table.values()) >= nominal * (1 - 1e-9)  # no class beats the fp32 peak


def test_h100_row_holds_the_published_rates():
    assert (H100.hbm_gbps, H100.bf16_tflops, H100.vpu_tflops) == (3350.0, 989.0, 67.0)
    assert sorted(roof.CHIPS) == ["cpu-approx", "h100"]
    # The measured launch floor: one kernel per step costs S5's time.
    assert 0.5 < H100.kernel_call_us < 3.0
    one = roof.roofline_row(1, 1024, "fft", 1e-5, chip=H100, n_kernels=1)["t_latency_us"]
    assert one == pytest.approx(H100.kernel_call_us)


def test_roofline_row_fields_and_bounds():
    row = roof.roofline_row(1, 65536, "fft", measured_s=10e-6, chip=H100)
    assert row["bound"] in ("hbm", "matmul", "elementwise")
    assert row["sol_us"] == pytest.approx(max(row["walls_us"].values()))
    assert row["pct_sol"] == pytest.approx(100.0 * row["sol_us"] / 10.0)
    assert row["chip"] == "h100" and set(row["walls_us"]) == {"hbm", "matmul", "elementwise"}
    assert "n_kernels" not in row and "latency" not in row["walls_us"]


def test_roofline_row_latency_wall():
    chip = dataclasses.replace(H100, kernel_call_us=2.0)
    row = roof.roofline_row(1, 1024, "fft", 5e-6, chip=chip, n_kernels=3)
    # Each of the three launches is charged the one-kernel floor.
    assert row["t_latency_us"] == pytest.approx(6.0) and row["walls_us"]["latency"] == pytest.approx(6.0)
    assert row["bound"] == "latency" and row["n_kernels"] == 3
    assert row["pct_sol"] == pytest.approx(100.0 * 6.0 / 5.0)
    # Without a launch floor the wall is absent.
    no_floor = roof.CHIPS["cpu-approx"]
    assert "t_latency_us" not in roof.roofline_row(1, 1024, "fft", 5e-6, chip=no_floor, n_kernels=3)


def test_detect_chip_is_the_cpu_row_without_a_card():
    assert roof.detect_chip() is roof.CHIPS["cpu-approx"]


def test_own_kernels_name_every_kernel_in_csrc():
    found = set()
    for src in (ROOT / "gpu_fft_tpu_torch" / "csrc").glob("*.cu*"):
        found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                src.read_text()))
    assert found == set(roof.OWN_KERNELS)


# ── The timing layer without a card (tests/test_profiling.py) ───────────────


@pytest.mark.parametrize(
    "call",
    [
        lambda x: tprof.chained_step_stats(lambda z: z * 2.0, x),
        lambda x: tprof.chained_step_time(lambda z: z * 2.0, x, k1=2, k2=200, reps=2),
        lambda x: tprof.benchmark(lambda z: z + 1.0, x),
        lambda x: roof.compiled_stats(lambda z: z * 2.0, x),
    ],
    ids=["chained_step_stats", "chained_step_time", "benchmark", "compiled_stats"],
)
def test_measuring_needs_the_card(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.ones(8, 128))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        _ = torch.ones(128, 128) @ torch.ones(128, 128)
    assert (tmp_path / "trace.json").is_file()


def test_timing_stats_rel_iqr():
    st = tprof.TimingStats(2e-6, 1e-7, 1.9e-6, 2.2e-6, 3, 100, False)
    assert st.rel_iqr == pytest.approx(0.05)
    assert np.isinf(tprof.TimingStats(0.0, 0.0, 0.0, 0.0, 1, 1, True).rel_iqr)


@pytest.mark.parametrize("name,shape", [("dct_roundtrip", (2, 512)), ("hilbert", (2, 1000)),
                                        ("oaconvolve", (1, 40000)), ("firstream", (1, 64 + 512)),
                                        ("resample", (2, 1024)), ("lfilter", (2, 3000))])
def test_filtering_steps_match_the_jax_packages(name, shape):
    """One step of each filtering chain on the CPU against the JAX
    package's step on the same input: the shape is kept (a chained step's
    contract) and the values agree within 2e-3 of max(1, max|JAX|) (the
    filtering tests' widest gate)."""
    import scipy.signal

    from gpu_fft_tpu.utils import profiling as jprof

    b, a = scipy.signal.butter(4, 0.2)
    taps = scipy.signal.firwin(257, 0.3)
    make = {
        "dct_roundtrip": lambda p: p.dct_roundtrip_step(),
        "hilbert": lambda p: p.hilbert_step(),
        "oaconvolve": lambda p: p.oaconvolve_step(shape[1], taps, **({"device": "cpu"} if p is tprof else {})),
        "firstream": lambda p: p.firstream_step(512, 65, **({"device": "cpu"} if p is tprof else {})),
        "resample": lambda p: p.resample_step(shape[1], shape[1] // 2),
        "lfilter": lambda p: p.lfilter_step(b, a),
    }[name]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    got = make(tprof)(torch.from_numpy(x)).numpy()
    want = np.asarray(make(jprof)(x))
    assert got.shape == x.shape == want.shape
    assert np.abs(got - want).max() <= 2e-3 * max(1.0, float(np.abs(want).max()))
