"""Whole runs of each cell on the CPU at a tiny size, past the look for a
card: sound, ``correct`` is true; with the timed path broken underneath
(half of the batch left out; one answer altered where it is produced), it
is false."""

from __future__ import annotations

import time

import pytest

from portbench.harness import core, spec
from portbench.tools.faults import Broken

from .tiny import tiny_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 12345
BATCH = "gpufft.fft_batch_b16_n65536"
WELCH = "scipy.welch_n100000_seg1024"
T0 = time.perf_counter()


@pytest.fixture(scope="module")
def port():
    return core.import_port("full")


def _run(cell, port, trace=False):
    return core.run_cell(tiny_cell(cell), SEED, 0.2, trace, "cpu", T0, port=port)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, port):
    result, checks = _run(cell, port)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    # The metrics from the device trace need the card; on the CPU the meter
    # does not run and their readers find nothing.
    names = {m["name"] for m in tiny_cell(cell).end_to_end if m["source"] == "host_clock"}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, port):
    result, checks = _run(cell, Broken(port, fault))
    assert not result["correct"], checks
    assert any(v > lim for _, v, lim in checks)


def test_a_failing_call_is_counted_and_not_correct(port):
    tr = tiny_cell(BATCH).traffic
    setup_calls = tr["pool"] * (1 + tr["warmup_calls"])

    class Failing:
        """Sound through the set-up's calls; every call of the window raises."""

        config = port.config
        calls = 0

        def fft_device(self, x):
            self.calls += 1
            if self.calls > setup_calls:
                raise RuntimeError("planted")
            return port.fft_device(x)

    result, _ = _run(BATCH, Failing())
    assert result["failed"] == result["attempted"] > 0
    assert not result["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_host_time(cell, port):
    result, _ = _run(cell, port, trace=True)
    assert result["correct"]
    host = {m["name"] for m in tiny_cell(cell).per_layer if m["source"] == "host_clock"}
    assert host and host <= set(result["metrics"])
    assert "breakdown" in result


def test_calls_dispatched_ahead_are_judged(port):
    """A traffic mix that keeps calls in flight (``dispatch: ahead``) runs
    and is judged like a synchronous one; with a fault, it is not correct."""
    cell = tiny_cell(BATCH, dispatch="ahead", depth=4, pool=2)
    result, checks = core.run_cell(cell, SEED, 0.2, False, "cpu", T0, port=port)
    assert result["correct"] and result["attempted"] > 0, checks
    result, _ = core.run_cell(cell, SEED, 0.2, False, "cpu", T0, port=Broken(port, "altered"))
    assert not result["correct"]


def test_same_seed_same_inputs():
    import torch

    from portbench.harness import inputs

    for name in CELLS:
        c = tiny_cell(name, pool=2)
        a = inputs.make_pool(c.config, c.traffic, SEED, "cpu")
        b = inputs.make_pool(c.config, c.traffic, SEED, "cpu")
        d = inputs.make_pool(c.config, c.traffic, SEED + 1, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], d[0])
        assert a[0].shape == d[0].shape == tuple(c.traffic["shape"])


def test_no_jax_after_a_run(port):
    _run(WELCH, port)
    assert core.forbidden_modules() == []
