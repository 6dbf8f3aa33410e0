"""The matched-filter cell's own files on the CPU: the reference against
PyCBC's ``matched_filter_core`` written in numpy float64, the frozen work
counts at the cell's size, and a whole run of the cell at a tiny size
(``dataclasses.replace``: N = 2^12, short pads), and the faults that the
cell's limits catch."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest

from portbench.data import gw_segment
from portbench.harness import core, inputs, spec
from portbench.ops import matched_filter as op_mod
from portbench.reference import matched_filter as reference
from portbench.tools.faults import altered
from portbench.tools.readings_matched_filter import half_batch
from portbench.work import matched_filter as work
from portbench.work.peaks import bound_s

CELL = "pycbc.matched_filter_t64_n2e20"
SEED = 2**32 + 4242
PADS = {"segment_start_pad_s": 0.25, "segment_end_pad_s": 0.125}
T0 = time.perf_counter()


def tiny_cell(t=3, n=1 << 12):
    c = spec.load_cell(CELL)
    shape = [t + 2, 2, n // 2 + 1]
    tr = dict(c.traffic, shape=shape, warmup_calls=2, params=dict(c.traffic["params"], **PADS))
    cfg = dict(c.config, shapes=[shape], data=dict(c.config["data"], **PADS))
    return dataclasses.replace(c, traffic=tr, config=cfg)


def matched_filter_core(x, params):
    """numpy float64: PyCBC's matched_filter_core and sigmasq, then snr * norm,
    over the valid window."""
    x = x.numpy().astype(np.float64)
    lay = work.layout(x.shape, params)
    n, kmin, df = lay["n"], lay["kmin"], lay["delta_f"]
    kmax = n // 2  # no upper cutoff
    stilde = x[0, 0] + 1j * x[0, 1]
    psd = x[1, 0]
    out = []
    for h in x[2:]:
        htilde = h[0] + 1j * h[1]
        qtilde = np.zeros(n, dtype=np.complex128)
        qtilde[kmin:kmax] = np.conj(htilde[kmin:kmax]) * stilde[kmin:kmax] / psd[kmin:kmax]
        q = np.fft.ifft(qtilde) * n  # PyCBC's inverse is unnormalised
        sigmasq = 4.0 * df * np.sum(np.abs(htilde[kmin:kmax]) ** 2 / psd[kmin:kmax])
        out.append(q[lay["start"]:lay["stop"]] * 4.0 * df / np.sqrt(sigmasq))
    return np.stack(out)


def test_reference_is_matched_filter_core():
    c = tiny_cell()
    x = inputs.make_pool(c.config, c.traffic, SEED, "cpu")[0]
    want = matched_filter_core(x, c.traffic["params"])
    gr, gi = reference.reference(x, c.traffic["params"], "float64")
    got = gr.numpy() + 1j * gi.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    low = reference.judge(reference.reference(x, c.traffic["params"], "float32"), (gr, gi))
    assert 1e-9 < low["rel_l2"] < 1e-5


class Altered:
    """The program with one answer of ``matched_filter_device`` altered
    (tools/faults.py:altered); every other attribute is the program's own."""

    def __init__(self, port):
        self._port = port

    def __getattr__(self, name):
        return getattr(self._port, name)

    def matched_filter_device(self, *args, **kwargs):
        snr, peak, at = self._port.matched_filter_device(*args, **kwargs)
        return altered(snr), peak, at


def test_work_at_the_cells_size():
    c = spec.load_cell(CELL)
    shape, params = tuple(c.traffic["shape"]), c.traffic["params"]
    lay = work.layout(shape, params)
    assert (lay["n"], lay["delta_f"], lay["kmin"]) == (1 << 20, 1 / 512, 10_240)
    assert (lay["start"], lay["stop"]) == (294_912, 1_015_808)  # [144 s, 496 s)
    w = work.count(shape, params)
    assert w.samples == 64 * (1 << 20)
    assert w.flop == 64 * 5 * (1 << 20) * 20 == 6_710_886_400
    assert w.bytes == 66 * 524_289 * 8 + 64 * 720_896 * 8 == 645_923_344
    assert bound_s(w.flop, w.bytes) == pytest.approx(645_923_344 / 3.35e12)  # 0.193 ms
    tw = work.transform_count(shape, params)
    assert tw.flop == w.flop and tw.bytes == 16 * 64 * (1 << 20) == 1_073_741_824
    assert bound_s(tw.flop, tw.bytes) == pytest.approx(1_073_741_824 / 3.35e12)  # 0.321 ms


def test_tiny_run_is_correct_and_a_fault_is_not():
    port = core.import_port("full")
    result, checks = core.run_cell(tiny_cell(), SEED, 0.2, False, "cpu", T0, port=port)
    assert result["correct"] and result["attempted"] > 0, checks
    result, checks = core.run_cell(tiny_cell(), SEED, 0.2, False, "cpu", T0, port=Altered(port))
    assert not result["correct"], checks


@pytest.mark.parametrize("t", [3, 4])
def test_half_batch_reading_fails_the_cells_limits(t):
    """The half-batch fault that tools/readings_matched_filter.py reads:
    the second half of the templates' SNR is the first half's, far outside
    both limits of the cell."""
    c = tiny_cell(t=t)
    port = core.import_port("full")
    params = c.traffic["params"]
    x = inputs.make_pool(c.config, c.traffic, SEED, "cpu")[0]
    want = reference.reference(x, params, "float64")
    got = half_batch("matched_filter", lambda y: op_mod.call(port, y, params), x)
    assert got[0].shape == want[0].shape
    read = reference.judge(got, want)
    limits = json.loads((Path(spec.__file__).parents[1] / "limits" / f"{CELL}.json").read_text())
    for name in ("rel_err", "rel_l2"):
        assert read[name] > 100 * limits[name]["limit"], read


def test_traced_tiny_run_reads_the_new_metrics():
    port = core.import_port("full")
    result, _ = core.run_cell(tiny_cell(t=2, n=1 << 17), SEED, 0.2, True, "cpu", T0, port=port)
    assert result["correct"]
    # On the CPU the profiler sees no device operation: the spans' device
    # times read 0, and the transform's roofline, over them, is left out.
    for name in ("kernel_device_ms_per_call.card", "engine_device_ms_per_call.card"):
        assert result["metrics"][name]["value"] == 0.0
    assert "transform_roofline.card" not in result["metrics"]


def test_injection_is_inside_the_valid_window():
    c = spec.load_cell(CELL)
    lay = work.layout(c.traffic["shape"], c.traffic["params"])
    for seed in (0, 1, 2**31 + 5, 2**33 - 1):
        at = gw_segment.injection(c.traffic["shape"], c.config["data"], seed)
        assert lay["start"] <= at < lay["stop"]
