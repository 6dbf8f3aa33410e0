"""The split of a traced call by the program's own spans (harness/spans.py)
and its readers, on traces written by hand."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import spans
from portbench.harness.core import _load_reader

HOST_READERS = ("entry_self_ms_per_call", "dispatch_self_ms_per_call", "engine_host_ms_per_call",
                "launch_host_ms_per_call")
ALL_READERS = (*HOST_READERS, "idle_in_program_pct", "entry_device_ms_per_call.card")


def X(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if args:
        e["args"] = args
    return e


# One Welch call, 100 us: welch_device around rfft_device around fft_device,
# dispatch, a four-step engine; torch launches from the Welch body (the
# window), from the engine (a GEMM) and from the entry of fft_device, and a
# hand-written kernel's launch span inside an engine of a second call.
WELCH = [
    X("portbench.stretch", "user_annotation", 1000.0, 400.0),
    X("portbench.call", "user_annotation", 1000.0, 100.0),
    X("gft.entry.welch", "cpu_op", 1005.0, 90.0),
    X("aten::mul", "cpu_op", 1010.0, 8.0),
    X("cudaLaunchKernel", "cuda_runtime", 1012.0, 4.0, correlation=1),
    X("gft.entry.rfft", "cpu_op", 1020.0, 60.0),
    X("gft.entry.fft", "cpu_op", 1022.0, 56.0),
    X("cudaLaunchKernel", "cuda_runtime", 1024.0, 2.0, correlation=2),
    X("gft.dispatch", "cpu_op", 1030.0, 40.0),
    X("gft.engine.fourstep", "cpu_op", 1040.0, 25.0),
    X("cudaLaunchKernel", "cuda_runtime", 1050.0, 5.0, correlation=3),
    X("cudaLaunchKernel", "cuda_runtime", 1085.0, 3.0, correlation=4),  # the mean, in welch again
    X("portbench.wait", "user_annotation", 1100.0, 60.0),
    X("portbench.call", "user_annotation", 1200.0, 50.0),
    X("gft.entry.fft", "cpu_op", 1200.0, 50.0),
    X("gft.dispatch", "cpu_op", 1210.0, 30.0),
    X("gft.engine.whole", "cpu_op", 1215.0, 20.0),
    X("gft.launch.whole_transform", "cpu_op", 1225.0, 6.0),
    X("cuLaunchKernelEx", "cuda_driver", 1226.0, 4.0, correlation=5),
    X("window", "kernel", 1020.0, 10.0, tid=7, correlation=1),
    X("copy", "gpu_memcpy", 1030.0, 4.0, tid=7, correlation=2),
    X("gemm", "kernel", 1060.0, 20.0, tid=7, correlation=3),
    X("mean", "kernel", 1090.0, 6.0, tid=7, correlation=4),
    X("k1", "kernel", 1232.0, 5.0, tid=7, correlation=5),
    X("gpu span", "gpu_user_annotation", 1000.0, 300.0, tid=7),  # not an operation
    X("gft.entry.fft", "cpu_op", 900.0, 20.0),  # before the stretch: left out
]


def test_partition_adds_up_to_the_calls_time():
    s = spans.split(WELCH)
    host = s["host_us"]
    assert s["calls"] == 2
    assert s["call_us"] == pytest.approx(150.0)
    assert sum(host.values()) == pytest.approx(s["call_us"])


def test_innermost_span_takes_the_instant_with_nested_entries():
    host = spans.split(WELCH)["host_us"]
    # call 1: welch 1005-1020 and 1080-1095 (30) less its runtime 4 + 3;
    # rfft 1020-1022 and 1078-1080 (4); fft 1022-1030 and 1070-1078 (16) less
    # its runtime 2; call 2: fft 1200-1210 and 1240-1250 (20).
    assert host["entry"] == pytest.approx(23.0 + 4.0 + 14.0 + 20.0)
    # call 1: 1030-1040 and 1065-1070; call 2: 1210-1215 and 1235-1240.
    assert host["dispatch"] == pytest.approx(15.0 + 10.0)
    # call 1: 25 less the GEMM's launch 5; call 2: 20 less the launch span 6.
    assert host["engine"] == pytest.approx(20.0 + 14.0)
    # outside every gft. span: 1000-1005 and 1095-1100.
    assert host["outside"] == pytest.approx(10.0)


def test_runtime_calls_inside_program_spans_count_as_launch_time():
    host = spans.split(WELCH)["host_us"]
    # three runtime launches (4 + 2 + 5), the mean's (3), the launch span (6),
    # whose driver call lies inside it.
    assert host["launch"] == pytest.approx(4.0 + 2.0 + 5.0 + 3.0 + 6.0)
    outside = [*WELCH, X("cudaEventRecord", "cuda_runtime", 1001.0, 2.0)]
    s = spans.split(outside)
    assert s["host_us"]["launch"] == pytest.approx(host["launch"])
    assert s["host_us"]["outside"] == pytest.approx(host["outside"])


def test_device_time_belongs_to_the_layer_that_launched_it():
    dev = spans.split(WELCH)["device_us"]
    # the window (10) and the mean (6) from welch, the copy (4) from fft_device
    assert dev["entry"] == pytest.approx(20.0)
    assert dev["engine"] == pytest.approx(20.0)
    assert dev["launch"] == pytest.approx(5.0)  # K1, launched inside its launch span
    assert dev["dispatch"] == 0.0


def test_idle_time_with_the_program_open():
    s = spans.split(WELCH)
    # busy: 1020-1034, 1060-1080, 1090-1096, 1232-1237 = 45 of 400
    assert s["idle_us"] == pytest.approx(355.0)
    # program spans: 1005-1095, 1200-1250 = 140, less busy inside them
    # (14 + 20 + 5 of the mean's 6, and 5)
    assert s["idle_in_program_us"] == pytest.approx(96.0)


def test_readers():
    ctx = SimpleNamespace(events=WELCH, chips=1)
    got = {name: _load_reader(name).read(ctx) for name in ALL_READERS}
    assert got["entry_self_ms_per_call"] == pytest.approx(61e-3 / 2)
    assert got["dispatch_self_ms_per_call"] == pytest.approx(25e-3 / 2)
    assert got["engine_host_ms_per_call"] == pytest.approx(34e-3 / 2)
    assert got["launch_host_ms_per_call"] == pytest.approx(20e-3 / 2)
    assert got["idle_in_program_pct"] == pytest.approx(100.0 * 96.0 / 355.0)
    assert got["entry_device_ms_per_call.card"] == pytest.approx(20e-3 / 2)
    # the four host metrics and the remainder make up the calls' time
    outside = spans.split(WELCH)["host_us"]["outside"] * 1e-3 / 2
    assert sum(got[n] for n in HOST_READERS) + outside == pytest.approx(150e-3 / 2)


@pytest.mark.parametrize("events", [
    [X("portbench.stretch", "user_annotation", 0.0, 10.0),
     X("portbench.call", "user_annotation", 0.0, 5.0),
     X("cudaLaunchKernel", "cuda_runtime", 1.0, 1.0, correlation=1),
     X("k", "kernel", 2.0, 1.0, tid=7, correlation=1)],
    [X("gft.entry.fft", "cpu_op", 0.0, 5.0)],  # no stretch
    [],
], ids=["no program span", "no stretch", "empty"])
def test_nothing_to_read_without_program_spans(events):
    assert spans.split(events) is None
    ctx = SimpleNamespace(events=events, chips=1)
    for name in ALL_READERS:
        assert _load_reader(name).read(ctx) is None


def test_untraced_context_reads_nothing():
    ctx = SimpleNamespace(events=None, chips=1)
    for name in ALL_READERS:
        assert _load_reader(name).read(ctx) is None


def test_span_of_another_thread_is_left_out():
    other = [*WELCH, X("gft.engine.whole", "cpu_op", 1001.0, 3.0, tid=2)]
    assert spans.split(other)["host_us"] == spans.split(WELCH)["host_us"]


def test_device_time_is_averaged_over_the_cards():
    two = [*WELCH, X("window", "kernel", 1020.0, 10.0, tid=9, correlation=1, device=1)]
    assert spans.split(two, chips=2)["device_us"]["entry"] == pytest.approx((20.0 + 10.0) / 2)


def test_layer_of():
    assert [spans.layer_of(n) for n in ("gft.entry.welch", "gft.dispatch", "gft.engine.stage_a",
                                        "gft.launch.stage_a", "portbench.call", "aten::mm")] == [
        "entry", "dispatch", "engine", "launch", None, None]
