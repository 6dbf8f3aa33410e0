"""The reduction of a profiler trace to the per-layer metrics' inputs, on a
trace written by hand."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import tracing
from portbench.harness.core import _load_reader
from portbench.work import Work


def X(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


EVENTS = [
    X("portbench.stretch", "user_annotation", 1000.0, 1000.0),
    X("portbench.call", "user_annotation", 1000.0, 100.0),
    X("aten::mm", "cpu_op", 1010.0, 80.0),
    X("portbench.wait", "user_annotation", 1500.0, 480.0),
    X("gemm", "kernel", 1100.0, 300.0, tid=7),
    X("copy", "kernel", 1300.0, 200.0, tid=8),  # overlaps the gemm
    X("memset", "gpu_memset", 1600.0, 100.0, tid=7),
    X("gemm", "kernel", 1900.0, 200.0, tid=7),  # runs past the stretch's end
    X("gpu span", "gpu_user_annotation", 1000.0, 1000.0, tid=7),  # not an operation
]


def test_reduce_events():
    r = tracing.reduce_events(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    # union: [1100, 1500] + [1600, 1700] + [1900, 2000] = 600 us
    assert r["busy_s"] == pytest.approx(600e-6)
    assert r["kernels"] == 3
    assert r["device_ops"][0] == ["gemm", pytest.approx(400e-6)]
    gaps = r["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([200e-6, 100e-6, 100e-6])
    assert gaps[0][0] == "portbench.wait"
    assert gaps[1][0] == "portbench.call/aten::mm"


def test_busy_time_is_averaged_over_the_cards():
    two = [*EVENTS, {**X("gemm", "kernel", 1000.0, 500.0, tid=9), "args": {"device": 1}}]
    assert tracing.reduce_events(two, chips=1)["busy_s"] == pytest.approx(1100e-6)
    # card 0: 600 us busy, card 1: 500 us
    assert tracing.reduce_events(two, chips=2)["busy_s"] == pytest.approx(550e-6)


def test_a_reader_can_reduce_the_raw_events():
    s0, s1, tid = tracing.stretch_of(EVENTS)
    assert (s0, s1, tid) == (1000.0, 2000.0, 1)
    ops = tracing.device_ops(EVENTS, s0, s1)
    assert [(a, b, name) for a, b, name, _, _ in ops] == [
        (1100.0, 1400.0, "gemm"), (1300.0, 1500.0, "copy"), (1600.0, 1700.0, "memset"),
        (1900.0, 2000.0, "gemm")]


def test_no_stretch_gives_nothing_to_read():
    events = [X("gemm", "kernel", 0.0, 1.0)]
    r = tracing.reduce_events(events)
    ctx = SimpleNamespace(trace=r, events=events, traced_calls=4, host_s=[], work=Work(1.0, 1.0, 1))
    for name in ("launches_per_call", "device_ms_per_call", "call_roofline",
                 "device_idle_pct", "host_ms_per_call"):
        assert _load_reader(name).read(ctx) is None


def test_readers():
    r = tracing.reduce_events(EVENTS)
    ctx = SimpleNamespace(trace=r, traced_calls=2, host_s=[0.001, 0.003],
                          work=Work(flop=0.0, bytes=3.35e12 * 150e-6, samples=1))
    assert _load_reader("launches_per_call").read(ctx) == 1.5
    assert _load_reader("device_ms_per_call").read(ctx) == pytest.approx(0.3)
    assert _load_reader("call_roofline").read(ctx) == pytest.approx(50.0)
    assert _load_reader("device_idle_pct").read(ctx) == pytest.approx(40.0)
    assert _load_reader("host_ms_per_call").read(ctx) == pytest.approx(2.0)


def test_end_to_end_readers():
    stats = SimpleNamespace(calls=10, failed=2)
    ctx = SimpleNamespace(stats=stats, window_s=2.0, setup_s=7.5, work=Work(0.0, 0.0, 1_000_000))
    assert _load_reader("samples_per_s").read(ctx) == pytest.approx(4.0)  # 8 calls of 1e6 in 2 s
    assert _load_reader("setup_s").read(ctx) == 7.5
    ctx.window_s = 0.0
    assert _load_reader("samples_per_s").read(ctx) is None


def test_busy_time_of_kineto_intervals():
    ops = [(0, 10, 0), (5, 20, 0), (30, 40, 0), (0, 4, 1)]
    assert tracing.busy_s(ops, 1) == 34  # card 0: 20 + 10, card 1: 4
    assert tracing.busy_s(ops, 2) == 17
    assert tracing.busy_s([], 1) == 0


class _Prof:
    def stop(self):
        pass


def _meter_chunk(monkeypatch, meter, first, calls, ops):
    monkeypatch.setattr(tracing, "kineto_device_ops", lambda prof: ops)
    meter.prof, meter.first = _Prof(), first
    meter.stop(calls)


def test_meter_counts_only_whole_chunks(monkeypatch):
    meter = tracing.WindowMeter(chips=1, per_call=2)
    _meter_chunk(monkeypatch, meter, 0, 2, [(0, 10, 0), (10, 30, 0), (50, 60, 0), (60, 70, 0)])
    assert (meter.calls, meter.busy_s) == (2, pytest.approx(50e-9))
    # the profiler lost one operation at an edge, less than a call's: the chunk counts
    _meter_chunk(monkeypatch, meter, 2, 4, [(0, 10, 0), (10, 30, 0), (50, 60, 0)])
    assert (meter.calls, meter.busy_s) == (4, pytest.approx(90e-9))
    # it lost a whole call's operations, or recorded nothing: the chunk does not count
    _meter_chunk(monkeypatch, meter, 4, 6, [(0, 10, 0), (10, 30, 0)])
    _meter_chunk(monkeypatch, meter, 6, 7, [])
    # more operations than the calls launch: it does not count either
    _meter_chunk(monkeypatch, meter, 7, 8, [(0, 1, 0)] * 3)
    assert (meter.calls, meter.busy_s) == (4, pytest.approx(90e-9))
    assert meter.dropped == [(2, 2), (1, 0), (1, 3)] and meter.chunks == 5


def test_window_meters_every_call_in_drained_chunks():
    from portbench.harness import window

    class Meter:
        def __init__(self):
            self.marks, self.n = [], 0

        def start(self, calls):
            self.marks.append(("start", calls))

        def due(self):
            self.n += 1
            return self.n % 3 == 0

        def roll(self, calls):
            self.stop(calls)
            self.start(calls)

        def stop(self, calls):
            self.marks.append(("stop", calls))

    class Caller:
        def __init__(self):
            self.synced_at = []
            self.calls = 0

        def call(self, i, stats, record):
            self.calls += 1
            stats.calls += 1

        def sync(self):
            self.synced_at.append(self.calls)

    meter, caller = Meter(), Caller()
    stats = window.run(caller, 0.05, meter=meter)
    starts = [c for k, c in meter.marks if k == "start"]
    stops = [c for k, c in meter.marks if k == "stop"]
    # chunks tile the window's calls, and each ends drained
    assert starts[0] == 0 and stops[-1] == stats.calls == caller.calls
    assert starts[1:] == stops[:-1]
    assert set(stops) <= set(caller.synced_at)


def test_card_rate_reader():
    ctx = SimpleNamespace(window_busy_s=0.5, metered_calls=10, work=Work(0.0, 0.0, 1_000_000))
    assert _load_reader("card_samples_per_s").read(ctx) == pytest.approx(20.0)
    ctx.window_busy_s = None
    assert _load_reader("card_samples_per_s").read(ctx) is None


def test_variant_readers_read_as_their_base():
    r = tracing.reduce_events(EVENTS)
    ctx = SimpleNamespace(trace=r, traced_calls=2, host_s=[], window_s=2.0,
                          stats=SimpleNamespace(calls=10, failed=2, stretch_s=1.0),
                          work=Work(flop=0.0, bytes=3.35e12 * 150e-6, samples=1_000_000))
    for base in ("launches_per_call", "device_ms_per_call", "call_roofline"):
        assert _load_reader(base + ".card").read(ctx) == _load_reader(base).read(ctx)


def test_host_paced_rate_leaves_the_traced_stretch_out():
    # 10 calls, 2 failed, 2 in the stretch: 6 calls of 1e6 samples in the 1.5 s outside it
    ctx = SimpleNamespace(window_s=2.5, traced_calls=2, work=Work(0.0, 0.0, 1_000_000),
                          stats=SimpleNamespace(calls=10, failed=2, stretch_s=1.0))
    assert _load_reader("samples_per_s.host_paced").read(ctx) == pytest.approx(4.0)
    ctx.stats.stretch_s = 2.5
    assert _load_reader("samples_per_s.host_paced").read(ctx) is None
