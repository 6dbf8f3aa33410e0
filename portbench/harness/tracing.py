"""One torch.profiler window (CPU and CUDA activity) over a steady stretch
of calls, and its reduction to what the per-layer metrics read; and the
device meter, the profiler over every call of an untraced window, for the
end-to-end metrics whose source is the device trace.

The stretch starts and ends drained (no call in flight), so every kernel in
it belongs to one of its calls.  The benchmark's own spans mark each entry
call (``portbench.call``), each wait (``portbench.wait``) and the stretch
(``portbench.stretch``)."""

from __future__ import annotations

import json
import os
import tempfile
import time

from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CHUNK_S = 2.0  # length of one chunk of WindowMeter's profile
TOP = 10


def profile_calls(caller, stats, first: int, count: int, chips: int = 1) -> int:
    """Run calls ``first`` .. ``first + count - 1`` under the profiler; fill
    ``stats.events`` (the trace's raw events), ``stats.trace`` (their
    reduction over ``chips`` cards), ``stats.traced_calls`` and
    ``stats.stretch_s`` (the stretch's wall time, its reduction included);
    return the next call index."""
    caller.sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.stretch"):
            for i in range(first, first + count):
                caller.call(i, stats, record=False)
            caller.sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    stats.events = events
    stats.trace = reduce_events(events, chips)
    stats.traced_calls = count
    stats.stretch_s = time.perf_counter() - t0
    return first + count


def kineto_device_ops(prof):
    """The device operations (kernels, copies, sets) of a stopped profile,
    read from the profiler's own results without building its Python event
    tree: ``(start, end, card)``, nanoseconds.  Device-side spans of
    ``record_function`` are not operations and are left out."""
    from torch._C import _autograd

    cuda = _autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns(), e.device_index())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
            and not e.name().startswith("portbench.")]


def busy_s(ops, chips: int) -> float:
    """The union of ``(start, end, card)`` intervals on each card (seconds
    where they are in seconds), averaged over ``chips`` cards."""
    cards = {card for *_, card in ops}
    return sum(sum(b - a for a, b in _merge([(a, b) for a, b, c in ops if c == card]))
               for card in cards) / max(chips, 1)


class WindowMeter:
    """The device's busy time over every call of an untraced window, for the
    end-to-end metrics whose source is the device trace.

    The profiler (CUDA activity only) runs in chunks of about ``CHUNK_S``
    seconds, each begun and ended with no call in flight, so that every
    device operation of the window lies in exactly one chunk; a chunk is read
    from the profiler's results and dropped, which keeps its buffers small.
    A chunk counts only where it holds ``per_call`` device operations for
    each of its calls (the count of a profiled warm-up), less fewer than one
    call's: the profiler now and then records nothing, or loses many
    operations, and a chunk that lost them would read the device as idle; it
    does lose one to three operations at a chunk's edges, which leaves the
    chunk's busy time short by less than one call's device time, under 0.05%
    at the thousands of calls a chunk holds.  ``busy_s`` and ``calls`` are over
    the chunks that count."""

    def __init__(self, chips: int, per_call: int):
        self.chips, self.per_call = chips, per_call
        self.busy_s = 0.0
        self.calls = 0
        self.chunks = 0
        self.dropped = []  # (calls, operations) of each chunk that did not count
        self.prof = None
        self.first = 0
        self.t_roll = 0.0

    def start(self, calls: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.first = calls
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_roll = time.perf_counter() + CHUNK_S

    def due(self) -> bool:
        return time.perf_counter() >= self.t_roll

    def stop(self, calls: int) -> None:
        """End the chunk (no call in flight) after ``calls`` calls in all."""
        self.prof.stop()
        ops = kineto_device_ops(self.prof)
        self.prof = None
        n = calls - self.first
        self.chunks += 1
        if n > 0 and n * self.per_call - self.per_call < len(ops) <= n * self.per_call:
            self.busy_s += busy_s(ops, self.chips) * 1e-9
            self.calls += n
        elif n > 0:
            self.dropped.append((n, len(ops)))

    def roll(self, calls: int) -> None:
        self.stop(calls)
        self.start(calls)


def ops_per_call(call, count: int) -> int:
    """Device operations of one call, from a CUDA-activity profile of
    ``count`` calls (``call()`` returns with none in flight); 0 where the
    counts do not divide or the profiler recorded nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            call()
    n = len(kineto_device_ops(prof))
    return n // count if n % count == 0 else 0


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_name(spans, t):
    """'<benchmark span>/<innermost host op>' open at host time ``t``."""
    ours, inner = "between calls", None
    for name, cat, a, b in spans:
        if a <= t <= b:
            if cat == "user_annotation" and name.startswith("portbench.") and name != "portbench.stretch":
                ours = name
            elif cat == "cpu_op" and (inner is None or a >= inner[1]):
                inner = (name, a)
    return ours if inner is None else f"{ours}/{inner[0]}"


def stretch_of(events):
    """The traced stretch's span, ``(start, end, host thread)`` in the
    trace's microseconds, or None where the trace holds none."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "portbench.stretch" \
                and e.get("cat") == "user_annotation":
            s0 = float(e["ts"])
            return s0, s0 + float(e["dur"]), e.get("tid")
    return None


def device_ops(events, s0: float, s1: float):
    """Every device operation (kernel, copy, set) clipped to [s0, s1]:
    ``(start, end, name, category, card)``, microseconds."""
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), s0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), s1)
        if b > a:
            ops.append((a, b, e["name"], e["cat"], (e.get("args") or {}).get("device", 0)))
    return ops


def reduce_events(events, chips: int = 1) -> dict:
    """From the Chrome trace's events: the stretch's length, the device's busy
    time (the union of kernel, copy and set intervals inside it, on each
    card, averaged over ``chips`` cards), the kernel launches, the device
    operations by total time and the longest idle gaps (of all cards
    together) named by what the host had open.  Times in seconds."""
    span = stretch_of(events)
    if span is None:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0, "device_ops": [], "idle_gaps": []}
    s0, s1, tid = span
    ops = device_ops(events, s0, s1)
    kernels = sum(cat == "kernel" for _, _, _, cat, _ in ops)
    by_name: dict[str, float] = {}
    for a, b, name, _, _ in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    cards = {card for *_, card in ops}
    busy = sum(sum(b - a for a, b in _merge([(a, b) for a, b, *_, c in ops if c == card]))
               for card in cards) / max(chips, 1)
    merged = _merge([(a, b) for a, b, *_ in ops])
    edges = [s0] + [x for ab in merged for x in ab] + [s1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    spans = [(e["name"], e["cat"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X" and e.get("tid") == tid
             and e.get("cat") in ("user_annotation", "cpu_op")]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (s1 - s0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": kernels,
        "device_ops": [[name[:160], us * 1e-6] for name, us in ranked],
        "idle_gaps": [[_host_name(spans, (a + b) / 2.0)[:160], (b - a) * 1e-6] for a, b in gaps],
    }
