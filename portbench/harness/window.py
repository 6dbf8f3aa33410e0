"""The measured window: one caller drives the program's entry op on the
pool's inputs for a fixed time, either synchronously (each call awaited) or
dispatching ahead with at most ``depth`` calls in flight (call i waits for
the completion event of call i - depth).  Nothing is built or compiled
here: set-up has warmed every shape already."""

from __future__ import annotations

import sys
import time
import traceback
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function


class Reservoir:
    """A uniform sample of ``k`` calls' outputs, drawn from the seed
    (Algorithm R): every call of the window is equally likely to be judged."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % (1 << 64), 0x5EED])
        self.kept: list[tuple[int, int, object]] = []  # (call, pool slot, outputs)

    def offer(self, call: int, slot: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((call, slot, out))
            return
        j = int(self.rng.integers(0, call + 1))
        if j < self.k:
            self.kept[j] = (call, slot, out)


@dataclass
class Stats:
    calls: int = 0
    failed: int = 0
    host_s: list = field(default_factory=list)  # host time inside each entry call
    t_open: float = 0.0
    t_close: float = 0.0
    traced_calls: int = 0
    stretch_s: float = 0.0  # wall time of the traced stretch, its reduction included
    trace: dict | None = None  # tracing.reduce_events of the traced stretch
    events: list | None = None  # the traced stretch's raw profiler events
    meter: object | None = None  # tracing.WindowMeter of an untraced window, where one ran


class Caller:
    """Issues calls of ``op`` over ``pool`` in the traffic's dispatch mode."""

    def __init__(self, op, pool, traffic, device, reservoir: Reservoir | None):
        self.op = op
        self.pool = pool
        self.mode = traffic["dispatch"]
        if self.mode not in ("sync", "ahead"):
            raise ValueError(f"dispatch must be 'sync' or 'ahead', got {self.mode!r}")
        self.depth = traffic["depth"] if self.mode == "ahead" else 1
        self.cuda = torch.device(device).type == "cuda"
        self.reservoir = reservoir
        self.inflight: deque = deque()
        self.reported = False

    def sync(self) -> None:
        if self.cuda:
            with record_function("portbench.wait"):
                torch.cuda.synchronize()
        self.inflight.clear()

    def call(self, i: int, stats: Stats, record: bool) -> None:
        """Call i of the window: wait for room, call, and keep what it gives."""
        slot = i % len(self.pool)
        if self.mode == "ahead" and self.cuda:
            while len(self.inflight) >= self.depth:
                with record_function("portbench.wait"):
                    self.inflight.popleft().synchronize()
        t0 = time.perf_counter()
        try:
            with record_function("portbench.call"):
                out = self.op(self.pool[slot])
        except Exception:  # a failed call is counted and the window goes on
            stats.failed += 1
            if not self.reported:
                self.reported = True
                traceback.print_exc(file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        if self.mode == "sync":
            self.sync()
        elif self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.inflight.append(ev)
        if record:
            stats.host_s.append(t1 - t0)
        stats.calls += 1
        if out is not None and self.reservoir is not None:
            self.reservoir.offer(i, slot, out)


def run(caller: Caller, seconds: float, stretch=None, meter=None) -> Stats:
    """Call for ``seconds``, then wait for every call in flight.  The window
    closes when the last call has completed.  ``stretch`` (trace runs), a
    pair (first call, function of the caller, the stats and that call index
    that runs a traced stretch of calls and returns the next index), runs
    once at that call.  ``meter`` (a tracing.WindowMeter, untraced runs)
    profiles the device over every call of the window, in chunks that begin
    and end with no call in flight."""
    stats = Stats(meter=meter)
    i = 0
    stats.t_open = time.perf_counter()
    t_end = stats.t_open + seconds
    if meter is not None:
        meter.start(0)
    while time.perf_counter() < t_end:
        if stretch is not None and i == stretch[0]:
            i = stretch[1](caller, stats, i)
            continue
        caller.call(i, stats, record=True)
        i += 1
        if meter is not None and meter.due():
            caller.sync()
            meter.roll(i)
    caller.sync()
    stats.t_close = time.perf_counter()
    if meter is not None:
        meter.stop(i)
    return stats
