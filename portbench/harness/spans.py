"""The program's own spans in the traced stretch, reduced for the readers of
the per-layer metrics that split a call by the program's layers.

The port marks its layer boundaries with profiler ranges named ``gft.*``
(``gpu_fft_tpu_torch/utils/profiling.py:span``): ``gft.entry.<op>`` the
entry ops, ``gft.dispatch`` the dispatch, ``gft.engine.<engine>`` the
engines, ``gft.launch.<kernel>`` the C call of a hand-written kernel.  On
the stretch's host thread every instant inside a ``portbench.call`` goes to
the layer of the innermost open ``gft.`` span; a CUDA runtime or driver
call inside any ``gft.`` span, like a ``gft.launch.*`` span, counts as
launch time; an instant with no ``gft.`` span open is the remainder.  The
five parts add up to the calls' time.  A device operation belongs to the
layer whose span was innermost when its runtime call (the same
``correlation`` id) began.  A trace with no ``gft.`` span (a program
without them) gives None: nothing to read."""

from __future__ import annotations

from .tracing import DEVICE_CATS, _merge, stretch_of

LAYERS = (("gft.entry.", "entry"), ("gft.dispatch", "dispatch"), ("gft.engine.", "engine"),
          ("gft.launch.", "launch"))
SPAN_CATS = ("cpu_op", "user_annotation")  # a fast RecordFunction shows as a cpu_op
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def layer_of(name: str) -> str | None:
    for prefix, layer in LAYERS:
        if name.startswith(prefix):
            return layer
    return None


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def split(events, chips: int = 1) -> dict | None:
    """From the Chrome trace's events: ``calls`` (the stretch's
    ``portbench.call`` spans), ``call_us`` (their time), ``host_us`` (that
    time by layer: ``entry``, ``dispatch``, ``engine``, ``launch`` and
    ``outside``, which add up to ``call_us``), ``idle_us`` and
    ``idle_in_program_us`` (the stretch's time with no device operation on
    any card, and the part of it with a ``gft.`` span open on the host) and
    ``device_us`` (by layer: the union of the device operations launched
    from it, on each card, averaged over ``chips`` cards).  Microseconds;
    None where the stretch holds no ``gft.`` span."""
    stretch = stretch_of(events)
    if stretch is None:
        return None
    s0, s1, tid = stretch
    spans, calls, runtime, ops = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, s0), min(b, s1)
            if b > a:
                args = e.get("args") or {}
                ops.append((a, b, args.get("correlation"), args.get("device", 0)))
            continue
        if e.get("tid") != tid or b < s0 or a > s1:
            continue
        name = e.get("name", "")
        if cat in SPAN_CATS:
            layer = layer_of(name)
            if layer is not None:
                spans.append((a, b, layer))
            elif name == "portbench.call" and cat == "user_annotation":
                calls.append((a, b))
        elif cat in RUNTIME_CATS:
            runtime.append((a, b, (e.get("args") or {}).get("correlation")))
    if not spans:
        return None

    # One sweep over the edges: at each time, closes before opens, and of
    # spans opening together the outer (later end) first.
    CLOSE, OPEN = 0, 1
    edges = []
    for i, (a, b, _) in enumerate(spans):
        edges += [(a, OPEN, -b, 0, i), (b, CLOSE, 0, 0, i)]
    for a, b in calls:
        edges += [(a, OPEN, -b, 1, 0), (b, CLOSE, 0, 1, 0)]
    for i, (a, b, _) in enumerate(runtime):
        edges += [(a, OPEN, -b, 2, i), (b, CLOSE, 0, 2, i)]
    edges.sort()
    host = dict.fromkeys(("entry", "dispatch", "engine", "launch", "outside"), 0.0)
    stack: list[int] = []
    in_call = in_runtime = 0
    launched_from: dict = {}
    t_prev = edges[0][0]
    for t, edge, _, kind, i in edges:
        if t > t_prev and in_call:
            if not stack:
                part = "outside"
            elif in_runtime:
                part = "launch"
            else:
                part = spans[stack[-1]][2]
            host[part] += t - t_prev
        t_prev = t
        if kind == 0:
            if edge == OPEN:
                stack.append(i)
            elif stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        elif kind == 1:
            in_call += 1 if edge == OPEN else -1
        else:
            in_runtime += 1 if edge == OPEN else -1
            if edge == OPEN and stack:
                launched_from[runtime[i][2]] = spans[stack[-1]][2]

    busy = _merge([(a, b) for a, b, _, _ in ops])
    edges_t = [s0] + [x for ab in busy for x in ab] + [s1]
    idle = [(edges_t[k], edges_t[k + 1]) for k in range(0, len(edges_t), 2)
            if edges_t[k + 1] > edges_t[k]]
    program = _merge([(max(a, s0), min(b, s1)) for a, b, _ in spans if min(b, s1) > max(a, s0)])

    device = {}
    for layer in ("entry", "dispatch", "engine", "launch"):
        mine = [(a, b, card) for a, b, corr, card in ops
                if corr is not None and launched_from.get(corr) == layer]
        cards = {card for *_, card in mine}
        device[layer] = sum(_length(_merge([(a, b) for a, b, c in mine if c == card]))
                            for card in cards) / max(chips, 1)
    return {
        "calls": len(calls),
        "call_us": _length(calls),
        "host_us": host,
        "idle_us": _length(idle),
        "idle_in_program_us": _overlap(idle, program),
        "device_us": device,
    }


def split_of(ctx) -> dict | None:
    """:func:`split` of a reader's context (``ctx.events``, ``ctx.chips``)."""
    events = getattr(ctx, "events", None)
    return split(events, getattr(ctx, "chips", 1)) if events else None


def host_ms_per_call(ctx, layer: str) -> float | None:
    """Host milliseconds a traced call spends in ``layer``."""
    s = split_of(ctx)
    if s is None or not s["calls"]:
        return None
    return 1e-3 * s["host_us"][layer] / s["calls"]


def device_ms_per_call(ctx, layer: str) -> float | None:
    """Device milliseconds a traced call launches from ``layer``."""
    s = split_of(ctx)
    if s is None or not s["calls"]:
        return None
    return 1e-3 * s["device_us"][layer] / s["calls"]
