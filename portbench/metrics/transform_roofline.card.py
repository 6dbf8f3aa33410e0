"""The batched transform's share of its roofline, in %, in the cells whose op
runs one (a ``transform_count`` in work/<kind>.py): the least time the card
could take for the transform's work (work/peaks.py:bound_s) over the device
time a traced call runs below the entry ops (harness/spans.py): every device
operation launched from ``gft.dispatch``, ``gft.engine.*`` or
``gft.launch.*``.  Those are the passes that count as the transform, in
whichever of the three layers they run; the entry ops' own work around it
is left out.  At the matched filter: the staged inverse's K3 (launch), stage
B (engine) and its 1/N scale (dispatch)."""

import importlib

from ..harness.spans import device_ms_per_call
from ..work.peaks import bound_s

LAYERS = ("dispatch", "engine", "launch")


def read(ctx):
    work = importlib.import_module(f"portbench.work.{ctx.cell.traffic['op']}")
    if not hasattr(work, "transform_count"):
        return None
    parts = [device_ms_per_call(ctx, layer) for layer in LAYERS]
    if None in parts or sum(parts) <= 0:
        return None
    w = work.transform_count(tuple(ctx.cell.traffic["shape"]), ctx.cell.traffic["params"])
    return 100.0 * bound_s(w.flop, w.bytes) / (1e-3 * sum(parts))
