"""A call's share of its roofline, in %: the least time the card could take
for the call's work (work/peaks.py:bound_s over work/<kind>.py's count)
over the device time a call took in the profiled stretch."""

from ..work.peaks import bound_s


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0 or not ctx.traced_calls:
        return None
    per_call = ctx.trace["busy_s"] / ctx.traced_calls
    return 100.0 * bound_s(ctx.work.flop, ctx.work.bytes) / per_call
