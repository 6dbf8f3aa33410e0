"""The share of the profiled stretch, in %, in which no operation ran on the
device."""


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0 or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
