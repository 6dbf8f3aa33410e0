"""The union of device operation intervals in the profiled stretch, over its
calls: milliseconds of device time a call costs."""


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0 or not ctx.traced_calls:
        return None
    return 1e3 * ctx.trace["busy_s"] / ctx.traced_calls
