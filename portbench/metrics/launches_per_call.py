"""Device kernel launches in the profiled stretch, over its calls (every
kernel, the program's own and torch's)."""


def read(ctx):
    if not ctx.trace or not ctx.trace["kernels"] or not ctx.traced_calls:
        return None
    return ctx.trace["kernels"] / ctx.traced_calls
