"""Mean host time inside the entry call, without any synchronise, over the
untraced calls of the traced run: what the Python path costs before the
card has the work (the benchmark's own timer)."""


def read(ctx):
    if not ctx.host_s:
        return None
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)
