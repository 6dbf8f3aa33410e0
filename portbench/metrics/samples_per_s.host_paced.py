"""samples_per_s in the cells where the host's speed sets it and spreads it
too widely to be held end to end, read in the traced run: input samples of
the calls completed in the window outside the traced stretch, over the
window's time outside it (the stretch runs under the profiler and holds its
reduction), in millions a second."""


def read(ctx):
    calls = ctx.stats.calls - ctx.stats.failed - ctx.traced_calls
    seconds = ctx.window_s - ctx.stats.stretch_s
    if calls <= 0 or seconds <= 0:
        return None
    return calls * ctx.work.samples / seconds / 1e6
