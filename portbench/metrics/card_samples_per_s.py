"""Input samples of the window's calls over the device time they took, in
millions a second: the union of every kernel, copy and set interval of the
calls, from the profiler over the whole window (harness/tracing.py
``WindowMeter``).  The card time a caller pays for the work, which the
host's speed does not enter."""


def read(ctx):
    if not ctx.window_busy_s or not ctx.metered_calls:
        return None
    return ctx.metered_calls * ctx.work.samples / ctx.window_busy_s / 1e6
