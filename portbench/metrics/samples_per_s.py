"""Input samples of every call that completed in the window, over the
window's length (first call issued to last call completed), in millions a
second: the reference suite's Criterion ``Throughput::Elements``."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return (ctx.stats.calls - ctx.stats.failed) * ctx.work.samples / ctx.window_s / 1e6
