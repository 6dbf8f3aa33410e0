"""Seconds from the process's start to the window's first call: imports,
the CUDA context, the inputs, the kernels' build or load, the warm-up."""


def read(ctx):
    return ctx.setup_s
