"""Host milliseconds a traced call spends in the engines: the calls' time
whose innermost open program span is ``gft.engine.*`` (the torch ops of
the four-steps, a kernel wrapper's checks and outputs, the custom
operator's dispatch), its CUDA runtime calls left out (harness/spans.py)."""

from ..harness.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "engine")
