"""Host milliseconds a traced call spends launching: the ``gft.launch.*``
spans (the C call of each hand-written kernel) and every CUDA runtime or
driver call made inside a program span (torch's launches)
(harness/spans.py)."""

from ..harness.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "launch")
