"""Host milliseconds a traced call spends in the entry ops' own code: the
calls' time whose innermost open program span is ``gft.entry.*`` (the
body of ``fft_device``, ``welch_device`` ...), its CUDA runtime calls left
out (harness/spans.py)."""

from ..harness.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "entry")
