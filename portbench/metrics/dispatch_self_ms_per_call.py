"""Host milliseconds a traced call spends in dispatch's own code: the calls'
time whose innermost open program span is ``gft.dispatch`` (the body of
``transform_any``, ``inverse_real``, ``inverse_real_half``: the engine's
choice, the plan lookup), its CUDA runtime calls left out
(harness/spans.py)."""

from ..harness.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "dispatch")
