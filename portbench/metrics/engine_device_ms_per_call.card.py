"""Device milliseconds a traced call runs in the engines' torch operations,
in the cells whose end-to-end rate is the card's: the union of the device
operations whose runtime call was made while the innermost open program
span was ``gft.engine.*`` (matched by ``correlation`` id), over the calls.
At the matched filter: stage B's two complex contractions and its twiddle
(harness/spans.py)."""

from ..harness.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "engine")
