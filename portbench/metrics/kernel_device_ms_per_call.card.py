"""Device milliseconds a traced call runs in the hand-written kernels, in the
cells whose end-to-end rate is the card's: the union of the device
operations whose runtime call was made while the innermost open program
span was ``gft.launch.*`` (matched by ``correlation`` id), over the calls.
At the matched filter: K3, the staged inverse's stage A (harness/spans.py)."""

from ..harness.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "launch")
