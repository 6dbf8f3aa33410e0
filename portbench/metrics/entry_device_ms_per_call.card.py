"""Device milliseconds a traced call runs for the entry ops' own work, in the
cells whose end-to-end rate is the card's: the union of the device
operations whose runtime call was made while the innermost open program
span was ``gft.entry.*`` (matched by ``correlation`` id), over the calls.
At Welch: the framing, detrend, window, power and mean (harness/spans.py)."""

from ..harness.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "entry")
