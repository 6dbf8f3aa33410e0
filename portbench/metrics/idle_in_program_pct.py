"""Of the traced stretch's time with no device operation running, the share,
in %, in which the host thread had a program span (``gft.*``) open: the
card waiting on the program's own host path rather than on the caller
(harness/spans.py)."""

from ..harness.spans import split_of


def read(ctx):
    s = split_of(ctx)
    if s is None or s["idle_us"] <= 0:
        return None
    return 100.0 * s["idle_in_program_us"] / s["idle_us"]
