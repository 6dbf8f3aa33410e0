"""call_roofline in the cells whose end-to-end rate is the card's,
card_samples_per_s."""

from .call_roofline import read  # noqa: F401
