"""launches_per_call in the cells whose end-to-end rate is the card's,
card_samples_per_s."""

from .launches_per_call import read  # noqa: F401
