"""Host-side helpers."""

from .signal import (
    calculate_frequencies,
    calculate_one_sided_frequencies,
    fftfreq,
    find_dominant_frequencies,
    generate_sine_wave,
    rfftfreq,
)

__all__ = [
    "calculate_frequencies",
    "calculate_one_sided_frequencies",
    "fftfreq",
    "find_dominant_frequencies",
    "generate_sine_wave",
    "rfftfreq",
]
