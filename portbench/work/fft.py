"""Work of ``fft_device`` on (B, n) real fp32 rows: B real transforms of n
points; the input read once (4 bytes a sample) and the full split-complex
spectrum written once (8 bytes a bin)."""

from __future__ import annotations

from . import Work
from .peaks import real_transform_flop


def count(shape, params) -> Work:
    b, n = shape
    return Work(flop=b * real_transform_flop(n), bytes=12.0 * b * n, samples=b * n)
