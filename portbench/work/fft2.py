"""Work of ``fft2_device`` on (B, H, W) real fp32 images: B real 2-D
transforms of N = H * W points (benchFFT counts a 2-D transform by its
total size); the images read once and the full split-complex spectrum
written once."""

from __future__ import annotations

from . import Work
from .peaks import real_transform_flop


def count(shape, params) -> Work:
    b, h, w = shape
    return Work(flop=b * real_transform_flop(h * w), bytes=12.0 * b * h * w, samples=b * h * w)
