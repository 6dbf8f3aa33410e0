"""Work of ``welch_device`` on (C, L) real fp32 rows: one real transform of
``nperseg`` points per segment (benchFFT's count; framing, detrend, window,
power and averaging count no FLOP), the recording read once and the
one-sided PSD of each channel written once, 4 bytes a value."""

from __future__ import annotations

from . import Work
from .peaks import real_transform_flop


def segments(length: int, params) -> int:
    nperseg = params["nperseg"]
    return (length - nperseg) // (nperseg - params["noverlap"]) + 1


def count(shape, params) -> Work:
    c, length = shape
    nperseg = params["nperseg"]
    flop = c * segments(length, params) * real_transform_flop(nperseg)
    nbytes = 4.0 * c * length + 4.0 * c * (nperseg // 2 + 1)
    return Work(flop=flop, bytes=nbytes, samples=c * length)
