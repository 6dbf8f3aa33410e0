"""Frozen counts of the work a call asks for, one module per op kind.

Each module reads only the cell's shape and parameters, never the program's
plan, so the count stays the same whatever implements the call.  Every
module gives ``count(shape, params) -> Work``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Work:
    flop: float  # benchFFT's count of the transforms (see peaks.py)
    bytes: float  # each input byte read once, each output byte written once
    samples: int  # input samples a call consumes (the throughput's unit)
