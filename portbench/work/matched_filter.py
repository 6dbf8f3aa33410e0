"""Work of ``matched_filter_device`` on an input of shape (T + 2, 2, h):
one data segment and T templates, h = N/2 + 1 one-sided bins.

- ``count``, the call: samples = T·N, the SNR samples a call computes (the
  search's unit, templates × data); FLOP = T·5·N·log₂N, benchFFT's count of
  the T complex inverses of N points; bytes = the input read once, (T + 2)·h
  split-complex fp32 values, and ρ's valid window of L samples of each
  template written once, T·L split-complex fp32 values.
- ``transform_count``, the batched inverse inside it: the same FLOP, and
  (T, N) split-complex fp32 read once and written once, 16·T·N bytes.

:func:`layout` derives the filter's bins and window from the shape and the
traffic's parameters, for the op, its reference and these counts alike.
"""

from __future__ import annotations

import math

from . import Work


def layout(shape, params) -> dict:
    """N, Δf, the first correlated bin kmin = int(f_low / Δf), as PyCBC's
    ``get_cutoff_indices`` (the bins [kmin, N/2) are correlated: no upper
    cutoff) and the valid window [start, stop) of samples between the
    segment's pads."""
    n = 2 * (shape[-1] - 1)
    fs = float(params["sample_rate"])
    df = fs / n
    return {"n": n, "delta_f": df, "kmin": int(params["f_low"] / df),
            "start": int(round(params["segment_start_pad_s"] * fs)),
            "stop": n - int(round(params["segment_end_pad_s"] * fs))}


def count(shape, params) -> Work:
    t, h = shape[0] - 2, shape[-1]
    lay = layout(shape, params)
    n = lay["n"]
    kept = lay["stop"] - lay["start"]
    return Work(flop=t * 5.0 * n * math.log2(n), bytes=8.0 * (t + 2) * h + 8.0 * t * kept,
                samples=t * n)


def transform_count(shape, params) -> Work:
    t = shape[0] - 2
    n = layout(shape, params)["n"]
    return Work(flop=t * 5.0 * n * math.log2(n), bytes=16.0 * t * n, samples=t * n)
