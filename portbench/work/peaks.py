"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full power limit of 700 W), and the roofline bound of a call.

FLOP follow benchFFT's convention (http://www.fftw.org/speed/method.html):
a real-input transform of N points counts 2.5 * N * log2(N) operations,
half the 5 * N * log2(N) of a complex one, whatever algorithm runs it.
"""

from __future__ import annotations

import math

FP32_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s


def bound_s(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of FLOP over the fp32
    peak and bytes over the memory peak."""
    return max(flop / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def real_transform_flop(n: int) -> float:
    """benchFFT's count for one real-input transform of ``n`` points."""
    return 2.5 * n * math.log2(n)
