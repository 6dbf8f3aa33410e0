"""DFT-matrix and twiddle-table generation (host-side, float64).

The reference computes twiddles *inside* each GPU kernel with per-thread
``cos``/``sin`` calls (reference ``src/butterfly.rs:45-48``).  On TPU,
transcendentals burn VPU cycles and per-element trig wastes the MXU, so we do
the opposite: every transform is expressed against precomputed DFT matrices
and twiddle tables, generated once on the host in float64 (angles reduced
mod n before the complex exponential for maximum accuracy), rounded to
float32, and cached on device in split-complex (real, imag) layout — the same
split layout the reference uses for its buffers (``src/lib.rs:99-105``).

This realizes the reference's abandoned precomputed-twiddle WIP branch
(``src/twiddles.rs:7-20``) the TPU-native way: tables resident in VMEM feeding
MXU matmuls instead of an O(N^2) thread grid.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dft_matrix", "dft_matrix_ext", "twiddle_table", "unit_roots"]


def unit_roots(count: int, n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """W_n^k = exp(sign * 2πi * k / n) for k = 0..count-1, split-complex f32.

    The per-bin twiddle vector of the real-input packing recombination
    (kernels/large.py:_real_packed_fft) and similar epilogues.
    """
    return _split_exp(np.arange(count, dtype=np.int64), n, sign)


def _split_exp(num: np.ndarray, denom: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """exp(sign * 2πi * num / denom) as (real32, imag32), angles reduced mod denom."""
    reduced = np.mod(num, denom).astype(np.float64)
    ang = (2.0 * np.pi / denom) * reduced
    if sign < 0:
        return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft_matrix(n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """Split-complex DFT matrix F[j, k] = exp(sign * 2πi * j * k / n), (n, n) f32.

    ``sign=-1`` gives the forward kernel, ``sign=+1`` the inverse kernel
    (without the 1/N normalization, which is applied by the caller — matching
    the reference's separate scaling pass, ``src/ifft.rs:140-146``).
    """
    k = np.arange(n, dtype=np.int64)
    return _split_exp(np.outer(k, k), n, sign)


def dft_matrix_ext(n: int, sign: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(fr, fi, fr+fi, fi-fr), the sum/difference computed in f64.

    The extra two matrices feed the Gauss/Karatsuba 3-multiplication complex
    matmul (see kernels/fused.py): precomputing cos+sin and sin-cos in f64
    costs no accuracy, unlike deriving them from the rounded f32 tables.
    """
    k = np.arange(n, dtype=np.int64)
    reduced = np.mod(np.outer(k, k), n).astype(np.float64)
    ang = (2.0 * np.pi / n) * reduced
    c = np.cos(ang)
    s = np.sin(ang) if sign > 0 else -np.sin(ang)
    return (
        c.astype(np.float32),
        s.astype(np.float32),
        (c + s).astype(np.float32),
        (s - c).astype(np.float32),
    )


def twiddle_table(rows: int, cols: int, n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """Split-complex twiddle T[a, b] = exp(sign * 2πi * a * b / n), (rows, cols) f32.

    Used between the two DFT passes of the four-step factorization n = n1*n2.
    """
    a = np.arange(rows, dtype=np.int64)
    b = np.arange(cols, dtype=np.int64)
    return _split_exp(np.outer(a, b), n, sign)
