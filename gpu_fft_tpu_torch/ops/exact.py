"""Exact arbitrary-length FFT: mixed-radix four-step or Bluestein chirp-z.

Port of ``gpu_fft_tpu/ops/exact.py``.  ``fft`` zero-pads to a power of two,
which computes the spectrum of another length; ``fft_exact`` computes the
true length-n DFT for ANY n >= 1, by one of two exact strategies chosen by
modeled FLOPs:

* **Mixed-radix four-step** (``_mixed_fft``): where n = n1 * n2 with both
  digits <= MIXED_DIGIT_MAX (the most balanced pairing), the power-of-two
  path's folded four-step (``kernels/fused_torch.py:fused_fft_folded``)
  with (n1, n1) and (n2, n2) direct DFT tables; a digit need not be smooth
  (n = 48,000 runs as 200 x 240).
* **Bluestein chirp-z** (``_bluestein``): other lengths (primes, 2 * a
  large prime, ...) as a circular convolution of power-of-two size
  m = next_pow2(2n - 1):

      X[k] = w*[k] . sum_j (x[j] w*[j]) . w[(k-j)],  w[j] = e^{i pi j^2 / n}

  realized as a = x * conj(w); X = conj(w) * IFFT_m(FFT_m(a) * B), B the
  FFT_m of the wrapped chirp (a numpy f64 table).  The two m-point
  transforms are ``transform_any``'s, on ``plan.route``'s engine.

Every table angle is reduced mod its period in exact int64 before the f64
exponential, so the tables carry half an ulp; the tables are bit-identical
to the JAX package's and cached on the device (``plan.on_device``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MAX_N
from ..plan import FusedPlan, on_device
from .transform import _as_tensor

__all__ = [
    "MIXED_DIGIT_MAX",
    "fft_exact",
    "fft_exact_device",
    "ifft_exact",
    "ifft_exact_device",
    "mixed_split",
]


def _chirp_split(n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """w[j] = exp(sign * i*pi*j^2/n) as split f32, exponent reduced mod 2n."""
    j = np.arange(n, dtype=np.int64)
    red = (j * j) % (2 * n)  # exact in int64 for n <= 2^31
    ang = (np.pi / n) * red.astype(np.float64)
    if sign < 0:
        return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bluestein_plan(n: int, sign: int) -> dict:
    """Cached numpy tables: the chirp w (length n) and the pow2-domain
    kernel spectrum B = FFT_m(wrapped conj-chirp), both f64-generated."""
    m = 1
    while m < 2 * n - 1:
        m *= 2
    wr, wi = _chirp_split(n, sign)
    # Kernel b[j] = exp(-sign * i*pi*j^2/n) wrapped circularly: b[m-j] = b[j].
    br, bi = _chirp_split(n, -sign)
    kern = np.zeros(m, dtype=np.complex128)
    bc = br.astype(np.float64) + 1j * bi.astype(np.float64)
    kern[:n] = bc
    kern[m - n + 1:] = bc[1:][::-1]
    kspec = np.fft.fft(kern)
    return {
        "m": m,
        "wr": wr, "wi": wi,
        "kr": kspec.real.astype(np.float32), "ki": kspec.imag.astype(np.float32),
    }


def _bluestein(xr, xi, n: int, sign: int):
    """Split-complex exact length-n transform of (B, n) rows (xi may be None)."""
    from ..kernels.large import transform_any

    p = on_device(_bluestein_plan, n, sign, device=xr.device)
    m = p["m"]
    wr, wi = p["wr"], p["wi"]
    # a = x * w  (w already carries the transform sign)
    if xi is None:
        ar = xr * wr
        ai = xr * wi
    else:
        ar = xr * wr - xi * wi
        ai = xr * wi + xi * wr
    ar = F.pad(ar, (0, m - n))
    ai = F.pad(ai, (0, m - n))
    # Circular convolution with the chirp kernel through the pow2 path.
    fr, fi = transform_any(ar, ai, m, -1)
    cr = fr * p["kr"] - fi * p["ki"]
    ci = fr * p["ki"] + fi * p["kr"]
    gr, gi = transform_any(cr, ci, m, +1)  # unnormalized inverse
    s = 1.0 / m  # a power of two: exact in fp32
    gr = gr[:, :n] * s
    gi = gi[:, :n] * s
    # X = w * conv result
    return gr * wr - gi * wi, gr * wi + gi * wr


# Largest direct-DFT digit of the mixed-radix path.  A digit d costs four
# (d, d) f32 tables (16*d^2 bytes) and makes the stage contraction d; 1024
# keeps the table set <= 16 MB while covering every balanced-divisor
# n <= ~1M.
MIXED_DIGIT_MAX = 1024


@functools.lru_cache(maxsize=None)
def mixed_split(n: int):
    """Most-balanced (n1, n2) with n1 * n2 = n and both <= MIXED_DIGIT_MAX,
    chosen by modeled FLOPs against the Bluestein alternative; None if the
    chirp path wins (or no pairing qualifies).

    The most balanced pairing is (d, n/d) for the largest divisor
    d <= isqrt(n); any smaller divisor has a larger cofactor, so if that
    cofactor exceeds MIXED_DIGIT_MAX no pairing qualifies.  The FLOPs gate
    compares the four-step's 6*n*(n1 + n2) complex-MAC products against the
    dispatch model of Bluestein's two m-point transforms
    (``utils/roofline.py:transform_stages``), the JAX package's rule.
    """
    if n < 4 or n & (n - 1) == 0:
        return None
    d = 0
    for c in range(int(math.isqrt(n)), 1, -1):
        if n % c == 0:
            d = c
            break
    if d < 2 or n // d > MIXED_DIGIT_MAX:
        return None
    n1, n2 = d, n // d
    mixed_flops = 3 * 2.0 * n * (n1 + n2) + 6.0 * n
    m = 1
    while m < 2 * n - 1:
        m *= 2
    from ..utils.roofline import transform_stages

    stages, elem = transform_stages(1, m, real_input=False)
    bluestein_flops = 2.0 * (sum(f for f, _ in stages) + elem) + 4 * 6.0 * n
    return (n1, n2) if mixed_flops < bluestein_flops else None


@functools.lru_cache(maxsize=None)
def _mixed_plan(n: int, sign: int) -> FusedPlan:
    """FusedPlan with mixed (non-pow2) digits: the folded four-step's math
    does not need powers of two, so the plan is the same table set — (n1,
    n1) and (n2, n2) direct DFT matrices and the (n2, n1) twiddle."""
    from ..kernels.tables import dft_matrix_ext, twiddle_table

    n1, n2 = mixed_split(n)
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    f2r, f2i, f2s, f2d = dft_matrix_ext(n2, sign)
    twr, twi = twiddle_table(n2, n1, n, sign)
    tables = {
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "f2r": f2r, "f2i": f2i, "f2s": f2s, "f2d": f2d,
        "twr": twr, "twi": twi,
    }
    return FusedPlan(n=n, sign=sign, kind="fourstep", n1=n1, n2=n2, tables=tables)


def _mixed_fft(xr, xi, n: int, sign: int):
    """Exact length-n transform by the mixed-digit folded four-step."""
    from ..kernels.fused_torch import fused_fft_folded

    return fused_fft_folded(xr, xi, on_device(_mixed_plan, n, sign, device=xr.device))


def _check_exact_n(n: int) -> None:
    """Validate n for the exact API.  Power-of-two lengths go straight to the
    transform dispatch and only need n <= MAX_N; the Bluestein bound
    (2n - 1 <= MAX_N) applies to the other lengths."""
    if n < 1:
        raise ValueError("fft_exact requires a non-empty signal")
    if n & (n - 1) == 0:
        if n > MAX_N:
            raise ValueError(f"fft_exact length {n} exceeds the supported maximum {MAX_N}")
    elif 2 * n - 1 > MAX_N:
        raise ValueError(
            f"fft_exact length {n} needs a {2 * n - 1}-point convolution, "
            f"beyond the supported maximum {MAX_N}"
        )


def _exact(xr, xi, n: int, sign: int):
    """The unnormalized exact transform of (B, n) rows: the dispatch for a
    power of two, the mixed four-step or Bluestein otherwise."""
    if n >= 2 and n & (n - 1) == 0:
        from ..kernels.large import transform_any

        return transform_any(xr, xi, n, sign)
    if n == 1:
        return xr, torch.zeros_like(xr) if xi is None else xi
    if mixed_split(n) is not None:
        return _mixed_fft(xr, xi, n, sign)
    return _bluestein(xr, xi, n, sign)


def fft_exact_device(x, imag=None, device=None):
    """Exact forward DFT of length-n rows for ANY n, on the tensor's device.

    ``x``: (n,) or (B, n) f32; ``imag`` an optional imaginary part of the
    same shape.  Returns split-complex tensors of length n — the true n-point
    spectrum, unlike ``fft``, which zero-pads to a power of two.
    """
    x = _as_tensor(x, device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    _check_exact_n(n)
    xi = None
    if imag is not None:
        xi = _as_tensor(imag, x.device)
        xi = xi[None] if squeeze else xi
        if xi.shape != x.shape:
            raise ValueError(f"fft_exact: real and imag shapes differ: "
                             f"{tuple(x.shape)} vs {tuple(xi.shape)}")
    yr, yi = _exact(x, xi, n, -1)
    return (yr[0], yi[0]) if squeeze else (yr, yi)


def ifft_exact_device(xr, xi, device=None):
    """Exact inverse DFT (1/n normalized) for ANY length n, on the tensors'
    device."""
    xr = _as_tensor(xr, device)
    xi = _as_tensor(xi, xr.device if device is None else device)
    if xr.shape != xi.shape:
        raise ValueError(f"ifft_exact: shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    squeeze = xr.dim() == 1
    if squeeze:
        xr, xi = xr[None], xi[None]
    n = xr.shape[-1]
    _check_exact_n(n)
    yr, yi = _exact(xr, xi, n, +1)
    s = float(np.float32(1.0 / n))
    yr = yr * s
    yi = yi * s
    return (yr[0], yi[0]) if squeeze else (yr, yi)


def fft_exact(input, device=None):
    """Host-convenience exact forward DFT (numpy in, (re, im) numpy out)."""
    yr, yi = fft_exact_device(np.asarray(input, dtype=np.float32), device=device)
    return yr.cpu().numpy(), yi.cpu().numpy()


def ifft_exact(input_real, input_imag, device=None):
    """Host-convenience exact inverse DFT (numpy in, (re, im) numpy out)."""
    yr, yi = ifft_exact_device(
        np.asarray(input_real, dtype=np.float32), np.asarray(input_imag, dtype=np.float32),
        device=device,
    )
    return yr.cpu().numpy(), yi.cpu().numpy()
