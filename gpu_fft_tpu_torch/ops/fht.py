"""Fast Hankel transform on a logarithmic grid (FFTLog).

Port of ``gpu_fft_tpu/ops/fht.py``: the same f64 host kernel tables,
cached on the device; a power-of-two n takes ``rfft_device`` /
``irfft_device``, any other n the exact (Bluestein or mixed) transforms.

For a signal sampled on a log-spaced grid ``r_j = r_c * exp((j - j_c) * dln)``
the discrete Hankel transform

    A(k_j) = integral  a(r) * J_mu(k r) * (k r)  dln(r)

is a *convolution* in ln(r), so it reduces to one multiplication in the
Fourier domain of the log grid — Talman (1978) / Hamilton (2000), the
"FFTLog" algorithm.  The Fourier-domain kernel is a ratio of gamma
functions:

    u_m = (k_c r_c)^(-2*pi*i*m/(n*dln)) * U_mu(q + 2*pi*i*m/(n*dln)),
    U_mu(x) = 2^x * Gamma((mu + 1 + x) / 2) / Gamma((mu + 1 - x) / 2),

with ``q`` the power-law bias.  The transform itself is one real FFT, a
half-spectrum multiply, and one inverse real FFT — it rides this library's
real-input/real-output transform paths on device (pow2 lengths) or the
exact-length path (any other length).

Conventions match ``scipy.fft.fht`` / ``ifht`` / ``fhtoffset`` (verified
element-wise in the test suite).  Kernel coefficients are built on the host
in f64 with an original complex log-gamma (Stirling series after an upward
recurrence shift); the device compute is f32 split-complex.

No counterpart in the reference (pure extension); the host/device split and
split-complex convention mirror ``ops/czt.py``.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np

from ..config import MAX_N
from .transform import _as_tensor

__all__ = ["fht", "fht_device", "fhtoffset", "ifht", "ifht_device"]

_LN2 = math.log(2.0)

# Stirling asymptotic series for log Gamma: coefficients B_2k / (2k*(2k-1)).
# Eight terms after shifting to Re z >= 8 keep the truncation error below
# f64 rounding for every argument this module produces.
_STIRLING = (
    1.0 / 12.0,
    -1.0 / 360.0,
    1.0 / 1260.0,
    -1.0 / 1680.0,
    1.0 / 1188.0,
    -691.0 / 360360.0,
    7.0 / 1560.0,
    -3617.0 / 122400.0,
)


def _lngamma(z):
    """Log-gamma of complex ``z``, vectorized f64 host math.

    Upward recurrence ``lnGamma(z) = lnGamma(z + 1) - log(z)`` shifts the
    argument to Re z >= 8, where the Stirling series converges below f64
    rounding.  The result may differ from the analytic continuation by a
    multiple of 2*pi*i — every consumer in this module either exponentiates
    it or reduces it mod an integer count of half-turns, so the branch is
    immaterial.  Poles (non-positive real integers) return inf.
    """
    z = np.asarray(z, dtype=np.complex128)
    shift = max(0, 8 - int(math.floor(float(z.real.min()))))
    acc = np.zeros(z.shape, dtype=np.complex128)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(shift):
            acc -= np.log(z + k)
    w = z + shift
    r = 1.0 / w
    r2 = r * r
    s = np.zeros_like(w)
    for c in reversed(_STIRLING):
        s = s * r2 + c
    s = s * r  # sum_k c_k / w^(2k-1)
    out = (w - 0.5) * np.log(w) - w + 0.5 * math.log(2.0 * math.pi) + s + acc
    # A pole makes acc = +inf - nan games; normalize to a clean +inf.
    bad = ~np.isfinite(out)
    if np.any(bad):
        out = np.where(bad, np.complex128(np.inf), out)
    return out


def _gamma_sign(x: float) -> float:
    """Sign of Gamma at a real non-pole ``x``: positive on (0, inf) and on
    (-2k-2, -2k-1), negative on (-2k-1, -2k)."""
    if x > 0:
        return 1.0
    return -1.0 if (math.floor(-x) % 2 == 0) else 1.0


def _gamma_ratio(xp: float, xm: float) -> float:
    """``Gamma(xp) / Gamma(xm)`` for real arguments, poles included.

    When both arguments sit on poles the ratio has the finite Pochhammer
    limit ``prod_{i<d} (xm + i)`` with ``d = xp - xm`` (an integer there);
    a lone numerator pole is +inf (singular forward transform), a lone
    denominator pole is 0 (singular inverse).
    """

    def _pole(x: float) -> bool:
        return x <= 0 and x == round(x)

    if _pole(xp) and _pole(xm):
        d = int(round(xp - xm))
        if d >= 0:
            out = 1.0
            for i in range(d):
                out *= xm + i
            return out
        out = 1.0
        for i in range(-d):
            out *= xp + i
        return 1.0 / out if out != 0 else math.inf
    if _pole(xp):
        return math.inf
    if _pole(xm):
        return 0.0
    sign = _gamma_sign(xp) * _gamma_sign(xm)
    return sign * math.exp(math.lgamma(xp) - math.lgamma(xm))


@functools.lru_cache(maxsize=None)
def _fht_plan(n: int, dln: float, mu: float, offset: float, bias: float) -> dict:
    """Host-built f64 FFTLog tables for one (n, dln, mu, offset, bias).

    ``u``: the n//2 + 1 half-spectrum kernel coefficients; ``v = 1/conj(u)``
    is the inverse-transform multiply table (host division in f64 beats a
    device-side divide in both accuracy and flops).  Full-spectrum mirrors
    (Hermitian extension) serve the non-pow2 Bluestein path.  Bias pre/post
    factors are the power-law tapers of Hamilton (2000) App. B.
    """
    lnkr, q = offset, bias
    xp = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    h = n // 2 + 1
    y = np.pi * np.arange(h) / (n * dln)
    zp = _lngamma(xp + 1j * y)
    zm = _lngamma(xm + 1j * y)
    # ln u_m = q ln2 + lnG(xp+iy) - conj(lnG(xm+iy)) + 2iy (ln2 - ln(kr));
    # the conj pairs the two gamma evaluations so only y >= 0 is computed.
    # A gamma pole at y=0 makes lu[0] = inf - inf; that slot is overwritten
    # with the exact pole-limit ratio below, so the nan is expected noise.
    with np.errstate(invalid="ignore"):
        lu = (q * _LN2 + zp.real - zm.real) + 1j * (
            zp.imag + zm.imag + 2.0 * y * (_LN2 - lnkr)
        )
    with np.errstate(over="ignore", invalid="ignore"):
        u = np.exp(lu)
    # m = 0 exactly, with gamma-pole limits (exp path loses the sign and the
    # pole semantics of the real-axis gamma ratio).
    u[0] = (2.0**q) * _gamma_ratio(xp, xm)
    if n % 2 == 0:
        # Nyquist coefficient of a real circular kernel must be real.
        u[-1] = u[-1].real
    singular_fwd = not np.isfinite(u[0])
    singular_inv = u[0] == 0
    ufix = u.copy()
    if singular_fwd:
        ufix[0] = 0.0  # drop the unrecoverable mode, scipy semantics
    with np.errstate(divide="ignore"):
        v = 1.0 / np.conj(u)
    if singular_inv:
        v[0] = 0.0  # 1/conj(inf): the mode is gone either way
    j = np.arange(n, dtype=np.float64)
    jc = (n - 1) / 2.0
    plan = {
        "ur": ufix.real.astype(np.float32),
        "ui": ufix.imag.astype(np.float32),
        "vr": v.real.astype(np.float32),
        "vi": v.imag.astype(np.float32),
        "singular_fwd": bool(singular_fwd),
        "singular_inv": bool(singular_inv),
    }
    if n & (n - 1):  # non-pow2: Bluestein path needs the full spectrum
        full_u = np.concatenate([ufix, np.conj(ufix[1 : n - h + 1][::-1])])
        full_v = np.concatenate([v, np.conj(v[1 : n - h + 1][::-1])])
        plan["fur"] = full_u.real.astype(np.float32)
        plan["fui"] = full_u.imag.astype(np.float32)
        plan["fvr"] = full_v.real.astype(np.float32)
        plan["fvi"] = full_v.imag.astype(np.float32)
    if q != 0.0:
        t = (j - jc) * dln
        plan["pre_f"] = np.exp(-q * t).astype(np.float32)
        plan["post_f"] = np.exp(-q * (t + lnkr)).astype(np.float32)
        plan["pre_i"] = np.exp(q * (t + lnkr)).astype(np.float32)
        plan["post_i"] = np.exp(q * t).astype(np.float32)
    return plan


def _validate(a, dln: float, n: int) -> None:
    if n < 1:
        raise ValueError("fht requires a non-empty signal")
    if not (dln > 0):
        raise ValueError(f"fht requires a positive log spacing dln, got {dln}")
    if n & (n - 1) and 2 * n - 1 > MAX_N:
        raise ValueError(
            f"fht length {n} needs a {2 * n - 1}-point convolution, "
            f"beyond the supported maximum {MAX_N}"
        )
    if n > MAX_N:
        raise ValueError(f"fht length {n} exceeds the supported maximum {MAX_N}")


def _fht_convolve(a, plan: dict, inverse: bool):
    """One FFTLog circular convolution of real rows ``a``: rfft,
    half-spectrum multiply, irfft, index reversal.  A power-of-two n takes
    the real-input / real-output transforms; any other n the exact
    transforms with the full-spectrum tables."""
    n = a.shape[-1]
    if n >= 2 and n & (n - 1) == 0:
        from .transform import irfft_device, rfft_device

        kr, ki = (plan["vr"], plan["vi"]) if inverse else (plan["ur"], plan["ui"])
        yr, yi = rfft_device(a)
        out = irfft_device(yr * kr - yi * ki, yr * ki + yi * kr)
    else:
        from .exact import fft_exact_device, ifft_exact_device

        kr, ki = (plan["fvr"], plan["fvi"]) if inverse else (plan["fur"], plan["fui"])
        yr, yi = fft_exact_device(a)
        out, _ = ifft_exact_device(yr * kr - yi * ki, yr * ki + yi * kr)
    return out.flip(-1)


def _fht_common(a, dln, mu, offset, bias, inverse: bool, device):
    from ..plan import on_device

    a = _as_tensor(a, device)
    if a.dim() == 0:
        raise ValueError("fht expects at least a 1-D signal")
    lead = a.shape[:-1]
    n = a.shape[-1]
    _validate(a, float(dln), n)
    a = a.reshape(-1, n)
    plan = on_device(_fht_plan, n, float(dln), float(mu), float(offset), float(bias), device=a.device)
    if inverse and plan["singular_inv"]:
        warnings.warn("singular inverse transform; consider changing the bias")
    if not inverse and plan["singular_fwd"]:
        warnings.warn("singular transform; consider changing the bias")
    if float(bias) != 0.0:
        a = a * plan["pre_i" if inverse else "pre_f"]
    out = _fht_convolve(a, plan, inverse)
    if float(bias) != 0.0:
        out = out * plan["post_i" if inverse else "post_f"]
    return out.reshape(*lead, n)


def fht_device(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0, device=None):
    """Fast Hankel transform of order ``mu`` over the last axis, on the
    tensor's device.

    ``a``: real samples on a log grid with spacing ``dln``; ``offset`` is
    ``ln(k_c * r_c)`` (:func:`fhtoffset` gives the low-ringing choice);
    ``bias`` the power-law bias exponent q.  Returns the transform on the
    reciprocal log grid (``scipy.fft.fht`` semantics, any length n).
    """
    return _fht_common(a, dln, mu, offset, bias, False, device)


def ifht_device(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0, device=None):
    """Inverse of :func:`fht_device` (``scipy.fft.ifht`` semantics): the
    algebraic inverse of the discrete transform (the same kernel divided
    out), since unbiased FFTLog is not exactly unitary on a finite grid."""
    return _fht_common(A, dln, mu, offset, bias, True, device)


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0, device=None):
    """Host-convenience fast Hankel transform; see :func:`fht_device`."""
    return fht_device(np.asarray(a, dtype=np.float32), dln, mu, offset, bias, device=device).cpu().numpy()


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0, device=None):
    """Host-convenience inverse fast Hankel transform; see :func:`ifht_device`."""
    return ifht_device(np.asarray(A, dtype=np.float32), dln, mu, offset, bias, device=device).cpu().numpy()


def fhtoffset(dln: float, mu: float, initial: float = 0.0, bias: float = 0.0) -> float:
    """Return an offset near ``initial`` satisfying the low-ringing condition.

    Picks ``ln(k_c r_c)`` so the FFTLog kernel's Nyquist-frequency phase is a
    multiple of pi, which minimizes ringing of the periodic extension —
    ``scipy.fft.fhtoffset`` semantics.
    """
    if not (dln > 0):
        raise ValueError(f"fhtoffset requires a positive dln, got {dln}")
    lnkr, q = float(initial), float(bias)
    xp = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    y = np.pi / (2.0 * float(dln))
    zp = complex(_lngamma(complex(xp, y)))
    zm = complex(_lngamma(complex(xm, y)))
    arg = (_LN2 - lnkr) / float(dln) + (zp.imag + zm.imag) / np.pi
    return lnkr + (arg - round(arg)) * float(dln)
