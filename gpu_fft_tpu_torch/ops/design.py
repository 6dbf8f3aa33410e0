"""Classic IIR filter design: Butterworth / Chebyshev I / Chebyshev II.

The port's own copy of ``gpu_fft_tpu/ops/design.py`` (pure numpy, the
same code), so the port imports nothing of the JAX package;
``tests/test_torch_design.py`` holds the two equal.

Extension beyond the reference surface, completing the IIR story: design
here, run through the block-state engine (``ops/iir.py``).  Pure host-side
f64 polynomial math, like scipy's — design is a one-time setup cost, the
device work is the filtering.  The pipeline is scipy's exactly: analog
lowpass prototype (zpk) -> frequency transform (lp2lp/hp/bp/bs) ->
bilinear transform with frequency pre-warping -> tf or sos coefficients;
verified against scipy coefficient-wise (ba) and response-wise (sos) in
``tests/test_design.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "butter",
    "cheby1",
    "cheby2",
    "iirfilter",
    "buttord",
    "cheb1ord",
    "cheb2ord",
    "iirnotch",
    "iirpeak",
    "bilinear",
    "zpk2tf",
    "zpk2sos",
    "tf2zpk",
    "tf2sos",
    "sos2tf",
    "sos2zpk",
    "normalize",
    "freqz_zpk",
    "bessel",
    "iircomb",
    "ellip",
    "ellipord",
    "BadCoefficients",
    "band_stop_obj",
    "buttap",
    "cheb1ap",
    "cheb2ap",
    "ellipap",
    "besselap",
    "lp2lp",
    "lp2hp",
    "lp2bp",
    "lp2bs",
    "lp2lp_zpk",
    "lp2hp_zpk",
    "lp2bp_zpk",
    "lp2bs_zpk",
    "bilinear_zpk",
    "findfreqs",
    "freqs",
    "freqs_zpk",
    "iirdesign",
]


# ── analog lowpass prototypes (zpk, cutoff 1 rad/s) ─────────────────────────


def _buttap(n: int):
    """Butterworth prototype: n poles equispaced on the left unit circle."""
    m = np.arange(-n + 1, n, 2)
    p = -np.exp(1j * np.pi * m / (2 * n))
    return np.array([], dtype=complex), p, 1.0


def _cheb1ap(n: int, rp: float):
    """Chebyshev-I prototype: rp dB equiripple passband."""
    eps = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    m = np.arange(-n + 1, n, 2)
    theta = np.pi * m / (2.0 * n)
    p = -np.sinh(mu + 1j * theta)
    k = np.prod(-p).real
    if n % 2 == 0:
        k /= np.sqrt(1.0 + eps * eps)
    return np.array([], dtype=complex), p, float(k)


def _cheb2ap(n: int, rs: float):
    """Chebyshev-II prototype: rs dB equiripple stopband (inverse Cheb)."""
    de = 1.0 / np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = np.arcsinh(1.0 / de) / n
    if n % 2:
        m = np.concatenate((np.arange(-n + 1, 0, 2), np.arange(2, n, 2)))
    else:
        m = np.arange(-n + 1, n, 2)
    z = -np.conjugate(1j / np.sin(m * np.pi / (2.0 * n)))
    p = -np.exp(1j * np.pi * np.arange(-n + 1, n, 2) / (2.0 * n))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = (np.prod(-p) / np.prod(-z)).real
    return z, p, float(k)


# ── elliptic-function kernel (Landen/AGM, host f64) ─────────────────────────
# The compact Landen-recursion formulation of Jacobi cd/sn and their
# inverses (Orfanidis, "Lecture notes on elliptic filter design"), enough
# to express the elliptic prototype in closed form — no scipy.special.


def _ellipk_agm(m: float) -> float:
    """Complete elliptic integral K(m) (parameter m = k^2) by AGM."""
    if m < 0.0 or m >= 1.0:
        if m == 1.0:
            return np.inf
        raise ValueError(f"K(m) needs 0 <= m < 1, got {m}")
    a, b = 1.0, np.sqrt(1.0 - m)
    # AGM is quadratic: 8 iterations reach f64 limits from any admissible m;
    # a relative-gap while-loop can live-lock 1 ulp apart, so iterate fixed.
    for _ in range(12):
        if abs(a - b) <= 2e-16 * a:
            break
        a, b = 0.5 * (a + b), np.sqrt(a * b)
    return np.pi / (2.0 * a)


def _landen(k: float) -> list[float]:
    """Descending Landen sequence k -> k_1 -> ... until ~0."""
    v = []
    while k > 1e-16:
        kp = np.sqrt(1.0 - k * k)
        k = (k / (1.0 + kp)) ** 2
        v.append(k)
        if len(v) > 40:
            break
    return v


def _cde(u, k: float):
    """cd(u*K(k), k) for complex u (u in quarter-period units)."""
    v = _landen(k)
    w = np.cos(np.asarray(u, dtype=complex) * np.pi / 2.0)
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _sne(u, k: float):
    """sn(u*K(k), k) for complex u (quarter-period units)."""
    v = _landen(k)
    w = np.sin(np.asarray(u, dtype=complex) * np.pi / 2.0)
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _asne(w, k: float):
    """Inverse sn: u with sn(u*K(k), k) = w, complex w (principal branch)."""
    v = _landen(k)
    w = np.asarray(w, dtype=complex)
    kn = k
    for vn in v:
        w = 2.0 * w / ((1.0 + vn) * (1.0 + np.sqrt(1.0 - kn * kn * w * w)))
        kn = vn
    return 2.0 * np.arcsin(w) / np.pi


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the degree equation for the selectivity k given N and the
    discrimination k1 = ep/es (exact nome-free solution via sn products)."""
    l = n // 2
    ui = (2.0 * np.arange(1, l + 1) - 1.0) / n
    kc = np.sqrt(1.0 - k1 * k1)  # complement of k1
    kp = kc**n * np.prod(np.real(_sne(ui, kc))) ** 4
    return float(np.sqrt(1.0 - kp * kp))


def _ellipap(n: int, rp: float, rs: float):
    """Elliptic analog lowpass prototype (scipy ``ellipap``): equiripple in
    BOTH bands.  Closed-form zeros/poles on the Landen-recursion Jacobi
    functions; passband edge at 1 rad/s."""
    if rp <= 0 or rs <= rp:
        raise ValueError("need 0 < rp < rs (dB)")
    if n == 1:
        p = np.array([-np.sqrt(1.0 / (10.0 ** (0.1 * rp) - 1.0))], dtype=complex)
        return np.array([], dtype=complex), p, float(-p[0].real)
    ep = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    es = np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k1 = ep / es
    k = _ellipdeg(n, k1)
    l = n // 2
    ui = (2.0 * np.arange(1, l + 1) - 1.0) / n
    zc = 1j / (k * np.real(_cde(ui, k)))  # conjugate-pair zeros, +j half
    v0 = np.real(-1j * _asne(1j / ep, k1) / n)  # asne(j*y) is imaginary → real
    pc = 1j * _cde(ui - 1j * v0, k)
    z = np.concatenate([zc, np.conj(zc)])
    p = np.concatenate([pc, np.conj(pc)])
    if n % 2:
        p0 = 1j * _sne(1j * v0, k)
        p = np.append(p, complex(p0))
    gain = np.real(np.prod(-p) / np.prod(-z))
    if n % 2 == 0:
        gain /= np.sqrt(1.0 + ep * ep)
    return z, p, float(gain)


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) design (``scipy.signal.ellip``): rp dB equiripple
    passband, rs dB equiripple stopband — the minimum order for a given
    transition band."""
    return iirfilter(N, Wn, rp=rp, rs=rs, btype=btype, analog=analog,
                     ftype="ellip", output=output, fs=fs)


def ellipord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum elliptic order for the spec (``scipy.signal.ellipord``):
    N = ceil(K(k)K'(k1) / (K'(k)K(k1))) on the selectivity k and
    discrimination k1; Wn = the passband edge(s)."""
    ftype, passb, stopb, gp, gs = _ord_setup(wp, ws, gpass, gstop, analog, fs, "ellip")
    if ftype == 1:
        nat = abs(stopb[0] / passb[0])
    elif ftype == 2:
        nat = abs(passb[0] / stopb[0])
    elif ftype == 3:
        nat = float(np.min(np.abs(stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1]))))
    else:
        nat = float(np.min(np.abs((stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1])))))
    n = max(int(np.ceil(_ellip_order(nat, gp, gs))), 1)
    return n, _wn_back(passb, analog, fs)


def _ellip_order(nat: float, gp: float, gs: float) -> float:
    """The (real-valued) elliptic order meeting selectivity ``nat`` (>=1)."""
    k = 1.0 / nat  # selectivity
    k1sq = (gp - 1.0) / (gs - 1.0)  # discrimination^2
    return (_ellipk_agm(k * k) * _ellipk_agm(1.0 - k1sq)) / (
        _ellipk_agm(1.0 - k * k) * _ellipk_agm(k1sq)
    )


def _bessel_poly(n: int) -> np.ndarray:
    """Reversed Bessel polynomial theta_n coefficients, ascending powers,
    exact integers as f64: a_k = (2n-k)! / (2^(n-k) k! (n-k)!).  Exact in
    f64 through n=25 (largest value (2n)!/(2^n n!) ~ 6e32 << 2^53-exact
    range fails earlier, but the VALUES here stay integers representable
    exactly only to n~13; beyond that they carry ~1 ulp relative error,
    which the Newton polish below absorbs)."""
    from math import factorial

    a = np.empty(n + 1, dtype=np.float64)
    for k in range(n + 1):
        a[k] = factorial(2 * n - k) / (2.0 ** (n - k) * factorial(k) * factorial(n - k))
    return a


def _besselap(n: int, norm: str = "phase"):
    """Bessel analog prototype (scipy ``besselap``): all-pole, poles = roots
    of the reversed Bessel polynomial.  Roots come from np.roots on the
    PHASE-NORMALIZED polynomial (O(1) coefficients condition the companion
    eigenproblem far better than the raw (2n)!-range ones), then two Newton
    polish steps against the exact-coefficient Horner form."""
    if n == 0:
        return np.array([], dtype=complex), np.array([], dtype=complex), 1.0
    a = _bessel_poly(n)  # ascending
    a0 = a[0]
    c = a0 ** (1.0 / n)  # phase-normalizing radius scale
    scaled = a * c ** np.arange(n + 1) / a0  # theta_n(c*t)/a0, O(1) coeffs
    p = np.roots(scaled[::-1])
    # Newton polish on the scaled polynomial (exact-coeff Horner + deriv).
    d = scaled[1:] * np.arange(1, n + 1)
    for _ in range(3):
        f = np.polyval(scaled[::-1], p)
        fp = np.polyval(d[::-1], p)
        step = f / np.where(fp == 0, 1.0, fp)
        p = p - np.where(np.abs(step) < 1.0, step, 0.0)
    if norm == "phase":
        k = 1.0  # prod(-p) = scaled constant term = 1
    elif norm == "delay":
        p = p * c
        k = a0
    elif norm == "mag":
        pd = p * c  # delay-normalized poles
        # -3 dB frequency: |theta_n(jw)|^2 = 2*a0^2, monotone in w.
        def mag2(w):
            v = np.polyval(a[::-1], 1j * w)
            return v.real * v.real + v.imag * v.imag

        lo, hi = 0.0, 2.0
        target = 2.0 * a0 * a0
        while mag2(hi) < target:
            hi *= 2.0
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if mag2(mid) < target:
                lo = mid
            else:
                hi = mid
        w3 = 0.5 * (lo + hi)
        p = pd / w3
        k = a0 / w3**n
    else:
        raise ValueError(f"norm must be phase|delay|mag, got {norm!r}")
    return np.array([], dtype=complex), p, float(k)


def bessel(N: int, Wn, btype: str = "low", analog: bool = False, output: str = "ba",
           norm: str = "phase", fs=None):
    """Bessel/Thomson design (``scipy.signal.bessel``): maximally flat
    group delay.  ``norm``: 'phase' (default, half-phase point at Wn),
    'delay' (pure delay-normalized prototype: group delay 1/Wn), 'mag'
    (-3 dB magnitude at Wn)."""
    return iirfilter(N, Wn, btype=btype, analog=analog, ftype="bessel",
                     output=output, fs=fs, _norm=norm)


def iircomb(w0: float, Q: float, ftype: str = "notch", fs: float = 2.0,
            *, pass_zero: bool = False):
    """``scipy.signal.iircomb``: order-N comb notching (or peaking) every
    multiple of ``w0``; N = fs/w0 teeth must be an integer.  ``pass_zero``
    shifts the teeth to odd half-multiples (notch) / keeps DC in the
    passband, scipy 1.9 semantics."""
    if Q <= 0 or fs <= 0:
        raise ValueError("Q and fs must be positive")
    if w0 <= 0 or w0 >= fs / 2:
        raise ValueError("w0 must lie strictly inside (0, fs/2)")
    if ftype not in ("notch", "peak"):
        raise ValueError(f"ftype must be 'notch' or 'peak', got {ftype!r}")
    order = fs / w0
    n = int(round(order))
    if abs(order - n) > 1e-9 * max(1.0, order):
        raise ValueError("w0 must divide fs into an integer number of teeth")
    w_delta = 2.0 * np.pi * (w0 / Q) / fs  # -3 dB bandwidth, rad/sample
    # Half-power edge condition for the comb (scipy's derivation): the
    # feedback coefficient from the bandwidth via tan.
    beta = np.tan(n * w_delta / 4.0)
    # Teeth at multiples of w0 (pass_zero=False) or between them.
    sign = -1.0 if ((ftype == "notch") != bool(pass_zero)) else 1.0
    ax = (1.0 - beta) / (1.0 + beta)
    b = np.zeros(n + 1)
    a = np.zeros(n + 1)
    a[0] = 1.0
    a[-1] = sign * ax
    if ftype == "notch":
        g = (1.0 + ax) / 2.0
        b[0] = g
        b[-1] = sign * g
    else:
        g = (1.0 - ax) / 2.0
        b[0] = g
        b[-1] = -sign * g
    return b, a


# ── zpk frequency transforms (scipy's lp2*_zpk) ─────────────────────────────


def _lp2lp(z, p, k, wo):
    return z * wo, p * wo, k * wo ** (len(p) - len(z))


def _lp2hp(z, p, k, wo):
    deg = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], dtype=complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(deg))
    k = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(1.0 / np.prod(-p))
    return zh, ph, k


def _lp2bp(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zl, pl = z * bw / 2.0, p * bw / 2.0
    zb = np.concatenate((zl + np.sqrt(zl**2 - wo**2 + 0j), zl - np.sqrt(zl**2 - wo**2 + 0j)))
    pb = np.concatenate((pl + np.sqrt(pl**2 - wo**2 + 0j), pl - np.sqrt(pl**2 - wo**2 + 0j)))
    zb = np.append(zb, np.zeros(deg))
    return zb, pb, k * bw**deg


def _lp2bs(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zh = (bw / 2.0) / z if len(z) else np.array([], dtype=complex)
    ph = (bw / 2.0) / p
    zb = np.concatenate((zh + np.sqrt(zh**2 - wo**2 + 0j), zh - np.sqrt(zh**2 - wo**2 + 0j)))
    pb = np.concatenate((ph + np.sqrt(ph**2 - wo**2 + 0j), ph - np.sqrt(ph**2 - wo**2 + 0j)))
    zb = np.append(zb, np.full(deg, 1j * wo))
    zb = np.append(zb, np.full(deg, -1j * wo))
    num = np.prod(-z) if len(z) else 1.0
    return zb, pb, k * np.real(num / np.prod(-p))


def _bilinear_zpk(z, p, k, fs):
    """Tustin map s -> 2fs(z-1)/(z+1) on a zpk triple (scipy bilinear_zpk)."""
    fs2 = 2.0 * fs
    deg = len(p) - len(z)
    zd = (fs2 + z) / (fs2 - z) if len(z) else np.array([], dtype=complex)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(deg))
    num = np.prod(fs2 - z) if len(z) else 1.0
    kd = k * np.real(num / np.prod(fs2 - p))
    return zd, pd, kd


# ── coefficient forms ────────────────────────────────────────────────────────


def zpk2tf(z, p, k):
    """(zeros, poles, gain) -> transfer-function (b, a) coefficients."""
    b = k * np.atleast_1d(np.poly(z))
    a = np.atleast_1d(np.poly(p))
    if np.isrealobj(k) and np.allclose(b.imag, 0.0, atol=1e-12 * max(1.0, np.abs(b).max())):
        b = b.real
    if np.allclose(a.imag, 0.0, atol=1e-12 * max(1.0, np.abs(a).max())):
        a = a.real
    return np.atleast_1d(b), np.atleast_1d(a)


def _conj_pairs(roots):
    """Group a conjugate-symmetric root multiset into 2-root sections:
    conjugate pairs first (by descending |r| — sections nearest the unit
    circle come LAST in the cascade, scipy's ordering heuristic), then
    reals paired together, with one leftover real allowed."""
    roots = np.asarray(roots, dtype=complex)
    cplx = sorted(
        (r for r in roots if abs(r.imag) > 1e-12 * max(1.0, abs(r))),
        key=lambda r: (r.real, abs(r.imag), r.imag),
    )
    reals = sorted((r.real for r in roots if abs(r.imag) <= 1e-12 * max(1.0, abs(r))), key=abs)
    pairs, i = [], 0
    while i < len(cplx):
        r = cplx[i]
        j = min(
            range(i + 1, len(cplx)),
            key=lambda q: abs(cplx[q] - np.conj(r)),
        )
        pairs.append((r, cplx[j]))
        cplx.pop(j)
        i += 1
    while len(reals) >= 2:
        pairs.append((reals.pop(), reals.pop()))
    single = reals[0] if reals else None
    return pairs, single


def zpk2sos(z, p, k):
    """(z, p, k) -> (n_sections, 6) second-order sections.

    Correct-by-construction pairing for real-coefficient designs
    (conjugate-symmetric z/p sets, len(z) <= len(p)): conjugate pole pairs
    each take the nearest remaining zero pair; leftover real roots share a
    section; sections ordered so poles nearest the unit circle come last
    (the standard fixed-point-friendly cascade order, as scipy does).  The
    CASCADE response is exact for any valid pairing — verified against the
    tf form response-wise in the tests.
    """
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    if len(z) > len(p):
        raise ValueError("zpk2sos requires len(z) <= len(p)")
    if len(p) == 0:
        return np.array([[k, 0.0, 0.0, 1.0, 0.0, 0.0]])
    ppairs, psingle = _conj_pairs(p)
    zpairs, zsingle = _conj_pairs(z)
    # Order pole sections by |p| ascending -> nearest unit circle LAST.
    ppairs.sort(key=lambda pr: max(abs(pr[0]), abs(pr[1])))
    used = [False] * len(zpairs)
    sections = []
    for pa, pb in ppairs:
        zz: tuple = ()
        best, bestd = None, np.inf
        for i, (za, zb) in enumerate(zpairs):
            if used[i]:
                continue
            dist = abs(za - pa) + abs(zb - pb)
            if dist < bestd:
                best, bestd = i, dist
        if best is not None:
            used[best] = True
            zz = zpairs[best]
        sections.append((zz, (pa, pb)))
    if psingle is not None:
        zz = (zsingle,) if zsingle is not None else ()
        zsingle = None
        sections.append((zz, (psingle,)))
    assert all(used) and zsingle is None, "unpaired zeros"
    sos = np.zeros((len(sections), 6))
    for i, (zz, pp) in enumerate(sections):
        b = np.poly(np.asarray(zz, dtype=complex)) if len(zz) else np.array([1.0])
        a = np.poly(np.asarray(pp, dtype=complex))
        sos[i, : len(b)] = np.real(b)
        sos[i, 3 : 3 + len(a)] = np.real(a)
    sos[-1, :3] *= k  # fold the gain into the last (dominant) section
    # scipy convention: sections ordered with the near-unit-circle poles
    # last; the gain-carrying section is conventionally first there, but
    # the cascade response is identical — tests compare responses.
    return sos


class BadCoefficients(UserWarning):
    """Warning emitted when ``normalize`` strips near-zero leading
    numerator coefficients (``scipy.signal.BadCoefficients``)."""


def normalize(b, a):
    """``scipy.signal.normalize``: make the transfer function canonical —
    strip leading numerator zeros and divide through by ``a[0]``."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a.ndim != 1 or b.ndim > 2:
        raise ValueError("normalize expects 1-D a and 1-D or 2-D b")
    if a[0] == 0.0:
        raise ValueError("denominator a must have a nonzero leading coefficient")
    if np.all(b == 0.0):
        raise ValueError("numerator b must have at least one nonzero coefficient")
    b2 = np.atleast_2d(b) / a[0]
    a = a / a[0]
    # Trim leading (near-)zero numerator columns — scipy's "badly
    # conditioned" trim, at a tight relative tolerance so genuinely small
    # leading coefficients survive.
    tol = 1e-14 * max(1.0, np.abs(b2).max())
    lead = 0
    while lead < b2.shape[1] - 1 and np.all(np.abs(b2[:, lead]) <= tol):
        lead += 1
    if lead:
        import warnings

        warnings.warn("Badly conditioned filter coefficients (numerator): the "
                      "results may be meaningless", BadCoefficients, stacklevel=2)
    b2 = b2[:, lead:]
    return (b2[0] if b.ndim == 1 else b2), a


def tf2zpk(b, a):
    """``scipy.signal.tf2zpk``: (b, a) -> (zeros, poles, gain) via f64
    polynomial roots (fine at design orders, like scipy)."""
    b, a = normalize(b, a)
    b = np.atleast_1d(b)
    if b.ndim != 1:
        raise ValueError("tf2zpk expects a 1-D numerator")
    k = float(b[0])  # normalize() guarantees a nonzero leading coefficient
    z = np.roots(b / k) if b.size > 1 else np.array([], dtype=complex)
    p = np.roots(a) if a.size > 1 else np.array([], dtype=complex)
    return z, p, k


def tf2sos(b, a):
    """``scipy.signal.tf2sos``: (b, a) -> second-order sections, through
    the zpk form (:func:`tf2zpk` then :func:`zpk2sos`)."""
    z, p, k = tf2zpk(b, a)
    return zpk2sos(z, p, k)


def sos2tf(sos):
    """``scipy.signal.sos2tf``: cascade sections -> one (b, a) pair by
    polynomial multiplication across sections (f64)."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    b = np.array([1.0])
    a = np.array([1.0])
    for s in sos:
        b = np.convolve(b, s[:3])
        a = np.convolve(a, s[3:])
    return b, a


def sos2zpk(sos):
    """``scipy.signal.sos2zpk``: per-section quadratic roots, concatenated;
    sections with degenerate (linear/constant) polynomials pad with zeros
    at the origin like scipy's fixed (2 per section) layout."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    m = sos.shape[0]
    z = np.zeros(2 * m, dtype=complex)
    p = np.zeros(2 * m, dtype=complex)
    k = 1.0
    for i, s in enumerate(sos):
        zi, pi, ki = tf2zpk(s[:3], s[3:])
        z[2 * i : 2 * i + len(zi)] = zi
        p[2 * i : 2 * i + len(pi)] = pi
        k *= ki
    return z, p, k


def freqz_zpk(z, p, k, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi):
    """``scipy.signal.freqz_zpk`` (split-complex): evaluate
    H(e^{jw}) = k * prod(e^{jw} - z_i) / prod(e^{jw} - p_i) directly from
    the factored form — no polynomial expansion, so high orders stay
    well-conditioned.  Host f64 design-time math; returns ``(w, Hr, Hi)``.
    The complex facade is ``gpu_fft_tpu.signal.freqz_zpk``.
    """
    if int(worN) != worN or worN < 1:
        raise ValueError(f"worN must be a positive integer, got {worN!r}")
    n = int(worN)
    m = n if whole else 2 * n
    w = np.arange(n) * (fs / m)
    zv = np.exp(2j * np.pi * np.arange(n) / m)
    h = np.full(n, complex(k))
    for zr in np.atleast_1d(np.asarray(z, dtype=complex)):
        h *= zv - zr
    for pr in np.atleast_1d(np.asarray(p, dtype=complex)) if np.asarray(p).size else ():
        h /= zv - pr
    return w, h.real.copy(), h.imag.copy()


def bilinear(b, a, fs: float = 1.0):
    """Tustin transform of analog (b, a) to digital (``scipy.signal.bilinear``)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    # tf -> zpk -> bilinear_zpk -> tf (f64 roots; fine at design orders).
    zz = np.roots(b) if b.size > 1 else np.array([], dtype=complex)
    pp = np.roots(a) if a.size > 1 else np.array([], dtype=complex)
    kk = b[0] / a[0]
    zd, pd, kd = _bilinear_zpk(zz, pp, kk, fs)
    return zpk2tf(zd, pd, kd)


# ── the designers ────────────────────────────────────────────────────────────

_BTYPES = {
    "lowpass": "lowpass", "low": "lowpass", "lp": "lowpass",
    "highpass": "highpass", "high": "highpass", "hp": "highpass",
    "bandpass": "bandpass", "band": "bandpass", "bp": "bandpass",
    "bandstop": "bandstop", "stop": "bandstop", "bs": "bandstop",
}


def iirfilter(
    N: int,
    Wn,
    rp: float | None = None,
    rs: float | None = None,
    btype: str = "band",
    analog: bool = False,
    ftype: str = "butter",
    output: str = "ba",
    fs: float | None = None,
    _norm: str = "phase",
):
    """IIR design front end (``scipy.signal.iirfilter`` for the ftypes
    implemented here: 'butter', 'cheby1', 'cheby2', 'ellip', 'bessel')."""
    if btype == "band":
        btype = "bandpass"
    btype = _BTYPES.get(btype)
    if btype is None:
        raise ValueError(f"btype must be one of {sorted(set(_BTYPES))}")
    if output not in ("ba", "zpk", "sos"):
        raise ValueError(f"output must be ba|zpk|sos, got {output!r}")
    if N < 1:
        raise ValueError(f"filter order must be >= 1, got {N}")
    wn = np.atleast_1d(np.asarray(Wn, dtype=np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs and analog=True are mutually exclusive")
        wn = 2.0 * wn / fs
    if ftype == "butter":
        z, p, k = _buttap(N)
    elif ftype == "cheby1":
        if rp is None:
            raise ValueError("cheby1 needs the passband ripple rp (dB)")
        z, p, k = _cheb1ap(N, rp)
    elif ftype == "cheby2":
        if rs is None:
            raise ValueError("cheby2 needs the stopband attenuation rs (dB)")
        z, p, k = _cheb2ap(N, rs)
    elif ftype in ("ellip", "elliptic"):
        if rp is None or rs is None:
            raise ValueError("ellip needs both rp (passband ripple) and rs (stopband) in dB")
        z, p, k = _ellipap(N, rp, rs)
    elif ftype == "bessel":
        z, p, k = _besselap(N, norm=_norm)
    else:
        raise ValueError(f"ftype must be butter|cheby1|cheby2|ellip|bessel, got {ftype!r}")
    if not analog:
        if np.any(wn <= 0) or np.any(wn >= 1):
            raise ValueError("digital Wn must lie in (0, 1) (fraction of Nyquist)")
        fs2 = 2.0
        warped = 2.0 * fs2 * np.tan(np.pi * wn / fs2)
    else:
        warped = wn
    if btype in ("lowpass", "highpass"):
        if wn.size != 1:
            raise ValueError(f"{btype} needs a scalar Wn, got {wn.size} values")
        z, p, k = (_lp2lp if btype == "lowpass" else _lp2hp)(z, p, k, warped[0])
    else:
        if wn.size != 2 or wn[0] >= wn[1]:
            raise ValueError(f"{btype} needs Wn = [low, high] with low < high")
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = (_lp2bp if btype == "bandpass" else _lp2bs)(z, p, k, wo, bw)
    if not analog:
        z, p, k = _bilinear_zpk(z, p, k, fs2)
    if output == "zpk":
        return z, p, k
    if output == "sos":
        return zpk2sos(z, p, k)
    return zpk2tf(z, p, k)


def butter(N: int, Wn, btype: str = "low", analog: bool = False, output: str = "ba", fs=None):
    """Butterworth design (``scipy.signal.butter``): maximally flat."""
    return iirfilter(N, Wn, btype=btype, analog=analog, ftype="butter", output=output, fs=fs)


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-I design (``scipy.signal.cheby1``): rp dB passband ripple."""
    return iirfilter(N, Wn, rp=rp, btype=btype, analog=analog, ftype="cheby1", output=output, fs=fs)


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-II design (``scipy.signal.cheby2``): rs dB stopband floor."""
    return iirfilter(N, Wn, rs=rs, btype=btype, analog=analog, ftype="cheby2", output=output, fs=fs)


# ── order selection (scipy's *ord algorithm, all four band types) ───────────


def _validate_gpass_gstop(gpass, gstop):
    if gpass <= 0 or gstop <= 0 or gpass >= gstop:
        raise ValueError("need 0 < gpass < gstop (dB)")


def _golden_min(f, lo: float, hi: float, tol: float = 1e-8) -> float:
    """Golden-section minimizer on [lo, hi] (the fminbound stand-in for the
    bandstop edge optimization; the objective is unimodal there)."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = f(c), f(d)
    while (b - a) > tol * max(1.0, abs(a) + abs(b)):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return 0.5 * (a + b)


def _ord_setup(wp, ws, gpass, gstop, analog, fs, kind):
    """Shared *ord front end, mirroring scipy's: validate, classify the
    band type, pre-warp, and (bandstop only) optimize the passband edges
    inward to the point of minimum required order."""
    _validate_gpass_gstop(gpass, gstop)
    wp = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        wp, ws = 2.0 * wp / fs, 2.0 * ws / fs
    ftype = 2 * (wp.shape[0] - 1) + 1
    if wp[0] >= ws[0]:
        ftype += 1  # 1 low, 2 high, 3 bandstop, 4 bandpass
    if analog:
        passb, stopb = wp.copy(), ws.copy()
    else:
        passb, stopb = np.tan(np.pi * wp / 2.0), np.tan(np.pi * ws / 2.0)

    def nat_of(pb):
        if ftype == 1:
            return float(np.abs(stopb[0] / pb[0]))
        if ftype == 2:
            return float(np.abs(pb[0] / stopb[0]))
        if ftype == 3:
            v = stopb * (pb[0] - pb[1]) / (stopb**2 - pb[0] * pb[1])
            return float(np.min(np.abs(v)))
        v = (stopb**2 - pb[0] * pb[1]) / (stopb * (pb[0] - pb[1]))
        return float(np.min(np.abs(v)))

    gp = 10.0 ** (0.1 * abs(gpass))
    gs = 10.0 ** (0.1 * abs(gstop))
    if ftype == 3:
        # Move each passband edge inward to minimize the required order
        # (scipy's band_stop_obj + fminbound step).
        if kind == "butter":
            def order_at(nat):
                return np.log10((gs - 1.0) / (gp - 1.0)) / (2.0 * np.log10(nat))
        elif kind == "ellip":
            def order_at(nat):
                return _ellip_order(nat, gp, gs)
        else:
            def order_at(nat):
                return np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0))) / np.arccosh(nat)

        def obj(w, ind):
            pb = passb.copy()
            pb[ind] = w
            return order_at(nat_of(pb))

        wp0 = _golden_min(lambda w: obj(w, 0), passb[0], stopb[0] - 1e-12)
        wp1 = _golden_min(lambda w: obj(w, 1), stopb[1] + 1e-12, passb[1])
        passb = np.array([wp0, wp1])
    return ftype, passb, stopb, gp, gs


def _wn_back(wn, analog, fs):
    wn = wn if analog else np.arctan(np.asarray(wn)) * 2.0 / np.pi
    wn = np.atleast_1d(wn)
    out = float(wn[0]) if wn.shape[0] == 1 else wn
    if fs is not None:
        out = out * fs / 2.0
    return out


def buttord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Butterworth order for the spec (``scipy.signal.buttord``):
    returns (N, Wn) with Wn the -gpass-dB natural frequency, all four band
    types (the bandstop edge optimization included)."""
    ftype, passb, stopb, gp, gs = _ord_setup(wp, ws, gpass, gstop, analog, fs, "butter")
    nat = {1: lambda: stopb[0] / passb[0], 2: lambda: passb[0] / stopb[0]}.get(ftype)
    if nat is not None:
        nat = abs(float(nat()))
    elif ftype == 3:
        nat = float(np.min(np.abs(stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1]))))
    else:
        nat = float(np.min(np.abs((stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1])))))
    n = int(np.ceil(np.log10((gs - 1.0) / (gp - 1.0)) / (2.0 * np.log10(nat))))
    n = max(n, 1)
    w0 = (gp - 1.0) ** (-1.0 / (2.0 * n))
    if ftype == 1:
        wn = w0 * passb
    elif ftype == 2:
        wn = passb / w0
    elif ftype == 3:
        discr = np.sqrt((passb[1] - passb[0]) ** 2 + 4.0 * w0**2 * passb[0] * passb[1])
        wn = np.sort(np.abs(np.array([
            ((passb[1] - passb[0]) + discr) / (2.0 * w0),
            ((passb[1] - passb[0]) - discr) / (2.0 * w0),
        ])))
    else:
        w0v = np.array([-w0, w0])
        wn = np.sort(np.abs(
            -w0v * (passb[1] - passb[0]) / 2.0
            + np.sqrt(w0v**2 / 4.0 * (passb[1] - passb[0]) ** 2 + passb[0] * passb[1])
        ))
    return n, _wn_back(wn, analog, fs)


def cheb1ord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Chebyshev-I order for the spec; Wn = the passband edge(s)
    (``scipy.signal.cheb1ord``, all four band types)."""
    ftype, passb, stopb, gp, gs = _ord_setup(wp, ws, gpass, gstop, analog, fs, "cheby")
    if ftype == 1:
        nat = abs(stopb[0] / passb[0])
    elif ftype == 2:
        nat = abs(passb[0] / stopb[0])
    elif ftype == 3:
        nat = float(np.min(np.abs(stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1]))))
    else:
        nat = float(np.min(np.abs((stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1])))))
    n = max(int(np.ceil(np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0))) / np.arccosh(nat))), 1)
    return n, _wn_back(passb, analog, fs)


def cheb2ord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Chebyshev-II order for the spec; Wn placed where the analog
    response crosses -gpass dB (``scipy.signal.cheb2ord``, all band types)."""
    ftype, passb, stopb, gp, gs = _ord_setup(wp, ws, gpass, gstop, analog, fs, "cheby")
    if ftype == 1:
        nat = abs(stopb[0] / passb[0])
    elif ftype == 2:
        nat = abs(passb[0] / stopb[0])
    elif ftype == 3:
        nat = float(np.min(np.abs(stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1]))))
    else:
        nat = float(np.min(np.abs((stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1])))))
    v = np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0)))
    n = max(int(np.ceil(v / np.arccosh(nat))), 1)
    new_freq = 1.0 / np.cosh(v / n)
    if ftype == 1:
        wn = passb / new_freq
    elif ftype == 2:
        wn = passb * new_freq
    elif ftype == 3:
        nat0 = new_freq / 2.0 * (passb[0] - passb[1]) + np.sqrt(
            new_freq**2 * (passb[1] - passb[0]) ** 2 / 4.0 + passb[1] * passb[0]
        )
        wn = np.array([nat0, passb[1] * passb[0] / nat0])
    else:
        nat0 = 1.0 / (2.0 * new_freq) * (passb[0] - passb[1]) + np.sqrt(
            (passb[1] - passb[0]) ** 2 / (4.0 * new_freq**2) + passb[1] * passb[0]
        )
        wn = np.array([nat0, passb[0] * passb[1] / nat0])
    return n, _wn_back(wn, analog, fs)


# ── classic biquads ──────────────────────────────────────────────────────────


def _biquad_notch_peak(w0: float, Q: float, fs: float, peak: bool):
    if fs <= 0 or Q <= 0:
        raise ValueError("fs and Q must be positive")
    w = 2.0 * np.pi * w0 / fs
    if not 0.0 < w < np.pi:
        raise ValueError("w0 must lie strictly inside (0, fs/2)")
    bw = w / Q
    gb = 1.0 / np.sqrt(2.0)
    if peak:
        gb = np.sqrt(1.0 - gb * gb)  # complementary: |H| = gb at band edges
    beta = (np.sqrt(1.0 - gb * gb) / gb) * np.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if peak:
        b = np.array([1.0 - gain, 0.0, -(1.0 - gain)])
    else:
        b = gain * np.array([1.0, -2.0 * np.cos(w), 1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(w), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0: float, Q: float, fs: float = 2.0):
    """Second-order notch rejecting ``w0`` (``scipy.signal.iirnotch``)."""
    return _biquad_notch_peak(w0, Q, fs, peak=False)


def iirpeak(w0: float, Q: float, fs: float = 2.0):
    """Second-order resonator passing ``w0`` (``scipy.signal.iirpeak``)."""
    return _biquad_notch_peak(w0, Q, fs, peak=True)


# ── public prototype / transform aliases (scipy parity surface) ──────────────
# scipy exposes its analog prototypes and lowpass transforms as public
# functions; the math lives in the privates above, these are the stable
# scipy-named fronts.


def buttap(N: int):
    """Butterworth analog lowpass prototype (``scipy.signal.buttap``)."""
    return _buttap(int(N))


def cheb1ap(N: int, rp: float):
    """Chebyshev-I analog prototype (``scipy.signal.cheb1ap``)."""
    return _cheb1ap(int(N), rp)


def cheb2ap(N: int, rs: float):
    """Chebyshev-II analog prototype (``scipy.signal.cheb2ap``)."""
    return _cheb2ap(int(N), rs)


def ellipap(N: int, rp: float, rs: float):
    """Elliptic analog prototype (``scipy.signal.ellipap``)."""
    return _ellipap(int(N), rp, rs)


def besselap(N: int, norm: str = "phase"):
    """Bessel analog prototype (``scipy.signal.besselap``)."""
    return _besselap(int(N), norm=norm)


def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass→lowpass zpk transform (``scipy.signal.lp2lp_zpk``)."""
    return _lp2lp(np.atleast_1d(np.asarray(z, complex)),
                  np.atleast_1d(np.asarray(p, complex)), float(k), float(wo))


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass→highpass zpk transform (``scipy.signal.lp2hp_zpk``)."""
    return _lp2hp(np.atleast_1d(np.asarray(z, complex)),
                  np.atleast_1d(np.asarray(p, complex)), float(k), float(wo))


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandpass zpk transform (``scipy.signal.lp2bp_zpk``)."""
    return _lp2bp(np.atleast_1d(np.asarray(z, complex)),
                  np.atleast_1d(np.asarray(p, complex)), float(k), float(wo), float(bw))


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandstop zpk transform (``scipy.signal.lp2bs_zpk``)."""
    return _lp2bs(np.atleast_1d(np.asarray(z, complex)),
                  np.atleast_1d(np.asarray(p, complex)), float(k), float(wo), float(bw))


def _tf_via_zpk(transform, b, a, *args):
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*transform(z, p, k, *args))


def lp2lp(b, a, wo: float = 1.0):
    """ba-form lowpass→lowpass (``scipy.signal.lp2lp``)."""
    return _tf_via_zpk(_lp2lp, b, a, float(wo))


def lp2hp(b, a, wo: float = 1.0):
    """ba-form lowpass→highpass (``scipy.signal.lp2hp``)."""
    return _tf_via_zpk(_lp2hp, b, a, float(wo))


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """ba-form lowpass→bandpass (``scipy.signal.lp2bp``)."""
    return _tf_via_zpk(_lp2bp, b, a, float(wo), float(bw))


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """ba-form lowpass→bandstop (``scipy.signal.lp2bs``)."""
    return _tf_via_zpk(_lp2bs, b, a, float(wo), float(bw))


def bilinear_zpk(z, p, k, fs: float):
    """Bilinear s→z transform on zpk (``scipy.signal.bilinear_zpk``).
    Tustin map z = (2fs + s)/(2fs - s); degree deficit becomes zeros at −1."""
    return _bilinear_zpk(np.atleast_1d(np.asarray(z, complex)),
                         np.atleast_1d(np.asarray(p, complex)), float(k), float(fs))


# ── analog frequency response ────────────────────────────────────────────────


def findfreqs(num, den, N: int, kind: str = "ba"):
    """Pick ``N`` log-spaced analog frequencies spanning the interesting
    range of a rational response (``scipy.signal.findfreqs`` heuristic:
    bracket the pole/zero cluster by ~half a decade each side)."""
    if kind == "ba":
        poles = np.atleast_1d(np.roots(np.atleast_1d(den))).astype(complex)
        zeros = np.atleast_1d(np.roots(np.atleast_1d(num))).astype(complex)
    elif kind == "zp":
        zeros = np.atleast_1d(np.asarray(num, complex))
        poles = np.atleast_1d(np.asarray(den, complex))
    else:
        raise ValueError(f"kind must be 'ba' or 'zp', got {kind!r}")
    if poles.size == 0:
        poles = np.array([-1000.0 + 0j])
    feats = np.concatenate([
        poles[poles.imag >= 0],
        zeros[(np.abs(zeros) < 1e5) & (zeros.imag >= 0)],
    ])
    at_origin = (np.abs(feats) < 1e-10).astype(float)
    hi = np.around(np.log10(np.max(3.0 * np.abs(feats.real + at_origin)
                                   + 1.5 * feats.imag)) + 0.5)
    lo = np.around(np.log10(0.1 * np.min(np.abs((feats + at_origin).real)
                                         + 2.0 * feats.imag)) - 0.5)
    return np.logspace(lo, hi, int(N))


def freqs(b, a, worN=200, plot=None):
    """Analog filter frequency response H(jw) (``scipy.signal.freqs``)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if np.ndim(worN) == 0:
        w = findfreqs(b, a, int(worN))
    else:
        w = np.asarray(worN, dtype=np.float64)
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    if plot is not None:
        plot(w, h)
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog zpk frequency response (``scipy.signal.freqs_zpk``)."""
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if np.ndim(worN) == 0:
        w = findfreqs(z, p, int(worN), kind="zp")
    else:
        w = np.asarray(worN, dtype=np.float64)
    s = 1j * w
    num = np.prod(s[:, None] - z[None, :], axis=1) if z.size else np.ones_like(s)
    den = np.prod(s[:, None] - p[None, :], axis=1) if p.size else np.ones_like(s)
    return w, k * num / den


# ── spec-driven front end ────────────────────────────────────────────────────

_ORD_FNS = {}  # populated below once the *ord functions exist


def iirdesign(wp, ws, gpass: float, gstop: float, analog: bool = False,
              ftype: str = "ellip", output: str = "ba", fs=None):
    """Design by band spec (``scipy.signal.iirdesign``): pick the minimum
    order with the family's *ord rule, then design at that order.  The
    ripple arguments feed straight through as rp/rs where the family
    uses them."""
    key = {"butter": "butter", "cheby1": "cheby1", "cheby2": "cheby2",
           "ellip": "ellip", "elliptic": "ellip"}.get(ftype)
    if key is None:
        raise ValueError(
            f"iirdesign supports butter|cheby1|cheby2|ellip, got {ftype!r}")
    ordfn = _ORD_FNS[key]
    N, Wn = ordfn(wp, ws, gpass, gstop, analog=analog, fs=fs)
    btype = _infer_btype(wp, ws)
    return iirfilter(N, Wn, rp=gpass, rs=gstop, btype=btype, analog=analog,
                     ftype=key, output=output, fs=fs)


def _infer_btype(wp, ws) -> str:
    wp = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if wp.shape[0] == 1:
        return "lowpass" if wp[0] < ws[0] else "highpass"
    return "bandpass" if wp[0] > ws[0] else "bandstop"


_ORD_FNS.update(butter=buttord, cheby1=cheb1ord, cheby2=cheb2ord, ellip=ellipord)


def band_stop_obj(wp, ind, passb, stopb, gpass, gstop, type):
    """Band-stop order objective (``scipy.signal.band_stop_obj``): the
    filter order required when passband edge ``ind`` is moved to ``wp`` —
    the function the *ord routines minimize over the bandstop edges."""
    passb = np.asarray(passb, dtype=np.float64).copy()
    passb[int(ind)] = float(wp)
    nat = float(np.min(np.abs(stopb * (passb[0] - passb[1])
                              / (stopb ** 2 - passb[0] * passb[1]))))
    gp = 10.0 ** (0.1 * abs(gpass))
    gs = 10.0 ** (0.1 * abs(gstop))
    if type == "butter":
        return np.log10((gs - 1.0) / (gp - 1.0)) / (2.0 * np.log10(nat))
    if type in ("cheby", "cheby1", "cheby2"):
        return float(np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0))) / np.arccosh(nat))
    if type == "ellip":
        return _ellip_order(nat, gp, gs)
    raise ValueError(f"type must be butter|cheby|ellip, got {type!r}")
