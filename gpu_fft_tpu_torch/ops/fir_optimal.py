"""Optimal FIR design: least-squares (firls), equiripple Parks–McClellan
(remez), and the gammatone auditory filter.

Port of ``gpu_fft_tpu/ops/fir_optimal.py``: a copy of that pure-numpy f64
module.  Only this docstring and ``remez``'s default ``fs`` differ: 1.0,
scipy's (the JAX module's 2.0 designs another filter from the same band
edges; ``firls`` keeps 2.0, scipy's there).  Host-side one-time design work; the
filters run on the FFT path (``ops/filter.py``).  ``firls`` solves the
normal equations with Gauss–Legendre band integrals; ``remez`` is the
Chebyshev multiple-exchange on a dense cosine grid with barycentric error
evaluation, all four linear-phase types.
"""

from __future__ import annotations

import numpy as np

__all__ = ["firls", "remez", "gammatone"]


def _parse_bands(numtaps, bands, desired, weight, fs, pairs_desired):
    bands = np.asarray(bands, dtype=np.float64).ravel()
    if bands.size % 2 or bands.size < 2:
        raise ValueError("bands must be given as start/stop pairs")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > fs / 2:
        raise ValueError("bands must be nondecreasing within [0, fs/2]")
    nb = bands.size // 2
    desired = np.asarray(desired, dtype=np.float64)
    if pairs_desired:
        if desired.size != bands.size:
            raise ValueError("desired must give a value per band edge")
        desired = desired.reshape(nb, 2)
    else:
        if desired.size != nb:
            raise ValueError("desired must give one value per band")
    if weight is None:
        weight = np.ones(nb)
    weight = np.asarray(weight, dtype=np.float64)
    if weight.size != nb:
        raise ValueError("weight must give one value per band")
    return bands.reshape(nb, 2) / fs * 2.0, desired, weight  # edges in [0, 1]


def firls(numtaps: int, bands, desired, *, weight=None, fs: float = 2.0):
    """Least-squares linear-phase FIR (``scipy.signal.firls``): minimizes
    the weighted integrated squared error of the amplitude response against
    a piecewise-linear target.  ``numtaps`` must be odd (type I)."""
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd")
    bands, desired, weight = _parse_bands(numtaps, bands, desired, weight, fs, True)
    m = (numtaps - 1) // 2
    # Normal equations on the cosine basis A(f) = a0 + 2 Σ a_n cos(2π n f/2):
    # with x = f in [0,1] half-cycles, basis cos(π n x).
    # Gauss-Legendre per band is exact for these bandwidths at ~4·numtaps
    # nodes (integrand oscillates ≤ numtaps half-periods over [0,1]).
    nodes, wts = np.polynomial.legendre.leggauss(max(32, 4 * numtaps))
    q = np.zeros(2 * m + 1)
    b = np.zeros(m + 1)
    n_all = np.arange(2 * m + 1)
    n_half = np.arange(m + 1)
    for (f1, f2), (d1, d2), w in zip(bands, desired, weight):
        if f2 <= f1:
            continue
        x = 0.5 * (f2 - f1) * nodes + 0.5 * (f1 + f2)
        jac = 0.5 * (f2 - f1) * wts
        dvals = d1 + (d2 - d1) * (x - f1) / (f2 - f1)
        cosms = np.cos(np.pi * np.outer(n_all, x))
        q += w * cosms @ jac
        b += w * (np.cos(np.pi * np.outer(n_half, x)) * dvals) @ jac
    from numpy.lib import stride_tricks  # noqa: F401  (documentation anchor)

    Q = np.empty((m + 1, m + 1))
    for i in range(m + 1):
        Q[i] = 0.5 * (q[np.abs(i - n_half)] + q[i + n_half])
    a = np.linalg.solve(Q, b)
    return np.concatenate([a[:0:-1] * 0.5, [a[0]], a[1:] * 0.5])


# ── Parks–McClellan ──────────────────────────────────────────────────────────


def _pm_grid(edges, R: int, grid_density: int):
    """Dense frequency grid over the pass/stop bands (half-cycles in
    [0, 1]); every band edge is a grid point."""
    delf = 0.5 / (grid_density * R)
    grid = []
    band_of = []
    for i, (f1, f2) in enumerate(edges):
        npts = max(int(np.ceil((f2 - f1) / delf)), 1) + 1
        grid.append(np.linspace(f1, f2, npts))
        band_of.append(np.full(npts, i))
    return np.concatenate(grid), np.concatenate(band_of)


def remez(numtaps: int, bands, desired, *, weight=None, type: str = "bandpass",
          maxiter: int = 25, grid_density: int = 16, fs: float = 1.0):
    """Equiripple FIR via the Remez multiple exchange
    (``scipy.signal.remez``): finds the unique weighted-Chebyshev-optimal
    linear-phase filter.  ``type``: 'bandpass' (symmetric), 'differentiator'
    (antisymmetric, 1/f weighting), 'hilbert' (antisymmetric)."""
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    if type not in ("bandpass", "differentiator", "hilbert"):
        raise ValueError(f"type must be bandpass|differentiator|hilbert, got {type!r}")
    edges, desired, weight = _parse_bands(numtaps, bands, desired, weight, fs, False)
    symmetric = type == "bandpass"
    odd = numtaps % 2 == 1
    if symmetric:
        R = (numtaps - 1) // 2 + 1 if odd else numtaps // 2
    else:
        R = (numtaps - 1) // 2 if odd else numtaps // 2

    grid, band_of = _pm_grid(edges, R, grid_density)
    # keep Q(f) well-defined: nudge grid ends away from singular endpoints
    eps = 1e-8
    if not symmetric or not odd:
        grid = np.clip(grid, eps if not symmetric else 0.0,
                       1.0 - eps if (symmetric and not odd) or (not symmetric and odd) else 1.0)
    if not symmetric:
        grid = np.maximum(grid, eps)

    # desired / weight per grid point
    dband = desired[band_of]
    wband = weight[band_of]
    if type == "differentiator":
        # target is slope·f; relative-error weighting 1/f where target != 0
        fcyc = grid / 2.0  # cycles/sample
        D = dband * fcyc
        W = np.where(dband > 1e-12, wband / np.maximum(fcyc, 1e-12), wband)
    else:
        D = dband.astype(np.float64)
        W = wband.astype(np.float64)

    # Q(f) prefactor reduces every type to a plain cosine-polynomial fit
    if symmetric:
        Q = np.ones_like(grid) if odd else np.cos(np.pi * grid / 2.0)
    else:
        Q = np.sin(np.pi * grid) if odd else np.sin(np.pi * grid / 2.0)
    Dp = D / Q
    Wp = W * Q

    x = np.cos(np.pi * grid)  # Chebyshev abscissa
    ngrid = grid.size
    if R + 1 > ngrid:
        raise ValueError("grid too small; raise grid_density")
    ext = np.linspace(0, ngrid - 1, R + 1).round().astype(int)

    def solve_on(extremals):
        xe = x[extremals]
        # barycentric weights
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        gam = 1.0 / np.prod(diff, axis=1)
        sgn = (-1.0) ** np.arange(R + 1)
        delta = (gam @ Dp[extremals]) / (gam @ (sgn / Wp[extremals]))
        # polynomial values at the R+1 extremals (leave one out for interp)
        pe = Dp[extremals] - sgn * delta / Wp[extremals]
        return xe, gam, delta, pe

    last_ext = None
    for _ in range(maxiter):
        xe, gam, delta, pe = solve_on(ext)
        # barycentric interpolation of P over the whole grid (first R points)
        num = np.zeros(ngrid)
        den = np.zeros(ngrid)
        exact = np.full(ngrid, -1, dtype=int)
        # barycentric interpolation through the first R extremals
        xr = xe[:R]
        diff = xr[:, None] - xr[None, :]
        np.fill_diagonal(diff, 1.0)
        gr = 1.0 / np.prod(diff, axis=1)
        for k in range(R):
            dk = x - xr[k]
            hit = np.abs(dk) < 1e-14
            exact[hit] = k
            dk[hit] = np.inf  # handled by `exact`
            num += gr[k] * pe[k] / dk
            den += gr[k] / dk
        P = num / den
        P[exact >= 0] = pe[np.clip(exact[exact >= 0], 0, R - 1)]
        err = (Dp - P) * Wp

        # new extremal candidates: local |err| maxima + band edges
        cand = np.nonzero(
            (np.abs(err) >= np.abs(np.roll(err, 1)) - 1e-15)
            & (np.abs(err) >= np.abs(np.roll(err, -1)) - 1e-15))[0]
        # band boundaries between concatenated segments are always candidates
        seg_edges = np.nonzero(np.diff(band_of) != 0)[0]
        cand = np.unique(np.concatenate([cand, [0, ngrid - 1], seg_edges, seg_edges + 1]))
        # enforce alternation: walk candidates, keep the largest per sign run
        signs = np.sign(err[cand])
        keep = []
        i = 0
        while i < cand.size:
            j = i
            best = i
            while j < cand.size and signs[j] == signs[i]:
                if np.abs(err[cand[j]]) > np.abs(err[cand[best]]):
                    best = j
                j += 1
            keep.append(cand[best])
            i = j
        keep = list(keep)
        # textbook trimming: with one extremum too many, drop the smaller of
        # the two ends (keeps alternation); with two too many, drop the
        # adjacent pair whose larger |err| is smallest.
        while len(keep) > R + 1:
            if len(keep) == R + 2:
                if np.abs(err[keep[0]]) <= np.abs(err[keep[-1]]):
                    keep.pop(0)
                else:
                    keep.pop()
            else:
                pair_scores = [max(np.abs(err[keep[i]]), np.abs(err[keep[i + 1]]))
                               for i in range(len(keep) - 1)]
                i = int(np.argmin(pair_scores))
                del keep[i:i + 2]
        keep = np.asarray(keep, dtype=int)
        if keep.size < R + 1:
            extra = np.setdiff1d(np.argsort(np.abs(err))[::-1], keep)[: R + 1 - keep.size]
            keep = np.concatenate([keep, extra])
        ext_new = np.sort(keep)
        if last_ext is not None and np.array_equal(ext_new, last_ext):
            break
        last_ext = ext
        ext = ext_new

    xe, gam, delta, pe = solve_on(ext)
    xr = xe[:R]
    diff = xr[:, None] - xr[None, :]
    np.fill_diagonal(diff, 1.0)
    gr = 1.0 / np.prod(diff, axis=1)

    def eval_P(f):
        xx = np.cos(np.pi * f)
        out = np.empty_like(xx)
        num = np.zeros_like(xx)
        den = np.zeros_like(xx)
        exact = np.full(xx.shape, -1, dtype=int)
        for k in range(R):
            dk = xx - xr[k]
            hit = np.abs(dk) < 1e-14
            exact[hit] = k
            dk[hit] = np.inf
            num += gr[k] * pe[k] / dk
            den += gr[k] / dk
        out = num / den
        mask = exact >= 0
        out[mask] = pe[exact[mask]]
        return out

    # sample the amplitude response on the DFT bins and invert exactly
    n = numtaps
    fj = np.arange(n // 2 + 1) * (2.0 / n)  # half-cycles at DFT bins
    if symmetric:
        Qj = np.ones_like(fj) if odd else np.cos(np.pi * fj / 2.0)
    else:
        Qj = np.sin(np.pi * fj) if odd else np.sin(np.pi * fj / 2.0)
    Aj = eval_P(np.minimum(fj, 1.0)) * Qj
    # zero forced by the type's symmetry at the singular endpoint
    if symmetric and not odd:
        Aj[-1] = 0.0 if n % 2 == 0 and fj[-1] >= 1.0 else Aj[-1]
    ph = np.exp(-1j * np.pi * fj * (n - 1) / 2.0)
    if not symmetric:
        ph = ph * 1j  # antisymmetric filters carry the extra 90° phase
    H = Aj * ph
    Hfull = np.concatenate([H, np.conj(H[-2 if n % 2 == 0 else -1 : 0 : -1])])
    h = np.real(np.fft.ifft(Hfull))
    return h[:n]


def _hz_to_erb(hz: float) -> float:
    """Equivalent rectangular bandwidth, Slaney's constants (Hz):
    ERB = f/EarQ + minBW with EarQ = 9.26449, minBW = 24.7."""
    return hz / 9.26449 + 24.7


def gammatone(freq: float, ftype: str, order: int | None = None,
              numtaps: int | None = None, fs: float | None = None):
    """Gammatone auditory filter (``scipy.signal.gammatone``): FIR form is
    the sampled gammatone envelope t^{o-1} e^{-2πbt} cos(2πf t) (Slaney
    1993) gain-normalized at the center frequency; IIR form is Slaney's
    4th-order all-pole factorization.

    The IIR form is 8th order with poles near the unit circle — like any
    high-order ba filter it is ill-conditioned in f32; run it on device as
    ``sosfilt(tf2sos(b, a), x)``, not ``lfilter(b, a, x)``."""
    if fs is None:
        fs = 2.0
    fs = float(fs)
    freq = float(freq)
    if not 0 < freq < fs / 2:
        raise ValueError(f"freq must lie in (0, fs/2), got {freq}")
    if ftype == "fir":
        from math import factorial

        order = 4 if order is None else int(order)
        if not 0 < order <= 24:
            raise ValueError("order must be in (0, 24]")
        numtaps = max(int(fs * 0.015), 15) if numtaps is None else int(numtaps)
        t = np.arange(numtaps) / fs
        bw = 1.019 * _hz_to_erb(freq)
        b = t ** (order - 1) * np.exp(-2.0 * np.pi * bw * t) * np.cos(2.0 * np.pi * freq * t)
        scale = 2.0 * (2.0 * np.pi * bw) ** order / factorial(order - 1) / fs
        return b * scale, np.ones(1)
    if ftype != "iir":
        raise ValueError("ftype must be 'fir' or 'iir'")
    T = 1.0 / fs
    bw = 2.0 * np.pi * 1.019 * _hz_to_erb(freq)
    fr = 2.0 * np.pi * freq * T
    bwT = bw * T
    # normalizing gain: product of the four second-order section gains at fr
    g1 = -2.0 * np.exp(2j * fr) * T
    g2 = 2.0 * np.exp(-bwT + 1j * fr) * T
    s3 = np.sqrt(3.0 + 2.0 ** 1.5) * np.sin(fr)
    s4 = np.sqrt(3.0 - 2.0 ** 1.5) * np.sin(fr)
    g5 = np.exp(2j * fr)
    g = (g1 + g2 * (np.cos(fr) - s4)) * (g1 + g2 * (np.cos(fr) + s4)) \
        * (g1 + g2 * (np.cos(fr) - s3)) * (g1 + g2 * (np.cos(fr) + s3))
    g /= (-2.0 / np.exp(2.0 * bwT) - 2.0 * g5 + 2.0 * (1.0 + g5) / np.exp(bwT)) ** 4
    g = abs(g)
    b = np.empty(5)
    a = np.empty(9)
    cos1 = np.cos(fr)
    b[0] = T ** 4 / g
    b[1] = -4.0 * T ** 4 * cos1 / np.exp(bwT) / g
    b[2] = 6.0 * T ** 4 * np.cos(2 * fr) / np.exp(2 * bwT) / g
    b[3] = -4.0 * T ** 4 * np.cos(3 * fr) / np.exp(3 * bwT) / g
    b[4] = T ** 4 * np.cos(4 * fr) / np.exp(4 * bwT) / g
    a[0] = 1.0
    a[1] = -8.0 * cos1 / np.exp(bwT)
    a[2] = 4.0 * (4.0 + 3.0 * np.cos(2 * fr)) / np.exp(2 * bwT)
    a[3] = -8.0 * (6.0 * cos1 + np.cos(3 * fr)) / np.exp(3 * bwT)
    a[4] = 2.0 * (18.0 + 16.0 * np.cos(2 * fr) + np.cos(4 * fr)) / np.exp(4 * bwT)
    a[5] = -8.0 * (6.0 * cos1 + np.cos(3 * fr)) / np.exp(5 * bwT)
    a[6] = 4.0 * (4.0 + 3.0 * np.cos(2 * fr)) / np.exp(6 * bwT)
    a[7] = -8.0 * cos1 / np.exp(7 * bwT)
    a[8] = np.exp(-8.0 * bwT)
    return b, a
