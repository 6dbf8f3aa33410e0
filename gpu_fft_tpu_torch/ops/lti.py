"""LTI system toolkit: representations, simulation, discretization.

Port of ``gpu_fft_tpu/ops/lti.py``: a copy of that pure-numpy f64 module
(only this docstring differs).  scipy.signal's linear-time-invariant system
family — the ``lti``/``dlti`` classes, ``lsim``/``impulse``/``step``/``bode``,
the discrete counterparts, ``cont2discrete``, state-space conversions, pole
placement and partial fractions — as host-side one-time work; running a
system on the device is ``ops/iir.py:lfilter_device``.  No scipy at
runtime: the matrix exponential is a self-contained scaling-and-squaring
Padé(13).
"""

from __future__ import annotations

import numpy as np

from .design import normalize, tf2zpk, zpk2tf

__all__ = [
    "lti",
    "dlti",
    "TransferFunction",
    "ZerosPolesGain",
    "StateSpace",
    "lsim",
    "impulse",
    "step",
    "freqresp",
    "bode",
    "dlsim",
    "dimpulse",
    "dstep",
    "dfreqresp",
    "dbode",
    "cont2discrete",
    "tf2ss",
    "ss2tf",
    "zpk2ss",
    "ss2zpk",
    "abcd_normalize",
    "place_poles",
    "expm",
    "residue",
    "residuez",
    "invres",
    "invresz",
    "unique_roots",
]


# ── matrix exponential (Padé 13 + scaling-squaring) ──────────────────────────

_PADE13 = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
           1187353796428800.0, 129060195264000.0, 10559470521600.0,
           670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
           960960.0, 16380.0, 182.0, 1.0)


def expm(A: np.ndarray) -> np.ndarray:
    """Matrix exponential e^A by scaling-and-squaring with the [13/13]
    Padé approximant (the classic Higham recipe on f64)."""
    A = np.asarray(A, dtype=complex if np.iscomplexobj(A) else np.float64)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("expm needs a square matrix")
    n = A.shape[0]
    if n == 0:
        return np.zeros((0, 0))
    norm = np.linalg.norm(A, 1)
    # scale so ||A/2^s|| is under the Padé-13 accuracy radius (~5.37)
    s = max(0, int(np.ceil(np.log2(norm / 5.371920351148152))) if norm > 0 else 0)
    As = A / (2.0 ** s)
    b = _PADE13
    eye = np.eye(n, dtype=As.dtype)
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U = As @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
              + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    F = np.linalg.solve(V - U, V + U)
    for _ in range(s):
        F = F @ F
    return F


# ── state-space conversions ──────────────────────────────────────────────────


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in compatible zero matrices for missing state-space parts and
    check shape consistency (``scipy.signal.abcd_normalize``)."""
    mats = {k: (np.atleast_2d(np.asarray(v, dtype=np.float64)) if v is not None else None)
            for k, v in dict(A=A, B=B, C=C, D=D).items()}
    A_, B_, C_, D_ = mats["A"], mats["B"], mats["C"], mats["D"]
    n = (A_.shape[0] if A_ is not None else
         B_.shape[0] if B_ is not None else
         C_.shape[1] if C_ is not None else None)
    m = (B_.shape[1] if B_ is not None else
         D_.shape[1] if D_ is not None else None)
    p = (C_.shape[0] if C_ is not None else
         D_.shape[0] if D_ is not None else None)
    if n is None or m is None or p is None:
        raise ValueError("not enough information to determine system shapes")
    A_ = np.zeros((n, n)) if A_ is None else A_
    B_ = np.zeros((n, m)) if B_ is None else B_
    C_ = np.zeros((p, n)) if C_ is None else C_
    D_ = np.zeros((p, m)) if D_ is None else D_
    if A_.shape != (n, n) or B_.shape != (n, m) or C_.shape != (p, n) or D_.shape != (p, m):
        raise ValueError(f"inconsistent state-space shapes: A{A_.shape} B{B_.shape} "
                         f"C{C_.shape} D{D_.shape}")
    return A_, B_, C_, D_


def tf2ss(num, den):
    """Transfer function → controller-canonical state space
    (``scipy.signal.tf2ss``): companion A from the monic denominator,
    C from the padded numerator rows."""
    num = np.atleast_2d(np.asarray(num, dtype=np.float64))
    den = np.atleast_1d(np.asarray(den, dtype=np.float64))
    if num.shape[-1] > den.size:
        raise ValueError("improper transfer function: len(num) > len(den)")
    num = num / den[0]
    den = den / den[0]
    k = den.size - 1
    if k == 0:
        return (np.zeros((0, 0)), np.zeros((0, 1)),
                np.zeros((num.shape[0], 0)), num.copy())
    num = np.hstack([np.zeros((num.shape[0], den.size - num.shape[-1])), num])
    A = np.vstack([-den[1:], np.eye(k - 1, k)])
    B = np.eye(k, 1)
    C = num[:, 1:] - np.outer(num[:, 0], den[1:])
    D = num[:, :1].copy()
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space → transfer function (``scipy.signal.ss2tf``):
    den = char. poly of A; per-output num via the rank-one identity
    det(sI − A + b cᵀ) = den(s) + c adj(sI−A) b."""
    A, B, C, D = abcd_normalize(A, B, C, D)
    if B.shape[1] == 0:
        if input != 0:
            raise ValueError("input out of range")
        den = np.atleast_1d(np.poly(A)) if A.size else np.ones(1)
        return D.copy(), den
    if not 0 <= input < B.shape[1]:
        raise ValueError(f"input must be in [0, {B.shape[1]}), got {input}")
    b = B[:, input:input + 1]
    d = D[:, input:input + 1]
    den = np.atleast_1d(np.poly(A)) if A.size else np.ones(1)
    if A.size == 0:
        return d.copy(), den
    nout = C.shape[0]
    num = np.empty((nout, den.size))
    for i in range(nout):
        Ci = C[i:i + 1, :]
        num[i] = np.poly(A - b @ Ci) + (d[i, 0] - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """zpk → state space (``scipy.signal.zpk2ss``)."""
    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(A, B, C, D, input: int = 0):
    """State space → zpk (``scipy.signal.ss2zpk``); single-output systems
    (the zpk form is inherently SISO per input)."""
    num, den = ss2tf(A, B, C, D, input=input)
    num = np.atleast_2d(num)
    if num.shape[0] != 1:
        raise ValueError("ss2zpk needs a single-output system")
    return tf2zpk(num[0], den)


# ── discretization ───────────────────────────────────────────────────────────


def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Continuous → discrete system (``scipy.signal.cont2discrete``):
    gbt (generalized bilinear, with euler / backward_diff / bilinear as
    fixed-alpha cases), zoh and foh via one augmented ``expm``, and the
    impulse-invariant map.  tf/zpk inputs round-trip through state space
    exactly as scipy does."""
    if len(system) == 2:
        a, b, c, d = tf2ss(*system)
        ad, bd, cd, dd, _ = cont2discrete((a, b, c, d), dt, method, alpha)
        num, den = ss2tf(ad, bd, cd, dd)
        return num, den, dt  # num stays 2-D, scipy's ss2tf convention
    if len(system) == 3:
        a, b, c, d = zpk2ss(*system)
        ad, bd, cd, dd, _ = cont2discrete((a, b, c, d), dt, method, alpha)
        z, p, k = ss2zpk(ad, bd, cd, dd)
        return z, p, k, dt
    if len(system) != 4:
        raise ValueError("system must be (num, den), (z, p, k) or (A, B, C, D)")
    a, b, c, d = (np.atleast_2d(np.asarray(m, dtype=np.float64)) for m in system)
    n = a.shape[0]
    m = b.shape[1]
    if method == "gbt":
        if alpha is None or not 0 <= alpha <= 1:
            raise ValueError("gbt requires alpha in [0, 1]")
    elif method in ("bilinear", "tustin"):
        method, alpha = "gbt", 0.5
    elif method == "euler":
        method, alpha = "gbt", 0.0
    elif method == "backward_diff":
        method, alpha = "gbt", 1.0
    if method == "gbt":
        ima = np.eye(n) - alpha * dt * a
        ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * a)
        bd = np.linalg.solve(ima, dt * b)
        cd = np.linalg.solve(ima.T, c.T).T
        dd = d + alpha * (c @ bd)
    elif method == "zoh":
        em = np.zeros((n + m, n + m))
        em[:n, :n] = a * dt
        em[:n, n:] = b * dt
        ms = expm(em)
        ad, bd = ms[:n, :n], ms[:n, n:]
        cd, dd = c.copy(), d.copy()
    elif method == "foh":
        # triangle (first-order) hold: one expm of the twice-augmented matrix
        em = np.zeros((n + 2 * m, n + 2 * m))
        em[:n, :n] = a * dt
        em[:n, n:n + m] = b * dt
        em[n:n + m, n + m:] = np.eye(m)
        ms = expm(em)
        phi = ms[:n, :n]
        g1 = ms[:n, n:n + m]
        g2 = ms[:n, n + m:]
        ad = phi
        bd = g1 + phi @ g2 - g2
        cd = c.copy()
        dd = d + c @ g2
    elif method == "impulse":
        if not np.allclose(d, 0):
            raise ValueError("impulse method is only applicable to strictly proper systems")
        ad = expm(a * dt)
        bd = ad @ b * dt
        cd = c.copy()
        dd = c @ b * dt
    else:
        raise ValueError(f"unknown discretization method {method!r}")
    return ad, bd, cd, dd, dt


# ── continuous simulation ────────────────────────────────────────────────────


def _default_response_times(A: np.ndarray, n: int) -> np.ndarray:
    """scipy's heuristic grid: 7 time constants of the slowest stable mode."""
    ev = np.linalg.eigvals(A) if A.size else np.array([-1.0])
    r = np.min(np.abs(np.real(ev)))
    if r == 0.0:
        r = 1.0
    tc = 1.0 / r
    return np.linspace(0.0, 7.0 * tc, n)


def _as_ss(system):
    if isinstance(system, LinearTimeInvariant):
        s = system.to_ss()
        return s.A, s.B, s.C, s.D
    if len(system) == 2:
        return tf2ss(*system)
    if len(system) == 3:
        return zpk2ss(*system)
    if len(system) == 4:
        return abcd_normalize(*system)
    raise ValueError("system must be an lti object or a 2/3/4-tuple")


def lsim(system, U, T, X0=None, interp: bool = True):
    """Simulate continuous output over a regular time grid
    (``scipy.signal.lsim``): exact per-step propagation by one augmented
    matrix exponential — first-order-hold between input samples when
    ``interp`` (scipy default), zero-order hold otherwise."""
    A, B, C, D = _as_ss(system)
    T = np.asarray(T, dtype=np.float64)
    if T.ndim != 1 or T.size < 2:
        raise ValueError("T must be 1-D with at least 2 points")
    dt = T[1] - T[0]
    if not np.allclose(np.diff(T), dt):
        raise ValueError("T must be regularly spaced")
    n = A.shape[0]
    m = B.shape[1]
    steps = T.size
    x = np.zeros(n) if X0 is None else np.asarray(X0, dtype=np.float64).reshape(n)
    if U is None:
        U = np.zeros((steps, m))
    U = np.asarray(U, dtype=np.float64)
    if U.ndim == 1:
        U = U[:, None]
    if U.shape != (steps, m):
        raise ValueError(f"U must have shape ({steps}, {m})")
    if n == 0:
        yout = U @ D.T
        return T, np.squeeze(yout), np.zeros((steps, 0))
    if interp:
        em = np.zeros((n + 2 * m, n + 2 * m))
        em[:n, :n] = A * dt
        em[:n, n:n + m] = B * dt
        em[n:n + m, n + m:] = np.eye(m)
        ms = expm(em)
        Ad = ms[:n, :n]
        g1 = ms[:n, n:n + m]
        g2 = ms[:n, n + m:]
        Bd1 = g2          # weight of u[i+1] under the linear-ramp input
        Bd0 = g1 - g2     # weight of u[i]
    else:
        em = np.zeros((n + m, n + m))
        em[:n, :n] = A * dt
        em[:n, n:] = B * dt
        ms = expm(em)
        Ad = ms[:n, :n]
        Bd0 = ms[:n, n:]
        Bd1 = np.zeros((n, m))
    xout = np.empty((steps, n))
    xout[0] = x
    for i in range(steps - 1):
        x = Ad @ x + Bd0 @ U[i] + Bd1 @ U[i + 1]
        xout[i + 1] = x
    yout = xout @ C.T + U @ D.T
    return T, np.squeeze(yout), xout


def impulse(system, X0=None, T=None, N: int | None = None):
    """Continuous impulse response (``scipy.signal.impulse``): homogeneous
    response from x(0) = B (+X0)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_response_times(A, N or 100)
    else:
        T = np.asarray(T, dtype=np.float64)
    x0 = B.ravel() + (0.0 if X0 is None else np.asarray(X0, dtype=np.float64).ravel())
    _, y, _ = lsim((A, B, C, np.zeros_like(D)), None, T, X0=x0)
    return T, y


def step(system, X0=None, T=None, N: int | None = None):
    """Continuous step response (``scipy.signal.step``)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_response_times(A, N or 100)
    else:
        T = np.asarray(T, dtype=np.float64)
    U = np.ones((T.size, B.shape[1]))
    _, y, _ = lsim((A, B, C, D), U, T, X0=X0)
    return T, y


def freqresp(system, w=None, n: int = 10000):
    """Continuous frequency response H(jw) (``scipy.signal.freqresp``)."""
    from .design import freqs_zpk

    if isinstance(system, LinearTimeInvariant):
        sys_zpk = system.to_zpk()
        z, p, k = sys_zpk.zeros, sys_zpk.poles, sys_zpk.gain
    elif len(system) == 2:
        z, p, k = tf2zpk(*system)
    elif len(system) == 3:
        z, p, k = system
    else:
        z, p, k = ss2zpk(*system)
    if w is not None:
        w = np.asarray(w, dtype=np.float64)
        return freqs_zpk(z, p, k, worN=w)
    return freqs_zpk(z, p, k, worN=n)


def bode(system, w=None, n: int = 100):
    """Continuous Bode data: (w, magnitude dB, phase deg)
    (``scipy.signal.bode``)."""
    w, h = freqresp(system, w=w, n=n)
    return w, 20.0 * np.log10(np.abs(h)), np.degrees(np.unwrap(np.angle(h)))


# ── discrete simulation ──────────────────────────────────────────────────────


def _as_dss(system):
    if isinstance(system, LinearTimeInvariant):
        if system.dt is None:
            raise ValueError("system must be discrete (have a dt)")
        s = system.to_ss()
        return (s.A, s.B, s.C, s.D), s.dt
    dt = system[-1]
    core = system[:-1]
    return _as_ss(core), dt


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete system (``scipy.signal.dlsim``): the plain
    recurrence x_{k+1} = A x_k + B u_k.  Returns (t, y) for tf/zpk input
    and (t, y, x) when a state-space system is given, like scipy."""
    is_ss = (isinstance(system, StateSpace)
             or (not isinstance(system, LinearTimeInvariant) and len(system) == 5))
    (A, B, C, D), dt = _as_dss(system)
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    if u.ndim == 1:
        u = u[:, None]
    steps = u.shape[0] if t is None else int(np.floor(float(np.asarray(t).max()) / dt) + 1)
    tout = np.arange(steps) * dt
    n = A.shape[0]
    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).reshape(n)
    xout = np.empty((steps, n))
    yout = np.empty((steps, C.shape[0]))
    for i in range(steps):
        ui = u[min(i, u.shape[0] - 1)]
        xout[i] = x
        yout[i] = C @ x + D @ ui
        x = A @ x + B @ ui
    return (tout, yout, xout) if is_ss else (tout, yout)


def dimpulse(system, x0=None, t=None, n: int | None = None):
    """Discrete impulse response (``scipy.signal.dimpulse``)."""
    (A, B, C, D), dt = _as_dss(system)
    steps = n if n is not None else (len(np.atleast_1d(t)) if t is not None else 100)
    m = B.shape[1]
    yout = []
    for j in range(m):
        u = np.zeros((steps, m))
        u[0, j] = 1.0
        tout, y, _ = dlsim((A, B, C, D, dt), u, x0=x0)
        yout.append(y)
    return tout, tuple(yout)


def dstep(system, x0=None, t=None, n: int | None = None):
    """Discrete step response (``scipy.signal.dstep``)."""
    (A, B, C, D), dt = _as_dss(system)
    steps = n if n is not None else (len(np.atleast_1d(t)) if t is not None else 100)
    m = B.shape[1]
    yout = []
    for j in range(m):
        u = np.zeros((steps, m))
        u[:, j] = 1.0
        tout, y, _ = dlsim((A, B, C, D, dt), u, x0=x0)
        yout.append(y)
    return tout, tuple(yout)


def dfreqresp(system, w=None, n: int = 10000, whole: bool = False):
    """Discrete frequency response H(e^{jw·dt}) (``scipy.signal.dfreqresp``)."""
    if isinstance(system, LinearTimeInvariant):
        sys_tf = system.to_tf()
        num, den, dt = sys_tf.num, sys_tf.den, sys_tf.dt
    elif len(system) == 3:
        num, den, dt = system
    elif len(system) == 4:
        z, p, k, dt = system
        num, den = zpk2tf(z, p, k)
    else:
        A, B, C, D, dt = system
        num, den = ss2tf(A, B, C, D)
        num = np.squeeze(num)
    if w is None:
        lastpoint = 2.0 * np.pi if whole else np.pi
        w = np.linspace(0.0, lastpoint, n, endpoint=False)
    else:
        w = np.asarray(w, dtype=np.float64)
    zv = np.exp(1j * w)
    h = np.polyval(np.atleast_1d(num), zv) / np.polyval(np.atleast_1d(den), zv)
    return w, h  # rad/sample, scipy's dfreqresp convention


def dbode(system, w=None, n: int = 100):
    """Discrete Bode data (``scipy.signal.dbode``): rad/s frequencies
    (rad/sample scaled by 1/dt), magnitude dB, phase deg."""
    dt = (system.dt if isinstance(system, LinearTimeInvariant) else system[-1])
    w, h = dfreqresp(system, w=w, n=n)
    return w / dt, 20.0 * np.log10(np.abs(h)), np.degrees(np.unwrap(np.angle(h)))


# ── pole placement ───────────────────────────────────────────────────────────


class _Bunch(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30):
    """Full-state feedback gain K with eig(A − BK) = poles
    (``scipy.signal.place_poles`` API).  Eigenstructure assignment: each
    desired pole's closed-loop eigenvector is taken from the null space of
    [A − λI | B] (Kautsky–Nichols step; conjugate pairs realified), giving
    a valid — though not conditioning-optimized — real gain.  ``method``/
    ``rtol``/``maxiter`` are accepted for signature parity."""
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    B = np.atleast_2d(np.asarray(B, dtype=np.float64))
    poles = np.sort_complex(np.atleast_1d(np.asarray(poles, dtype=complex)))
    n = A.shape[0]
    if poles.size != n:
        raise ValueError(f"need exactly {n} poles, got {poles.size}")
    # controllability check
    ctrb = np.hstack([np.linalg.matrix_power(A, i) @ B for i in range(n)])
    if np.linalg.matrix_rank(ctrb) < n:
        raise ValueError("the pair (A, B) is not controllable")
    V = np.empty((n, n), dtype=complex)
    W = np.empty((B.shape[1], n), dtype=complex)
    i = 0
    while i < n:
        lam = poles[i]
        M = np.hstack([A - lam * np.eye(n), B])
        _, _, vh = np.linalg.svd(M)
        null = vh[-1].conj()  # [v; w] with (A-λ)v + Bw = 0
        v, wv = null[:n], null[n:]
        if np.linalg.norm(v) < 1e-12:
            raise ValueError(f"cannot place pole {lam}: degenerate direction")
        V[:, i], W[:, i] = v, wv
        if abs(lam.imag) > 1e-12:
            # conjugate partner occupies the next slot
            V[:, i + 1], W[:, i + 1] = v.conj(), wv.conj()
            i += 2
        else:
            i += 1
    K = np.real(-W @ np.linalg.inv(V))
    achieved = np.linalg.eigvals(A - B @ K)
    return _Bunch(gain_matrix=K,
                  computed_poles=np.sort_complex(achieved),
                  requested_poles=poles,
                  X=V, rtol=0.0, nb_iter=0)


# ── partial fractions ────────────────────────────────────────────────────────


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Cluster near-equal roots (``scipy.signal.unique_roots``): greedy
    tolerance grouping, representative chosen by ``rtype``."""
    pick = {"max": np.max, "maximum": np.max,
            "min": np.min, "minimum": np.min,
            "avg": np.mean, "mean": np.mean}.get(rtype)
    if pick is None:
        raise ValueError(f"rtype must be max|min|avg (or synonyms), got {rtype!r}")
    p = np.atleast_1d(np.asarray(p))
    uniq: list[complex] = []
    mult: list[int] = []
    used = np.zeros(p.size, dtype=bool)
    for i in range(p.size):
        if used[i]:
            continue
        group = [i]
        used[i] = True
        for j in range(i + 1, p.size):
            if not used[j] and abs(p[j] - p[i]) < tol:
                group.append(j)
                used[j] = True
        vals = p[group]
        rep = vals[np.argmax(vals.real)] if pick is np.max else (
            vals[np.argmin(vals.real)] if pick is np.min else np.mean(vals))
        uniq.append(rep)
        mult.append(len(group))
    return np.asarray(uniq), np.asarray(mult, dtype=np.intp)


def _taylor_at(poly: np.ndarray, x0: complex, order: int) -> np.ndarray:
    """First ``order`` Taylor coefficients of a polynomial (descending
    coeffs) about x0, via repeated synthetic division."""
    c = np.asarray(poly, dtype=complex).copy()
    out = np.empty(order, dtype=complex)
    for k in range(order):
        if c.size == 0:
            out[k:] = 0.0
            return out
        # synthetic division by (x - x0): quotient + remainder
        q = np.empty(max(c.size - 1, 0), dtype=complex)
        acc = 0.0 + 0.0j
        for i in range(c.size - 1):
            acc = c[i] + acc * x0
            q[i] = acc
        rem = (c[-1] + acc * x0) if c.size else 0.0
        out[k] = rem
        c = q
    return out


def _series_div(num: np.ndarray, den: np.ndarray, order: int) -> np.ndarray:
    """Power-series quotient coefficients of num/den to ``order`` terms
    (ascending), den[0] != 0."""
    q = np.empty(order, dtype=complex)
    for k in range(order):
        acc = num[k] if k < num.size else 0.0
        for j in range(1, k + 1):
            acc -= den[j] * q[k - j] if j < den.size else 0.0
        q[k] = acc / den[0]
    return q


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Continuous partial-fraction expansion (``scipy.signal.residue``):
    b/a = Σ r_ij/(s−p_i)^j + k(s).  Residues for an m-fold pole come from
    the truncated Taylor series of b(s)·(s−p)^m/a(s) at the pole (a
    power-series division — no numeric differentiation)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b, a = normalize(b, a)
    k = np.array([])
    if b.size >= a.size:
        k, b = np.polydiv(b, a)
    roots = np.roots(a) if a.size > 1 else np.array([])
    p_uniq, mults = unique_roots(roots, tol=tol, rtype=rtype)
    r = []
    p_full = []
    for iu, (pu, m) in enumerate(zip(p_uniq, mults)):
        # q(s) = a(s) / (s - pu)^m with the clustered root removed exactly:
        # rebuild from the OTHER unique roots to stay stable for m > 1.
        q = np.array([a[0]], dtype=complex)
        for iv, (pv, mv) in enumerate(zip(p_uniq, mults)):
            if iv == iu:
                continue
            for _ in range(mv):
                q = np.convolve(q, [1.0, -pv])
        bt = _taylor_at(b, pu, m)
        qt = _taylor_at(q, pu, m)
        series = _series_div(bt, qt, m)
        # series[j] multiplies (s-pu)^j; the residue of (s-pu)^(m-j) term
        for j in range(m):
            r.append(series[m - 1 - j])
            p_full.append(pu)
    return np.asarray(r), np.asarray(p_full), np.real_if_close(k)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Discrete partial-fraction expansion (``scipy.signal.residuez``):
    b(z)/a(z) in powers of z⁻¹ = Σ r_ij/(1−p_i z⁻¹)^j + Σ k_j z⁻ʲ."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    gain = a[0]
    b, a = b / gain, a / gain
    k = np.array([])
    if b.size >= a.size:
        # direct terms: division in ascending powers of z^-1
        k_rev, rem_rev = np.polydiv(b[::-1], a[::-1])
        k = k_rev[::-1]
        b = rem_rev[::-1]
    roots = np.roots(a) if a.size > 1 else np.array([])
    p_uniq, mults = unique_roots(roots, tol=tol, rtype=rtype)
    r = []
    p_full = []
    for iu, (pu, m) in enumerate(zip(p_uniq, mults)):
        # substitute w = z^-1: a(w) = prod over roots (1 - p w); expand the
        # numerator series of B(w)·(1 - pu w)^m / A(w) at w = 1/pu.
        q = np.array([1.0], dtype=complex)  # ascending in w
        for iv, (pv, mv) in enumerate(zip(p_uniq, mults)):
            if iv == iu:
                continue
            for _ in range(mv):
                q = np.convolve(q, [1.0, -pv])  # ascending: (1 - pv*w)
        w0 = 1.0 / pu
        Bw = b.astype(complex)  # b given in ascending powers of w already
        bt = _taylor_at(Bw[::-1], w0, m)      # _taylor_at wants descending
        qt = _taylor_at(q[::-1], w0, m)
        series = _series_div(bt, qt, m)
        # series[j] multiplies (w - w0)^j; rewrite (w - w0) = -(1/pu)(1 - pu w):
        # (w-w0)^j = (-1/pu)^j (1 - pu w)^j  →  coefficient of (1-pu w)^-(m-j)
        for j in range(m):
            coef = series[m - 1 - j] * (-w0) ** (m - 1 - j)
            r.append(coef)
            p_full.append(pu)
    return np.asarray(r), np.asarray(p_full), np.real_if_close(k)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residue` (``scipy.signal.invres``)."""
    r = np.atleast_1d(np.asarray(r, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    k = np.atleast_1d(np.asarray(k, dtype=np.float64)) if np.size(k) else np.array([])
    p_uniq, mults = unique_roots(p, tol=tol, rtype=rtype)
    a = np.array([1.0], dtype=complex)
    for pu, m in zip(p_uniq, mults):
        for _ in range(m):
            a = np.convolve(a, [1.0, -pu])
    b = np.zeros(1, dtype=complex)
    idx = 0
    for iu, (pu, m) in enumerate(zip(p_uniq, mults)):
        for j in range(1, m + 1):
            # term r/(s-pu)^j: numerator = a(s) / (s-pu)^j
            term = np.array([1.0], dtype=complex)
            for iv, (pv, mv) in enumerate(zip(p_uniq, mults)):
                power = mv - j if iv == iu else mv
                for _ in range(power):
                    term = np.convolve(term, [1.0, -pv])
            b = np.polyadd(b, r[idx] * term)
            idx += 1
    if k.size:
        b = np.polyadd(np.convolve(k, a), b)
    return np.real_if_close(b), np.real_if_close(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residuez` (``scipy.signal.invresz``)."""
    r = np.atleast_1d(np.asarray(r, dtype=complex))
    p = np.atleast_1d(np.asarray(p, dtype=complex))
    k = np.atleast_1d(np.asarray(k, dtype=np.float64)) if np.size(k) else np.array([])
    p_uniq, mults = unique_roots(p, tol=tol, rtype=rtype)
    a = np.array([1.0], dtype=complex)  # ascending in z^-1
    for pu, m in zip(p_uniq, mults):
        for _ in range(m):
            a = np.convolve(a, [1.0, -pu])
    b = np.zeros(1, dtype=complex)
    idx = 0
    for iu, (pu, m) in enumerate(zip(p_uniq, mults)):
        for j in range(1, m + 1):
            term = np.array([1.0], dtype=complex)
            for iv, (pv, mv) in enumerate(zip(p_uniq, mults)):
                power = mv - j if iv == iu else mv
                for _ in range(power):
                    term = np.convolve(term, [1.0, -pv])
            # align ascending-power sums: pad to len(a) - (j-1)? polyadd on
            # ascending arrays pads on the LEFT, so right-align manually.
            b = _add_ascending(b, r[idx] * term)
            idx += 1
    if k.size:
        b = _add_ascending(np.convolve(k, a), b)
    return np.real_if_close(b), np.real_if_close(a)


def _add_ascending(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    n = max(x.size, y.size)
    out = np.zeros(n, dtype=complex)
    out[:x.size] += x
    out[:y.size] += y
    return out


# ── class hierarchy ──────────────────────────────────────────────────────────


class LinearTimeInvariant:
    """Shared base of the lti/dlti representation classes."""

    def __init__(self, dt=None):
        self.dt = dt

    # response conveniences (continuous or discrete per self.dt)
    def impulse(self, X0=None, T=None, N=None):
        if self.dt is None:
            return impulse(self, X0=X0, T=T, N=N)
        t, y = dimpulse(self._dsys(), x0=X0, n=N)[:2]
        return t, y

    def step(self, X0=None, T=None, N=None):
        if self.dt is None:
            return step(self, X0=X0, T=T, N=N)
        t, y = dstep(self._dsys(), x0=X0, n=N)[:2]
        return t, y

    def output(self, U, T, X0=None):
        if self.dt is None:
            return lsim(self, U, T, X0=X0)
        return dlsim(self._dsys(), U, t=T, x0=X0)

    def freqresp(self, w=None, n=10000):
        if self.dt is None:
            return freqresp(self, w=w, n=n)
        return dfreqresp(self._dsys(), w=w, n=n)

    def bode(self, w=None, n=100):
        if self.dt is None:
            return bode(self, w=w, n=n)
        return dbode(self._dsys(), w=w, n=n)

    def _dsys(self):
        s = self.to_tf()
        return (np.atleast_1d(s.num), np.atleast_1d(s.den), s.dt)

    def to_discrete(self, dt, method="zoh", alpha=None):
        """Discretize, keeping this representation class (scipy behavior)."""
        if self.dt is not None:
            raise ValueError("system is already discrete")
        s = self.to_ss()
        ad, bd, cd, dd, _ = cont2discrete((s.A, s.B, s.C, s.D), dt, method, alpha)
        out = StateSpace(ad, bd, cd, dd, dt=dt)
        if isinstance(self, TransferFunction):
            return out.to_tf()
        if isinstance(self, ZerosPolesGain):
            return out.to_zpk()
        return out


class TransferFunction(LinearTimeInvariant):
    """Rational num/den system (``scipy.signal.TransferFunction``);
    continuous when ``dt`` is None, discrete otherwise."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], LinearTimeInvariant):
            other = system[0].to_tf()
            system, dt = (other.num, other.den), other.dt
        if len(system) != 2:
            raise ValueError("TransferFunction needs (num, den)")
        super().__init__(dt)
        num, den = normalize(np.atleast_1d(np.squeeze(system[0])),
                             np.atleast_1d(system[1]))
        self.num = np.atleast_1d(num)
        self.den = np.atleast_1d(den)

    @property
    def zeros(self):
        return tf2zpk(self.num, self.den)[0]

    @property
    def poles(self):
        return tf2zpk(self.num, self.den)[1]

    def to_tf(self):
        return self

    def to_zpk(self):
        return ZerosPolesGain(*tf2zpk(self.num, self.den), dt=self.dt)

    def to_ss(self):
        return StateSpace(*tf2ss(self.num, self.den), dt=self.dt)

    def __repr__(self):
        kind = "dt=%r" % self.dt if self.dt is not None else "continuous"
        return f"TransferFunction({self.num.tolist()}, {self.den.tolist()}, {kind})"


class ZerosPolesGain(LinearTimeInvariant):
    """zpk system (``scipy.signal.ZerosPolesGain``)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], LinearTimeInvariant):
            other = system[0].to_zpk()
            system, dt = (other.zeros, other.poles, other.gain), other.dt
        if len(system) != 3:
            raise ValueError("ZerosPolesGain needs (zeros, poles, gain)")
        super().__init__(dt)
        self.zeros = np.atleast_1d(np.asarray(system[0], dtype=complex))
        self.poles = np.atleast_1d(np.asarray(system[1], dtype=complex))
        self.gain = float(np.real(system[2]))

    def to_tf(self):
        return TransferFunction(*zpk2tf(self.zeros, self.poles, self.gain), dt=self.dt)

    def to_zpk(self):
        return self

    def to_ss(self):
        return StateSpace(*zpk2ss(self.zeros, self.poles, self.gain), dt=self.dt)

    def __repr__(self):
        kind = "dt=%r" % self.dt if self.dt is not None else "continuous"
        return (f"ZerosPolesGain({self.zeros.tolist()}, {self.poles.tolist()}, "
                f"{self.gain}, {kind})")


class StateSpace(LinearTimeInvariant):
    """A/B/C/D system (``scipy.signal.StateSpace``)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], LinearTimeInvariant):
            other = system[0].to_ss()
            system, dt = (other.A, other.B, other.C, other.D), other.dt
        if len(system) != 4:
            raise ValueError("StateSpace needs (A, B, C, D)")
        super().__init__(dt)
        self.A, self.B, self.C, self.D = abcd_normalize(*system)

    @property
    def zeros(self):
        return self.to_zpk().zeros

    @property
    def poles(self):
        return np.linalg.eigvals(self.A)

    def to_tf(self, input: int = 0):
        num, den = ss2tf(self.A, self.B, self.C, self.D, input=input)
        return TransferFunction(np.squeeze(num), den, dt=self.dt)

    def to_zpk(self, input: int = 0):
        return ZerosPolesGain(*ss2zpk(self.A, self.B, self.C, self.D, input=input),
                              dt=self.dt)

    def to_ss(self):
        return self

    def __repr__(self):
        kind = "dt=%r" % self.dt if self.dt is not None else "continuous"
        return f"StateSpace(A{self.A.shape}, B{self.B.shape}, C{self.C.shape}, D{self.D.shape}, {kind})"


def lti(*system):
    """Continuous-system factory (``scipy.signal.lti``): 2 args → tf,
    3 → zpk, 4 → state space."""
    if len(system) == 2:
        return TransferFunction(*system)
    if len(system) == 3:
        return ZerosPolesGain(*system)
    if len(system) == 4:
        return StateSpace(*system)
    raise ValueError("lti takes 2 (tf), 3 (zpk) or 4 (ss) arguments")


def dlti(*system, dt=True):
    """Discrete-system factory (``scipy.signal.dlti``); ``dt`` defaults to
    True (unspecified sampling interval), matching scipy."""
    if len(system) == 2:
        return TransferFunction(*system, dt=dt)
    if len(system) == 3:
        return ZerosPolesGain(*system, dt=dt)
    if len(system) == 4:
        return StateSpace(*system, dt=dt)
    raise ValueError("dlti takes 2 (tf), 3 (zpk) or 4 (ss) arguments")
