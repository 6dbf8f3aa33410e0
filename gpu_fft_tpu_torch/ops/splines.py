"""B-spline coefficient filters — the ``scipy.signal`` spline family.

Port of ``gpu_fft_tpu/ops/splines.py``, the JAX package's pure-numpy module
with one change: every function that runs a recursion takes ``device=`` and
passes it to the port's ``ops/iir.lfilter`` (default ``"cuda"``).

``symiirorder1`` / ``symiirorder2`` are forward-backward IIR cascades with
MIRROR-SYMMETRIC boundary conditions: the initial filter states are closed-
form sums of the symmetric-extension impulse response against the signal
(half-sample mirror x[-k] = x[k-1]), truncated once the geometric envelope
falls below ``precision`` — scipy's semantics (weight tables, add-then-test
truncation, f32/f64 defaults 1e-6/1e-11, and the non-convergence
ValueError).

The recursions run on the block-state IIR engine (``ops/iir.py``: batched
FFT zero-state convolution and a state carry), so the 2-D transforms
(``cspline2d``/``qspline2d``) filter all rows, then all columns, as batches.
The boundary-condition sums are exact f64 host matvecs.
``cspline1d``/``qspline1d`` (+ ``_eval``), ``sepfir2d`` and
``spline_filter`` complete the surface.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "symiirorder1",
    "symiirorder2",
    "cspline1d",
    "qspline1d",
    "cspline1d_eval",
    "qspline1d_eval",
    "cspline2d",
    "qspline2d",
    "sepfir2d",
    "spline_filter",
]

_CONVERGENCE_MSG = "Sum to find symmetric boundary conditions did not converge."


def _default_precision(precision: float, dtype) -> float:
    """scipy's symiir default: 1e-6 for f32 inputs, 1e-11 for f64."""
    if 0.0 < precision < 1.0:
        return float(precision)
    return 1e-6 if dtype in (np.float32, np.complex64) else 1e-11


def _as_rows(x, name: str):
    x = np.asarray(x)
    if x.ndim > 2:
        raise ValueError("Input must be 1D or 2D")
    squeeze = x.ndim == 1
    rows = x[None, :] if squeeze else x
    if rows.shape[-1] < 2:
        raise ValueError(f"{name} needs at least 2 samples per row")
    return rows.astype(np.float64), squeeze


def _lfilter_rows(b, a, rows, zi, device):
    """Batched filter through the block-state engine on ``device`` (complex
    rows split into two real passes — the filter is real-linear)."""
    from .iir import lfilter

    if np.iscomplexobj(rows):
        yr, zr = lfilter(b, a, rows.real, zi=zi.real, device=device)
        yi, zi_ = lfilter(b, a, rows.imag, zi=zi.imag, device=device)
        return yr + 1j * yi
    y, _ = lfilter(b, a, rows, zi=zi, device=device)
    return y


def _symiir1_ic(rows: np.ndarray, z1: float, precision: float) -> np.ndarray:
    """Forward starting value y0 = x0 + z1 * sum_k z1^k x[k] (half-sample
    mirror), truncated add-then-test on |z1^(k+1)| < precision."""
    n = rows.shape[-1]
    az = abs(z1)
    # first k with |z1|^(k+1) < precision (the term still gets added)
    K = int(math.ceil(math.log(precision) / math.log(az))) if az > 0 else 0
    if K >= n:
        raise ValueError(_CONVERGENCE_MSG)
    pows = z1 ** np.arange(1, K + 2)
    return rows[:, 0] + rows[:, : K + 1] @ pows


def symiirorder1(signal, c0, z1, precision: float = -1.0, device=None):
    """Smoothing IIR of order 1 with mirror-symmetric boundaries
    (``scipy.signal.symiirorder1``): cs / ((1 - z1 z^-1)(1 - z1 z))
    applied as a forward pass then a time-reversed pass, both seeded with
    the symmetric-extension steady state."""
    x = np.asarray(signal)
    if abs(z1) >= 1:
        raise ValueError("|z1| must be less than 1.0")
    rows, squeeze = _as_rows(x, "symiirorder1")
    precision = _default_precision(precision, x.dtype.type)
    y0 = _symiir1_ic(rows, z1, precision)

    a = np.array([1.0, -z1])
    y1 = _lfilter_rows(np.ones(1), a, rows[:, 1:], zi=(y0 * z1)[:, None], device=device)
    y1 = np.concatenate([y0[:, None], y1], axis=-1)

    out_last = -c0 / (z1 - 1.0) * y1[:, -1]
    out = _lfilter_rows(np.array([c0]), a, y1[:, -2::-1],
                        zi=(out_last * z1)[:, None], device=device)
    out = np.concatenate([out[:, ::-1], out_last[:, None]], axis=-1)
    return out[0] if squeeze else out


def _hc(k, cs: float, r: float, omega: float):
    """Causal half of the order-2 symmetric impulse response."""
    k = np.asarray(k, dtype=np.float64)
    return np.where(k > -1,
                    cs / math.sin(omega) * r ** k * np.sin(omega * (k + 1)), 0.0)


def _hs(k, cs: float, r: float, omega: float):
    """Symmetric (anticausal-combined) order-2 impulse response."""
    k = np.asarray(k, dtype=np.float64)
    c0 = (cs * cs * (1 + r * r) / (1 - r * r)
          / (1 - 2 * r * r * math.cos(2 * omega) + r ** 4))
    gamma = (1 - r * r) / (1 + r * r) / math.tan(omega)
    ak = np.abs(k)
    return c0 * r ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _trunc_len(mags: np.ndarray, precision: float, limit: int) -> int:
    """scipy's add-then-test truncation: index of the first ``mags[k] <
    precision`` term (still included); raises if the sum would need more
    than ``limit`` terms."""
    small = np.nonzero(mags < precision)[0]
    if small.size == 0 or small[0] > limit:
        raise ValueError(_CONVERGENCE_MSG)
    return int(small[0])


def symiirorder2(input, r, omega, precision: float = -1.0, device=None):
    """Smoothing IIR of order 2 with mirror-symmetric boundaries
    (``scipy.signal.symiirorder2``): cs^2 / ((1 - a2 z^-1 - a3 z^-2)
    (1 - a2 z - a3 z^2)), a2 = 2 r cos(omega), a3 = -r^2."""
    x = np.asarray(input)
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    rows, squeeze = _as_rows(x, "symiirorder2")
    n = rows.shape[-1]
    precision = _default_precision(precision, x.dtype.type)

    rsq = r * r
    a2 = 2 * r * math.cos(omega)
    a3 = -rsq
    cs = 1 - 2 * r * math.cos(omega) + rsq
    b = np.array([cs])
    a = np.array([1.0, -a2, -a3])

    # ---- forward ICs: y0, y1 from the half-sample mirror extension
    # x~[-k] = x[k-1]; shared truncation loop over hc(k), add-then-test
    # |hc(k)| < precision (scipy's rule incl. its stop-at-zero-crossing
    # quirk — pinned by impulse probing at omega = pi/3)
    hk = _hc(np.arange(n + 2), cs, r, omega)
    kstop = _trunc_len(np.abs(hk), precision, n)  # y0 needs x[kstop-1]
    w0 = np.zeros(n)
    w0[: kstop] = hk[1 : kstop + 1]
    w0[0] += hk[0]
    y0 = rows @ w0
    w1 = np.zeros(n)
    if kstop >= 2:
        w1[: kstop - 1] = hk[2 : kstop + 1]
    w1[1] += hk[0]
    if kstop >= 1:
        w1[0] += hk[1]
    y1 = rows @ w1

    # DF2T state equivalent to previous outputs [y0, y1] (b1 = b2 = 0, so
    # the state depends on outputs only): zi = [a2*y1 + a3*y0, a3*y1]
    zi_f = np.stack([a2 * y1 + a3 * y0, a3 * y1], axis=-1)
    y_fwd = _lfilter_rows(b, a, rows[:, 2:], zi=zi_f, device=device)
    y_fwd = np.concatenate([y0[:, None], y1[:, None], y_fwd], axis=-1)

    # ---- backward ICs on the reversed signal, per-row truncation with
    # add-then-test on the SQUARED weight (scipy's bwd rule, pinned
    # empirically across (r, omega, precision) grids)
    hsv = _hs(np.arange(-1, n + 3, dtype=np.float64), cs, r, omega)
    rev = rows[:, ::-1]
    wb0 = hsv[1 : n + 1] + hsv[2 : n + 2]          # hs(k) + hs(k+1)
    wb1 = hsv[0 : n] + hsv[3 : n + 3]              # hs(k-1) + hs(k+2)
    k0 = _trunc_len(wb0 * wb0, precision, n - 1)
    k1 = _trunc_len(wb1 * wb1, precision, n - 1)
    b0 = rev[:, : k0 + 1] @ wb0[: k0 + 1]
    b1 = rev[:, : k1 + 1] @ wb1[: k1 + 1]
    zi_b = np.stack([a2 * b1 + a3 * b0, a3 * b1], axis=-1)
    y = _lfilter_rows(b, a, y_fwd[:, -3::-1], zi=zi_b, device=device)
    out = np.concatenate([y[:, ::-1], b1[:, None], b0[:, None]], axis=-1)
    return out[0] if squeeze else out


# --------------------------------------------------------- 1-D coefficients
def _mirror_sym_exact_ic(rows: np.ndarray, zi: float) -> np.ndarray:
    """Full-length (untruncated) forward IC sum_k zi^k x[k] — scipy's
    cspline1d/qspline1d variant of the boundary condition."""
    return rows @ (zi ** np.arange(rows.shape[-1], dtype=np.float64))


def _spline_coeff(rows: np.ndarray, zi: float, gain: float, device) -> np.ndarray:
    """Shared cubic/quadratic coefficient cascade: forward 1/(1 - zi z^-1),
    backward -zi/(1 - zi z), times ``gain``."""
    n = rows.shape[-1]
    if n == 1:
        yplus = rows[:, 0] + zi * _mirror_sym_exact_ic(rows, zi)
        # scipy's K == 1 early-return skips the x6/x8 gain — mirrored
        return (zi / (zi - 1.0)) * yplus[:, None]
    a = np.array([1.0, -zi])
    first = rows[:, 0] + zi * _mirror_sym_exact_ic(rows, zi)
    yplus = _lfilter_rows(np.ones(1), a, rows[:, 1:], zi=(zi * first)[:, None], device=device)
    yplus = np.concatenate([first[:, None], yplus], axis=-1)
    out_last = zi / (zi - 1.0) * yplus[:, -1]
    out = _lfilter_rows(np.array([-zi]), a, yplus[:, -2::-1],
                        zi=(zi * out_last)[:, None], device=device)
    out = np.concatenate([out[:, ::-1], out_last[:, None]], axis=-1)
    return gain * out


def _coeff_smooth(lam: float) -> tuple[float, float]:
    xi = 1 - 96 * lam + 24 * lam * math.sqrt(3 + 144 * lam)
    omega = math.atan2(math.sqrt(144 * lam - 1), math.sqrt(xi))
    rho = (24 * lam - 1 - math.sqrt(xi)) / (24 * lam)
    rho = rho * math.sqrt((48 * lam + 24 * lam * math.sqrt(3 + 144 * lam)) / xi)
    return rho, omega


def _cubic_smooth_coeff(rows: np.ndarray, lamb: float, device) -> np.ndarray:
    """Smoothing-spline coefficients: order-2 symmetric cascade seeded with
    the FULL hc/hs boundary sums (scipy's untruncated variant)."""
    rho, omega = _coeff_smooth(lamb)
    cs = 1 - 2 * rho * math.cos(omega) + rho * rho
    n = rows.shape[-1]
    k = np.arange(n, dtype=np.float64)
    a2, a3 = 2 * rho * math.cos(omega), -rho * rho
    b = np.array([cs])
    a = np.array([1.0, -a2, -a3])

    hc0 = _hc(0, cs, rho, omega)
    y0 = hc0 * rows[:, 0] + rows @ _hc(k + 1, cs, rho, omega)
    y1 = (hc0 * rows[:, 0] + _hc(1, cs, rho, omega) * rows[:, 1]
          + rows @ _hc(k + 2, cs, rho, omega))
    zi_f = np.stack([a2 * y1 + a3 * y0, a3 * y1], axis=-1)
    yp = _lfilter_rows(b, a, rows[:, 2:], zi=zi_f, device=device)
    yp = np.concatenate([y0[:, None], y1[:, None], yp], axis=-1)

    rev = rows[:, ::-1]
    b0 = rev @ (_hs(k, cs, rho, omega) + _hs(k + 1, cs, rho, omega))
    b1 = rev @ (_hs(k - 1, cs, rho, omega) + _hs(k + 2, cs, rho, omega))
    zi_b = np.stack([a2 * b1 + a3 * b0, a3 * b1], axis=-1)
    y = _lfilter_rows(b, a, yp[:, -3::-1], zi=zi_b, device=device)
    return np.concatenate([y[:, ::-1], b1[:, None], b0[:, None]], axis=-1)


def cspline1d(signal, lamb: float = 0.0, device=None):
    """Cubic-spline coefficients with mirror-symmetric boundaries
    (``scipy.signal.cspline1d``); ``lamb`` > 0 adds smoothing."""
    x = np.asarray(signal, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("signal must be 1-D")
    if lamb != 0.0:
        return _cubic_smooth_coeff(x[None, :], lamb, device)[0]
    return _spline_coeff(x[None, :], -2 + math.sqrt(3), 6.0, device)[0]


def qspline1d(signal, lamb: float = 0.0, device=None):
    """Quadratic-spline coefficients (``scipy.signal.qspline1d``)."""
    if lamb != 0.0:
        raise ValueError("Smoothing quadratic splines not supported yet.")
    x = np.asarray(signal, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("signal must be 1-D")
    return _spline_coeff(x[None, :], -3 + 2 * math.sqrt(2.0), 8.0, device)[0]


def _bspline3(x):
    """Centered cubic B-spline basis on [-2, 2]."""
    ax = np.abs(np.asarray(x, dtype=np.float64))
    return np.where(ax < 1, 2.0 / 3 - ax * ax + 0.5 * ax ** 3,
                    np.where(ax < 2, (2.0 - ax) ** 3 / 6.0, 0.0))


def _bspline2(x):
    """Centered quadratic B-spline basis on [-1.5, 1.5]."""
    ax = np.abs(np.asarray(x, dtype=np.float64))
    return np.where(ax < 0.5, 0.75 - ax * ax,
                    np.where(ax < 1.5, 0.5 * (ax - 1.5) ** 2, 0.0))


def _spline_eval(cj, newx, dx, x0, kernel, support: int, offset: float):
    cj = np.asarray(cj)
    if cj.size == 0:
        raise ValueError("Spline coefficients 'cj' must not be empty.")
    t = (np.asarray(newx, dtype=np.float64) - x0) / float(dx)
    res = np.zeros_like(t, dtype=cj.dtype)
    if res.size == 0:
        return res
    N = len(cj)
    low, high = t < 0, t > (N - 1)
    inside = ~(low | high)
    if low.any():
        res[low] = _spline_eval(cj, -t[low], 1.0, 0, kernel, support, offset)
    if high.any():
        res[high] = _spline_eval(cj, 2 * (N - 1) - t[high], 1.0, 0,
                                 kernel, support, offset)
    ti = t[inside]
    if ti.size:
        acc = np.zeros_like(ti, dtype=cj.dtype)
        jlower = np.floor(ti - offset).astype(int) + 1
        for i in range(support):
            thisj = jlower + i
            acc += cj[thisj.clip(0, N - 1)] * kernel(ti - thisj)
        res[inside] = acc
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """Evaluate a cubic-spline from its coefficients at ``newx``
    (``scipy.signal.cspline1d_eval``; mirror-symmetric extension)."""
    return _spline_eval(cj, newx, dx, x0, _bspline3, 4, 2.0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """Evaluate a quadratic-spline from its coefficients
    (``scipy.signal.qspline1d_eval``)."""
    return _spline_eval(cj, newx, dx, x0, _bspline2, 3, 1.5)


# ------------------------------------------------------------- 2-D transforms
def _apply_rows_then_cols(fn, image: np.ndarray) -> np.ndarray:
    out = fn(image)           # along the last axis, rows batched
    return fn(out.T).T        # along axis 0


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0, device=None):
    """2-D cubic-spline coefficient transform (``scipy.signal.cspline2d``):
    the separable symmetric IIR applied to all rows as ONE batched device
    filter, then to all columns."""
    x = np.asarray(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    if precision <= 0.0 or precision >= 1.0:
        precision = 1e-3 if x.dtype in (np.float32, np.complex64) else 1e-6
    if lamb <= 1.0 / 144.0:
        r = -2 + math.sqrt(3.0)
        fn = lambda im: symiirorder1(im, -r * 6.0, r, precision=precision, device=device)
        return _apply_rows_then_cols(fn, x.astype(np.float64))
    r, omega = _coeff_smooth(lamb)
    fn = lambda im: symiirorder2(im, r, omega, precision=precision, device=device)
    return _apply_rows_then_cols(fn, x.astype(np.float64))


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0, device=None):
    """2-D quadratic-spline coefficient transform
    (``scipy.signal.qspline2d``)."""
    x = np.asarray(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    if lamb > 0:
        raise ValueError("lambda must be negative or zero")
    if precision <= 0.0 or precision >= 1.0:
        precision = 1e-3 if x.dtype in (np.float32, np.complex64) else 1e-6
    r = -3 + 2 * math.sqrt(2.0)
    fn = lambda im: symiirorder1(im, -r * 8.0, r, precision=precision, device=device)
    return _apply_rows_then_cols(fn, x.astype(np.float64))


def sepfir2d(input, hrow, hcol):
    """Separable 2-D FIR with half-sample mirror boundaries
    (``scipy.signal.sepfir2d``): convolve every row with ``hrow`` and every
    column with ``hcol``; both filters must be odd-length."""
    x = np.asarray(input)
    hrow = np.asarray(hrow).ravel()
    hcol = np.asarray(hcol).ravel()
    if x.ndim != 2:
        raise ValueError("object of too small depth for desired array"
                         if x.ndim < 2 else "Input must be 2-D")
    if hrow.size % 2 == 0 or hcol.size % 2 == 0:
        raise ValueError("hrow and hcol must be odd length")

    from numpy.lib.stride_tricks import sliding_window_view

    def conv_axis(img, h, axis):
        m = h.size // 2
        if m == 0:
            return img * h[0]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (m, m)
        p = np.pad(img, pad, mode="symmetric")
        win = sliding_window_view(p, h.size, axis=axis)
        return win @ h[::-1]  # true convolution

    out = conv_axis(x.astype(np.result_type(x.dtype, hrow.dtype, np.float32)),
                    hrow, 1)
    return conv_axis(out, hcol, 0)


def spline_filter(Iin, lmbda: float = 5.0, device=None):
    """Smoothing-spline low-pass of a 2-D image
    (``scipy.signal.spline_filter``): cspline2d then the [1 4 1]/6
    reconstruction kernel in both axes.  Complex images are filtered in
    single precision — scipy's historic behavior (scipy/scipy#9209)."""
    Iin = np.asarray(Iin)
    if Iin.dtype.type not in (np.float32, np.float64, np.complex64,
                              np.complex128):
        raise TypeError(f"Invalid data type for Iin: {Iin.dtype}")
    intype = Iin.dtype
    hcol = np.array([1.0, 4.0, 1.0], dtype=np.float32) / 6.0
    if intype == np.complex128:
        Iin = Iin.astype(np.complex64)
    if np.iscomplexobj(Iin):
        ck = (cspline2d(Iin.real.astype(np.float32), lmbda, device=device)
              + 1j * cspline2d(Iin.imag.astype(np.float32), lmbda, device=device))
    else:
        ck = cspline2d(Iin, lmbda, device=device)
    out = sepfir2d(ck.real, hcol, hcol)
    if np.iscomplexobj(ck):
        out = out + 1j * sepfir2d(ck.imag, hcol, hcol)
    return out.astype(intype)
