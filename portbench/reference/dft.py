"""Discrete Fourier transforms as explicit matrix products, in a chosen
precision.

``"float64"`` is the reference; ``"tf32"`` (float32 operands whose products
run on TF32 tensor cores) and ``"float32"`` (TF32 off) compute the same
arithmetic lower, and serve as the control.  Complex values travel as
split (real, imag) tensors, and every complex product is four real matrix
products, so the precision of each product is the one the matrix multiply
takes for that dtype.
"""

from __future__ import annotations

import contextlib
import math

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}

DIRECT_MAX = 512  # longest transform taken as one dense DFT matrix


@contextlib.contextmanager
def precision(name: str):
    """Set the matmul precision that ``name`` asks for; restore it after."""
    if name not in DTYPES:
        raise ValueError(f"unknown precision {name!r}; one of {sorted(DTYPES)}")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield DTYPES[name]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def twiddle(n: int, rows, cols, sign: int, dtype, device):
    """exp(sign * 2*pi*i * rows[:, None] * cols[None, :] / n) as (re, im),
    the exponent reduced mod n in integers first, the angle in float64."""
    k = (rows.to(torch.int64)[:, None] * cols.to(torch.int64)[None, :]) % n
    ang = k.to(torch.float64) * (sign * 2.0 * math.pi / n)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def dft_matrix(n: int, sign: int, dtype, device):
    idx = torch.arange(n, device=device)
    return twiddle(n, idx, idx, sign, dtype, device)


def _cmatmul_left(ar, ai, br, bi):
    """(a @ b) for split complex a (m, k) and b (..., k, p); ``bi`` may be None."""
    if bi is None:
        return ar @ br, ai @ br
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _cmatmul_right(ar, ai, br, bi):
    """(a @ b) for split complex a (..., m, k) and b (k, p); ``ai`` may be None."""
    if ai is None:
        return ar @ br, ar @ bi
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def dft_rows(xr, xi, sign: int = -1, dtype=torch.float64):
    """Unnormalized DFT of every row of the (R, n) split-complex ``xr + i xi``
    (``xi`` None for real rows), computed in ``dtype``.  n <= DIRECT_MAX is
    one dense product; longer n = n1 * n2 runs the four-step with dense
    DFT matrices: n1 columns of n2 ... in, twiddle, n2 out."""
    rows, n = xr.shape
    dev = xr.device
    xr = xr.to(dtype)
    xi = None if xi is None else xi.to(dtype)
    if n <= DIRECT_MAX:
        fr, fi = dft_matrix(n, sign, dtype, dev)  # symmetric
        return _cmatmul_right(xr, xi, fr, fi)
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 * n2 != n:
        raise ValueError(f"dft_rows needs a power-of-two length, got {n}")
    # A[r, j1, j2] = x[r, n2*j1 + j2]; B = F_n1 A over j1.
    ar = xr.reshape(rows, n1, n2)
    ai = None if xi is None else xi.reshape(rows, n1, n2)
    f1r, f1i = dft_matrix(n1, sign, dtype, dev)
    br, bi = _cmatmul_left(f1r, f1i, ar, ai)
    tr, ti = twiddle(n, torch.arange(n1, device=dev), torch.arange(n2, device=dev), sign, dtype, dev)
    cr, ci = br * tr - bi * ti, br * ti + bi * tr
    f2r, f2i = dft_matrix(n2, sign, dtype, dev)
    dr, di = _cmatmul_right(cr, ci, f2r, f2i)  # D[r, k1, k2] = X[r, k1 + n1*k2]
    return dr.transpose(1, 2).reshape(rows, n), di.transpose(1, 2).reshape(rows, n)


def rel_errors(pairs) -> dict:
    """The two numbers compared, over (got_r, got_i, want_r, want_i) blocks,
    in float64 (``got_i`` / ``want_i`` None for real values):

    - ``rel_err``: max |got - want| / max |want|, the widest gap;
    - ``rel_l2``: ||got - want||_2 / ||want||_2 over every value, the
      gap of the whole answer, which swings less from seed to seed.
    """
    num = den = sq_num = sq_den = 0.0
    for gr, gi, wr, wi in pairs:
        dr = gr.to(torch.float64) - wr
        d2 = dr * dr
        w2 = wr * wr
        if wi is not None:
            di = gi.to(torch.float64) - wi
            d2 = d2 + di * di
            w2 = w2 + wi * wi
        num = max(num, float(d2.max().sqrt()))
        den = max(den, float(w2.max().sqrt()))
        sq_num += float(d2.sum())
        sq_den += float(w2.sum())
    return {"rel_err": num / den, "rel_l2": (sq_num / sq_den) ** 0.5}
