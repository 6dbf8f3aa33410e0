"""Reference of ``matched_filter_device``: PyCBC's ``matched_filter_core``
worked out again from the segment and the templates, in blocks of rows:

    q̃[k] = conj(h̃[k]) s̃[k] / S[k] on [kmin, N/2), zero elsewhere below N,
    q = the unnormalised inverse DFT of q̃ (dft.dft_rows, sign +1),
    σ² = 4Δf Σ |h̃[k]|² / S[k] on [kmin, N/2),  ρ = q · 4Δf / √σ²,

over the valid window of samples (work/matched_filter.py:layout)."""

from __future__ import annotations

import torch

from ..work.matched_filter import layout
from .dft import dft_rows, precision, rel_errors

ROWS_PER_BLOCK = 4


def reference(x, params, prec: str = "float64"):
    """(re, im) of ρ's valid window for every template of the (T + 2, 2, h) ``x``."""
    lay = layout(x.shape, params)
    n = lay["n"]
    band = slice(lay["kmin"], n // 2)
    df = lay["delta_f"]
    out_r, out_i = [], []
    with precision(prec) as dtype:
        sr, si = x[0, 0, band].to(dtype), x[0, 1, band].to(dtype)
        w = 1.0 / x[1, 0, band].to(dtype)
        for r0 in range(2, x.shape[0], ROWS_PER_BLOCK):
            hr = x[r0:r0 + ROWS_PER_BLOCK, 0, band].to(dtype)
            hi = x[r0:r0 + ROWS_PER_BLOCK, 1, band].to(dtype)
            qr = torch.zeros((hr.shape[0], n), dtype=dtype, device=x.device)
            qi = torch.zeros_like(qr)
            qr[:, band] = (hr * sr + hi * si) * w
            qi[:, band] = (hr * si - hi * sr) * w
            sigmasq = 4.0 * df * ((hr * hr + hi * hi) * w).sum(dim=-1)
            yr, yi = dft_rows(qr, qi, +1, dtype)
            norm = (4.0 * df / sigmasq.sqrt())[:, None]
            out_r.append((yr[:, lay["start"]:lay["stop"]] * norm).to(torch.float64))
            out_i.append((yi[:, lay["start"]:lay["stop"]] * norm).to(torch.float64))
    return torch.cat(out_r), torch.cat(out_i)


def judge(out, ref) -> dict:
    """``rel_err`` and ``rel_l2`` (dft.rel_errors) of ρ over the valid
    window of every template.  The peaks' indices are not compared: where
    two samples' |ρ| nearly tie, rounding decides between them."""
    (gr, gi), (wr, wi) = out, ref
    return rel_errors((gr[r:r + 1], gi[r:r + 1], wr[r:r + 1], wi[r:r + 1])
                      for r in range(gr.shape[0]))
