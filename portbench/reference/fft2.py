"""Reference of ``fft2_device``: the full 2-D spectrum of each real image,
as ``numpy.fft.fft2`` gives it (unnormalized, natural order): the DFT of
every row, then of every column."""

from __future__ import annotations

import torch

from .dft import dft_rows, precision, rel_errors


def reference(x, params, prec: str = "float64"):
    """(re, im) of the 2-D DFT of every (H, W) image of the (B, H, W) real ``x``."""
    out_r, out_i = [], []
    with precision(prec) as dtype:
        for img in x:
            rr, ri = dft_rows(img, None, -1, dtype)
            cr, ci = dft_rows(rr.T.contiguous(), ri.T.contiguous(), -1, dtype)
            out_r.append(cr.T)
            out_i.append(ci.T)
    return torch.stack(out_r), torch.stack(out_i)


def judge(out, ref) -> dict:
    """``rel_err`` and ``rel_l2`` (dft.rel_errors) over the whole spectrum."""
    (gr, gi), (wr, wi) = out, ref
    return rel_errors((gr[b], gi[b], wr[b], wi[b]) for b in range(gr.shape[0]))
