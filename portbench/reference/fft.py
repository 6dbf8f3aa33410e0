"""Reference of ``fft_device``: the full spectrum of each real row, as
``numpy.fft.fft`` gives it (unnormalized, natural order)."""

from __future__ import annotations

from .dft import dft_rows, precision, rel_errors

ROWS_PER_BLOCK = 2


def reference(x, params, prec: str = "float64"):
    """(re, im) of the DFT of every row of the (B, n) real ``x``."""
    out_r, out_i = [], []
    with precision(prec) as dtype:
        for r0 in range(0, x.shape[0], ROWS_PER_BLOCK):
            yr, yi = dft_rows(x[r0:r0 + ROWS_PER_BLOCK], None, -1, dtype)
            out_r.append(yr)
            out_i.append(yi)
    return _cat(out_r), _cat(out_i)


def judge(out, ref) -> dict:
    """``rel_err`` and ``rel_l2`` (dft.rel_errors) over every bin of every row."""
    (gr, gi), (wr, wi) = out, ref
    return rel_errors((gr[r:r + 1], gi[r:r + 1], wr[r:r + 1], wi[r:r + 1])
                      for r in range(gr.shape[0]))


def _cat(parts):
    import torch

    return torch.cat(parts, dim=0)
