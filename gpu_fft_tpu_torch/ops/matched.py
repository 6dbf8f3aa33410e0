"""Matched filtering of one data segment against a block of templates, as
PyCBC's ``pycbc/filter/matchedfilter.py:matched_filter_core`` computes it.

For one-sided spectra of N/2 + 1 bins (h̃ of each template, the data s̃ and
its one-sided PSD S, frequency spacing Δf):

* the correlation q̃[k] = conj(h̃[k]) s̃[k] / S[k] for kmin <= k < N/2,
  zero at every other k < N (the negative frequencies included);
* q = the unnormalised complex inverse FFT of q̃, length N;
* σ² = 4Δf Σ_{kmin <= k < N/2} |h̃[k]|² / S[k], the template's norm;
* the complex SNR ρ = q · 4Δf / √σ².

All templates of the block go through ONE batched inverse,
``ifft_device`` on the (T, N) buffer (so ``kernels/large.py:transform_any``,
on ``plan.route``'s engine).  Around it the entry op's own passes are two
operators of ``kernels/matched.py``: ``matched_correlate`` (q̃ and σ²'s
partial sums) before, ``matched_snr`` (ρ over the window and its peak)
after; on a card hand-written kernels, each a pass over its bytes, on the
CPU their plain torch versions.  Inputs that require grad take the plain
versions on every device, which autograd follows.  No step reads a value
back to the host.  The body is the profiler span
``gft.entry.matched_filter``; ``COUNTS["matched_filter"]`` counts calls and
templates filtered.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import resolve_device
from ..kernels import matched as kernels
from ..utils.profiling import span
from .transform import _one_sided_n, ifft_device

__all__ = ["COUNTS", "matched_filter_device", "reset_counts"]


@dataclass
class FilterCount:
    calls: int = 0
    templates: int = 0


COUNTS = {"matched_filter": FilterCount()}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.calls = 0
        c.templates = 0


def matched_filter_device(htilde_r, htilde_i, stilde_r, stilde_i, psd, *, delta_f: float,
                          kmin: int, valid=None):
    """Complex SNR of every template of a block against one data segment.

    ``htilde_r, htilde_i``: (T, h) split-complex one-sided template spectra;
    ``stilde_r, stilde_i``: (h,) the data's one-sided spectrum; ``psd``:
    (h,) its one-sided PSD; h = N/2 + 1 bins of a power-of-two N, spacing
    ``delta_f``, fp32 on the tensors' device (the first one's).  Bins
    ``kmin <= k < N/2`` are correlated (PyCBC's ``get_cutoff_indices`` with
    no upper cutoff).  ``valid`` = (start, stop) sample indices keeps that
    window of the SNR series.

    Returns ``(snr_r, snr_i), peak, peak_index``: ρ of shape (T, N), or
    (T, stop - start) with ``valid``; the largest |ρ| of each template over
    the kept samples, and its sample index in the whole N-sample series.

    >>> import torch
    >>> h = torch.zeros(1, 9); h[0, 1:8] = 1.0
    >>> (sr, si), peak, at = matched_filter_device(h, torch.zeros(1, 9), 3 * h[0], torch.zeros(9),
    ...                                            torch.ones(9), delta_f=1.0, kmin=1)
    >>> tuple(sr.shape), round(float(peak[0]), 3), int(at[0])  # 3 * sqrt(sigma^2 / 4)
    ((1, 16), 15.875, 0)
    """
    with span("gft.entry.matched_filter"):
        dev = htilde_r.device if isinstance(htilde_r, torch.Tensor) else resolve_device(None)
        # A fp32 tensor on ``dev`` is used as it is, strides and all (no copy).
        hr, hi, sr, si, s_psd = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                                 for v in (htilde_r, htilde_i, stilde_r, stilde_i, psd))
        if hr.dim() != 2 or hi.shape != hr.shape:
            raise ValueError(f"matched_filter_device: templates must be two (T, h) tensors of one "
                             f"shape, got {tuple(hr.shape)} and {tuple(hi.shape)}")
        t, h = hr.shape
        n = _one_sided_n(h, "matched_filter_device")
        for name, v in (("stilde_r", sr), ("stilde_i", si), ("psd", s_psd)):
            if v.shape != (h,):
                raise ValueError(f"matched_filter_device: {name} must have shape ({h},), "
                                 f"got {tuple(v.shape)}")
        if t < 1:
            raise ValueError("matched_filter_device: no template given")
        if not delta_f > 0:
            raise ValueError(f"matched_filter_device: delta_f must be positive, got {delta_f}")
        kmin = int(kmin)
        if not 0 <= kmin < n // 2:
            raise ValueError(f"matched_filter_device: need 0 <= kmin < N/2 = {n // 2}, "
                             f"got kmin={kmin}")
        start, stop = (0, n) if valid is None else (int(valid[0]), int(valid[1]))
        if not 0 <= start < stop <= n:
            raise ValueError(f"matched_filter_device: valid must be (start, stop) with "
                             f"0 <= start < stop <= N = {n}, got {valid}")

        inputs = (hr, hi, sr, si, s_psd)
        if torch.is_grad_enabled() and any(v.requires_grad for v in inputs):
            correlate, snr = kernels.matched_correlate_plain, kernels.matched_snr_plain
        else:
            correlate, snr = kernels.matched_correlate, kernels.matched_snr
        qr, qi, parts = correlate(*inputs, kmin)
        yr, yi = ifft_device(qr, qi)
        del qr, qi  # each (T, N) buffer goes back to the allocator as soon as it is read
        snr_r, snr_i, peak, at = snr(yr, yi, parts, delta_f, start, stop)
        COUNTS["matched_filter"].calls += 1
        COUNTS["matched_filter"].templates += t
        return (snr_r, snr_i), peak, at
