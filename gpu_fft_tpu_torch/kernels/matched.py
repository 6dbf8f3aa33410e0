"""The matched filter's own passes as two operators, each beside its plain
version (``ops/matched.py:matched_filter_device`` runs them on either side
of its batched inverse).

* ``matched_correlate``: the correlation q̃[t, k] = conj(h̃[t, k]) s̃[k] / S[k]
  for kmin <= k < N/2, zero at every other k < N, as split-complex (T, N),
  and the template norm's sums Σ |h̃[t, k]|² / S[k] over those bins as
  partial sums, (T, P);
* ``matched_snr``: from the inverse y (T, N) and the partials, the complex
  SNR ρ = y · N·4Δf / √σ² (σ² = 4Δf times the partials' sum) over the
  window [start, stop), as split-complex (T, stop - start), and each row's
  largest |ρ| and its first index in the whole series.

On a CUDA tensor each launches hand-written kernels (``csrc/matched.cu``):
the correlation one (the partials one a block, P of them a template, from
:func:`matched_geometry`), the SNR two, the scale in one pass over the window
and the per-row peak from its blocks' candidates.  On a CPU tensor each runs
its plain version (:func:`matched_correlate_plain`,
:func:`matched_snr_plain`: the torch passes, one partial a template), and a
fake kernel gives the output shapes.  They replace no Pallas kernel: the JAX
package has no matched filter.  ``COUNTS[name]`` counts launches and plain
calls, as in :mod:`.fused`.  Their device time is the entry op's: the C call
of each kernel is inside the span ``gft.entry.matched_filter.correlate``,
``.snr`` or ``.peak`` (the plain versions inside the first two), not a
``gft.launch.`` one.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import _build
from .fused import LaunchCount, _launch, _on_cpu, _ptr, _stream

__all__ = [
    "COUNTS",
    "matched_correlate",
    "matched_correlate_plain",
    "matched_geometry",
    "matched_snr",
    "matched_snr_plain",
    "reset_counts",
]

COUNTS = {"matched_correlate": LaunchCount(), "matched_snr": LaunchCount()}

_SPAN = "gft.entry.matched_filter."
_TILE = 1024  # bins a correlation block takes at a time (csrc/matched.cu: TILE)
_TILE_BLOCKS = 512  # the most correlation blocks a template chunk: its partials
_SEG = 1024  # window elements an SNR block takes a pass (csrc/matched.cu: SEG)
_SEG_MAX = 8192  # the most elements an SNR block takes, where that leaves enough blocks
_SNR_BLOCKS = 1024  # SNR blocks in all below which a block takes fewer (8 of 256 threads an SM)


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


def matched_geometry(t: int, n: int, length: int) -> tuple[int, int, int]:
    """(tile_blocks, seg, blocks) of the kernels at T = ``t`` templates, N =
    ``n`` and a window of ``length`` samples: the correlation's blocks a
    template chunk, each one partial of a template's norm (the tiles of 1,024
    bins dealt to them in turn); the SNR's elements a block (a multiple of
    1,024, at most 8,192 where that leaves 1,024 blocks in all) and its
    blocks a row."""
    tile_blocks = min(-(-n // _TILE), _TILE_BLOCKS)
    per_row = max(-(-length // _SEG_MAX), min(-(-length // _SEG), -(-_SNR_BLOCKS // t)))
    seg = -(-(-(-length // per_row)) // _SEG) * _SEG
    return tile_blocks, seg, -(-length // seg)


def matched_correlate_plain(hr, hi, sr, si, psd, kmin: int):
    """Plain torch version of :func:`matched_correlate`: ``(qr, qi, parts)``
    with ``parts`` (T, 1), the whole sum."""
    t, h = hr.shape
    n = 2 * (h - 1)
    band = slice(kmin, n // 2)
    hr, hi = hr[:, band], hi[:, band]
    w = psd[band].reciprocal()
    ar, ai = sr[band] * w, si[band] * w  # s̃ / S
    qr = torch.zeros((t, n), dtype=torch.float32, device=hr.device)
    qi = torch.zeros((t, n), dtype=torch.float32, device=hr.device)
    qr[:, band] = torch.addcmul(hr * ar, hi, ai)  # Re conj(h̃) s̃ / S
    qi[:, band] = torch.addcmul(hr * ai, hi, ar, value=-1.0)  # Im
    return qr, qi, (torch.addcmul(hr * hr, hi, hi) * w).sum(dim=-1, keepdim=True)


def matched_snr_plain(yr, yi, parts, delta_f: float, start: int, stop: int):
    """Plain torch version of :func:`matched_snr`: ``(snr_r, snr_i, peak,
    peak_index)``."""
    sigmasq = (4.0 * delta_f) * parts.sum(dim=-1)
    # The inverse scaled by 1/N; PyCBC's is unnormalised, so N is in the norm.
    norm = (yr.shape[-1] * 4.0 * delta_f) * sigmasq.rsqrt()
    snr_r = yr[:, start:stop] * norm[:, None]
    snr_i = yi[:, start:stop] * norm[:, None]
    peak_sq, at = torch.addcmul(snr_r * snr_r, snr_i, snr_i).max(dim=-1)
    return snr_r, snr_i, peak_sq.sqrt(), at + start


def matched_correlate(hr, hi, sr, si, psd, kmin: int):
    """The correlation and the norm's partial sums, ``(qr, qi, parts)``:
    ``hr``, ``hi`` (T, h) fp32 template spectra, any row stride (a strided
    view is read as it is); ``sr``, ``si``, ``psd`` (h,); h = N/2 + 1 of a
    power-of-two N, all on one device, 0 <= ``kmin`` < N/2.  Returns
    split-complex (T, N) and ``parts`` (T, P)."""
    _on_cpu(hr, "matched_correlate")  # raises for any device but the CPU and CUDA
    return _OPS.matched_correlate(hr, hi, sr, si, psd, int(kmin))


def matched_snr(yr, yi, parts, delta_f: float, start: int, stop: int):
    """ρ over [``start``, ``stop``) of the inverse ``yr``, ``yi`` (T, N) with
    the norm from :func:`matched_correlate`'s ``parts``, spacing
    ``delta_f``: ``(snr_r, snr_i, peak, peak_index)``, (T, stop - start)
    twice, then (T,) fp32 and (T,) int64."""
    _on_cpu(yr, "matched_snr")  # raises for any device but the CPU and CUDA
    return _OPS.matched_snr(yr, yi, parts, float(delta_f), int(start), int(stop))


def _correlate_cpu(hr, hi, sr, si, psd, kmin):
    COUNTS["matched_correlate"].plain_calls += 1
    with span(_SPAN + "correlate"):
        return matched_correlate_plain(hr, hi, sr, si, psd, kmin)


def _check(kernel: str, device, tensors: dict, shapes: dict) -> None:
    """Raise unless each tensor of ``tensors`` is fp32 on ``device`` of the
    shape in ``shapes``."""
    for name, v in tensors.items():
        if tuple(v.shape) != shapes[name] or v.device != device or v.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be float32 {shapes[name]} on {device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _correlate_cuda(hr, hi, sr, si, psd, kmin):
    t, h = hr.shape
    n = 2 * (h - 1)
    _check("matched_correlate", hr.device, {"hr": hr, "hi": hi, "sr": sr, "si": si, "psd": psd},
           {"hr": (t, h), "hi": (t, h), **dict.fromkeys(("sr", "si", "psd"), (h,))})
    # The kernel reads a template row from any float and any row stride (the
    # strided views are not copied); only the last axis needs unit stride.
    hr, hi, sr, si, psd = (v if v.stride(-1) == 1 else v.contiguous() for v in (hr, hi, sr, si, psd))
    tile_blocks = matched_geometry(t, n, 1)[0]
    qr = torch.empty((t, n), dtype=torch.float32, device=hr.device)
    qi = torch.empty_like(qr)
    parts = torch.empty((t, tile_blocks), dtype=torch.float32, device=hr.device)
    _launch(COUNTS, "matched_correlate", _build.library().gft_matched_correlate, _ptr(hr), _ptr(hi),
            hr.stride(0), hi.stride(0), _ptr(sr), _ptr(si), _ptr(psd), _ptr(qr), _ptr(qi), _ptr(parts), t, n,
            kmin, tile_blocks, _stream(hr.device), span_name=_SPAN + "correlate")
    return qr, qi, parts


def _correlate_fake(hr, hi, sr, si, psd, kmin):
    t, h = hr.shape
    n = 2 * (h - 1)
    q = hr.new_empty((t, n))
    p = 1 if hr.device.type == "cpu" else matched_geometry(t, n, 1)[0]
    return q, torch.empty_like(q), hr.new_empty((t, p))


def _snr_cpu(yr, yi, parts, delta_f, start, stop):
    COUNTS["matched_snr"].plain_calls += 1
    with span(_SPAN + "snr"):
        return matched_snr_plain(yr, yi, parts, delta_f, start, stop)


def _snr_cuda(yr, yi, parts, delta_f, start, stop):
    t, n = yr.shape
    length = stop - start
    _check("matched_snr", yr.device, {"yr": yr, "yi": yi, "parts": parts},
           {"yr": (t, n), "yi": (t, n), "parts": (t, parts.shape[-1])})
    yr, yi, parts = (v.contiguous() for v in (yr, yi, parts))
    _, seg, blocks = matched_geometry(t, n, length)
    out_r = torch.empty((t, length), dtype=torch.float32, device=yr.device)
    out_i = torch.empty_like(out_r)
    best_v = torch.empty((t, blocks), dtype=torch.float32, device=yr.device)
    best_i = torch.empty((t, blocks), dtype=torch.int32, device=yr.device)
    peak = torch.empty(t, dtype=torch.float32, device=yr.device)
    at = torch.empty(t, dtype=torch.int64, device=yr.device)
    vec = n % 4 == 0 and start % 4 == 0 and length % 4 == 0 and not (_ptr(yr) | _ptr(yi)) % 16
    lib, stream = _build.library(), _stream(yr.device)
    _launch(COUNTS, "matched_snr", lib.gft_matched_snr, _ptr(yr), _ptr(yi), _ptr(parts), parts.shape[-1],
            _ptr(out_r), _ptr(out_i), _ptr(best_v), _ptr(best_i), t, n, start, length, seg, int(vec),
            4.0 * delta_f, n * 4.0 * delta_f, stream, span_name=_SPAN + "snr")
    _launch(COUNTS, "matched_snr", lib.gft_matched_peak, _ptr(best_v), _ptr(best_i), blocks, t, start,
            _ptr(peak), _ptr(at), stream, span_name=_SPAN + "peak")
    return out_r, out_i, peak, at


def _snr_fake(yr, yi, parts, delta_f, start, stop):
    t = yr.shape[0]
    out = yr.new_empty((t, stop - start))
    return out, torch.empty_like(out), yr.new_empty((t,)), yr.new_empty((t,), dtype=torch.int64)


_LIB = torch.library.Library("gpu_fft_tpu_torch", "FRAGMENT")
_SCHEMAS = {
    "matched_correlate": ("(Tensor hr, Tensor hi, Tensor sr, Tensor si, Tensor psd, int kmin)"
                          " -> (Tensor, Tensor, Tensor)", _correlate_cpu, _correlate_cuda, _correlate_fake),
    "matched_snr": ("(Tensor yr, Tensor yi, Tensor parts, float delta_f, int start, int stop)"
                    " -> (Tensor, Tensor, Tensor, Tensor)", _snr_cpu, _snr_cuda, _snr_fake),
}
for _name, (_schema, _cpu, _cuda, _fake) in _SCHEMAS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"gpu_fft_tpu_torch::{_name}", _fake, lib=_LIB)
_OPS = torch.ops.gpu_fft_tpu_torch
