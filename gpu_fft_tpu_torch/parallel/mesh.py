"""Batch sharding over the device mesh (the "data-parallel" axis), and the
sharded estimators built on it.

Port of ``gpu_fft_tpu/parallel/mesh.py``.  The reference packs B signals
into one buffer so a single dispatch covers the batch; across cards the
same idea shards the batch dimension: each rank runs the single-card
dispatch (``kernels/large.py:transform_any``) on its rows, with no
collective.  ``welch_sharded`` adds one all-reduce, ``oaconvolve_sharded``
one neighbour exchange and ``lfilter_sharded`` one all-gather of the block
states.  Inputs and outputs are DTensors (a plain tensor or numpy array is
the global array every rank holds); collectives run on the mesh axis's
process group (NCCL for a CUDA mesh).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..config import apply_precision, resolve_device
from ..kernels.large import transform_any
from . import _sharding as S

__all__ = [
    "default_mesh",
    "fft_batch_sharded",
    "ifft_batch_sharded",
    "fft2_batch_sharded",
    "welch_sharded",
    "oaconvolve_sharded",
    "lfilter_sharded",
]


def default_mesh(axis_name: str = "dp", device=None):
    """A 1-D mesh named ``axis_name`` over every rank of the default process
    group, on ``device``'s type (default: the card, over NCCL; ``"cpu"``
    for a gloo group).  The process group must exist
    (``torch.distributed.init_process_group``; ``torchrun`` sets its
    address, rank and world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("default_mesh needs a process group: call torch.distributed.init_process_group "
                           "(nccl for the card, gloo for the CPU) or run under torchrun")
    backend = dist.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise ValueError(f"a CUDA mesh needs the nccl backend, the process group is {backend!r}")
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def _check_batch(b: int, mesh, axis_name: str) -> None:
    d = S.axis_size(mesh, axis_name)
    if b % d:
        raise ValueError(f"batch {b} not divisible by mesh axis '{axis_name}' size {d}")


def fft_batch_sharded(x, mesh, axis_name: str = "dp"):
    """Forward FFT of (B, n) with B sharded over ``axis_name``.

    B must divide evenly by the mesh axis size.  Returns split-complex
    (re, im) DTensors with the same sharding.
    """
    x = S.global_tensor(x, mesh)
    b, n = x.shape
    _check_batch(b, mesh, axis_name)
    places = S.placements(mesh, {axis_name: 0})
    yr, yi = transform_any(S.to_local(x, mesh, places), None, n, -1)
    return S.from_local(yr, mesh, places, (b, n)), S.from_local(yi, mesh, places, (b, n))


def ifft_batch_sharded(xr, xi, mesh, axis_name: str = "dp"):
    """Inverse FFT of a (B, n) split-complex batch sharded over ``axis_name``."""
    xr = S.global_tensor(xr, mesh)
    xi = S.global_tensor(xi, mesh)
    b, n = xr.shape
    _check_batch(b, mesh, axis_name)
    places = S.placements(mesh, {axis_name: 0})
    yr, yi = transform_any(S.to_local(xr, mesh, places), S.to_local(xi, mesh, places), n, +1, scale=1.0 / n)
    return S.from_local(yr, mesh, places, (b, n)), S.from_local(yi, mesh, places, (b, n))


def fft2_batch_sharded(x, mesh, axis_name: str = "dp"):
    """Forward 2-D FFT of a (B, H, W) image batch with B sharded over the
    mesh — each rank transforms its images locally, zero collectives.

    B must divide evenly by the mesh axis size.  Returns split-complex
    (re, im) DTensors with the same sharding.  Sides follow the fft2
    contract (any length >= 2; non-pow2 sides run via Bluestein).
    """
    from ..ops.fft2d import _check_sides, _transform2d

    x = S.global_tensor(x, mesh)
    if x.dim() != 3:
        raise ValueError(f"fft2_batch_sharded expects (B, H, W), got {tuple(x.shape)}")
    b = x.shape[0]
    _check_sides(x.shape[1], x.shape[2])
    _check_batch(b, mesh, axis_name)
    places = S.placements(mesh, {axis_name: 0})
    yr, yi = _transform2d(S.to_local(x, mesh, places), None, -1)
    return S.from_local(yr, mesh, places, x.shape), S.from_local(yi, mesh, places, x.shape)


def welch_sharded(
    x,
    mesh,
    axis_name: str = "dp",
    fs: float = 1.0,
    window: str | None = "hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: bool | str = True,
    scaling: str = "density",
):
    """Welch PSD of a long signal with the SEGMENTS sharded over the mesh.

    The segment axis is this estimator's batch dimension: each rank windows
    and transforms its own slice of segments and reduces its partial power
    sum; one ``all_reduce(SUM)`` over ``axis_name`` completes the average.
    Semantics identical to :func:`gpu_fft_tpu_torch.welch_device` for ANY
    segment count: when the count does not divide the mesh, the segment
    axis is padded with zero rows and the padding is masked out of the
    power sum.

    Returns ``(freqs, psd)`` — psd a replicated DTensor.  A sharded
    (DTensor) signal is gathered first: each rank frames its segments from
    the whole signal.
    """
    from ..ops.spectral import _detrend_rows, _welch_scale_mult
    from ..ops.stft import frame_signal, window_table

    if scaling not in ("density", "spectrum"):
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise ValueError(f"nperseg must be a power of two >= 2, got {nperseg}")
    noverlap = nperseg // 2 if noverlap is None else noverlap
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
    hop = nperseg - noverlap
    x = S.global_tensor(x, mesh)
    if x.dim() != 1:
        raise ValueError(f"welch_sharded expects a 1-D signal, got shape {tuple(x.shape)}")
    d = S.axis_size(mesh, axis_name)
    num_seg = (x.shape[0] - nperseg) // hop + 1
    if num_seg < 1:
        raise ValueError(
            f"signal of {x.shape[0]} samples is shorter than one {nperseg} segment"
        )
    if isinstance(x, DTensor):
        x = x.full_tensor()
    # Pad the segment axis up to a mesh multiple with zero rows (framed out
    # of a zero-extended signal); the padding is masked out of the sum.
    num_pad = -(-num_seg // d) * d
    need = (num_pad - 1) * hop + nperseg
    if need > x.shape[0]:
        x = F.pad(x, (0, need - x.shape[0]))
    rows = num_pad // d
    rank = S.axis_rank(mesh, axis_name)
    # This rank's segments, framed from its span of the signal only.
    span = x[rank * rows * hop : rank * rows * hop + (rows - 1) * hop + nperseg]
    sl = _detrend_rows(frame_signal(span, nperseg, hop, rows), detrend)
    w = torch.from_numpy(window_table(window, nperseg)).to(x.device)
    yr, yi = transform_any((sl * w).contiguous(), None, nperseg, -1)
    h = nperseg // 2 + 1
    mask = (rank * rows + torch.arange(rows, device=x.device) < num_seg).to(torch.float32)
    part = torch.sum((yr[:, :h] ** 2 + yi[:, :h] ** 2) * mask[:, None], dim=0)
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=S.group(mesh, axis_name))
    mult = torch.from_numpy(np.asarray(_welch_scale_mult(window, nperseg, fs, scaling), dtype=np.float32))
    power = part * float(np.float32(1.0 / num_seg)) * mult.to(x.device)
    freqs = np.arange(nperseg // 2 + 1, dtype=np.float64) * (fs / nperseg)
    return freqs, S.from_local(power, mesh, S.placements(mesh, {}), power.shape)


def oaconvolve_sharded(x, h, mesh, axis_name: str = "dp"):
    """FIR convolution of a LONG signal with the signal sharded over the mesh.

    The overlap-add identity distributes: cut ``x`` into one contiguous
    chunk per rank, convolve each chunk locally (through
    :func:`gpu_fft_tpu_torch.oaconvolve_device`'s batched block path), and
    the only cross-rank dependency is each chunk's length-(lh-1)
    convolution tail, which belongs at the head of the NEXT rank's span:
    one ``batch_isend_irecv`` neighbour exchange.

    ``x``: (n,) real f32; ``h``: (lh,) taps with 2 <= lh <= ceil(n/d) + 1.
    Returns the full (n + lh - 1,) linear convolution as a DTensor with
    ``Shard(0)`` in ``torch.chunk`` layout.  To land there the input is cut
    at ceil((n + lh - 1) / d) samples a rank (JAX: ceil(n / d)), so the
    global tail falls inside the last ranks' spans and the last rank's own
    tail is zero: no reduction follows the exchange.  A sharded (DTensor)
    signal is gathered first and cut that way.
    """
    from ..ops.filter import oaconvolve_device

    x = S.global_tensor(x, mesh)
    h = S.global_tensor(h, mesh)
    if x.dim() != 1 or h.dim() != 1:
        raise ValueError(
            f"oaconvolve_sharded expects 1-D signal and taps, got {tuple(x.shape)} vs {tuple(h.shape)}"
        )
    n, lh = x.shape[0], h.shape[0]
    d = S.axis_size(mesh, axis_name)
    if lh < 2:
        raise ValueError(f"oaconvolve_sharded needs len(h) >= 2, got {lh}")
    chunk = -(-n // d)
    if lh - 1 > chunk:
        raise ValueError(
            f"taps ({lh}) must fit one device's chunk ({chunk}); "
            "use fewer devices or the single-chip oaconvolve"
        )
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(h, DTensor):
        h = h.full_tensor()
    t = lh - 1
    total = n + t
    span = -(-total // d)
    rank = S.axis_rank(mesh, axis_name)
    lo = min(rank * span, n)
    xl = F.pad(x[lo : min(lo + span, n)], (0, span - (min(lo + span, n) - lo)))
    full = oaconvolve_device(xl[None], h)[0]  # (span + t,)
    main, tail = full[:span].contiguous(), full[span:].contiguous()
    # The tail of rank i belongs at the head of rank i + 1's span.
    g = S.group(mesh, axis_name)
    ops = []
    if rank + 1 < d:
        ops.append(dist.P2POp(dist.isend, tail, dist.get_global_rank(g, rank + 1), g))
    recv = torch.zeros_like(tail)
    if rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, rank - 1), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    main[:t] += recv
    keep = max(0, min(span, total - rank * span))
    return S.from_local(main[:keep], mesh, S.placements(mesh, {axis_name: 0}), (total,))


def lfilter_sharded(b, a, x, mesh, axis_name: str = "sp"):
    """Sequence-parallel IIR filtering: the signal sharded over the mesh.

    The block-state decomposition (``ops/iir.py``) distributes across ranks
    exactly as it does across blocks: each rank runs the zero-entry-state
    filter on its contiguous shard (one call into ``lfilter_device``, whose
    ``zf`` IS the shard's input-to-state contribution), one
    ``all_gather_into_tensor`` of the (d, k) state vectors crosses the
    mesh, every rank composes the affine carry prefix with host-made
    propagator powers F^(m*p) (k x k, f64-generated), and a shard-local
    observability product adds the zero-input response.  The traffic per
    call is d*k floats, independent of the signal's length.

    ``x``: (n,) real f32 with d | n; returns the (n,) filtered signal as a
    DTensor, ``Shard(0)`` on ``axis_name``.
    """
    from ..ops.iir import _df2t_matrices, _normalize_ba, lfilter_device

    x = S.global_tensor(x, mesh)
    if x.dim() != 1:
        raise ValueError(f"lfilter_sharded expects a 1-D signal, got shape {tuple(x.shape)}")
    b64, a64 = _normalize_ba(b, a)
    k = b64.shape[0] - 1
    d = S.axis_size(mesh, axis_name)
    n = x.shape[0]
    if n % d:
        raise ValueError(f"signal length {n} must divide over {d} devices")
    m = n // d
    places = S.placements(mesh, {axis_name: 0})
    xl = S.to_local(x, mesh, places)
    if k == 0:
        return S.from_local(float(np.float32(b64[0])) * xl, mesh, places, (n,))
    # Host f64 precomputes: the shard observability obs[t] = c^T F^t
    # (t < m) and the masked propagator tensor M[i, j] = F^(m*(i-1-j)) for
    # j < i (zero otherwise), so z_entry = einsum('ijkl,jl->ik', M, zetas).
    f, g, c, dd = _df2t_matrices(b64, a64)
    obs = np.empty((m, k), dtype=np.float64)
    row = c.copy()
    for t in range(m):
        obs[t] = row
        row = f.T @ row
    fm = np.linalg.matrix_power(f, m)
    powers = [np.eye(k)]
    for _ in range(d - 1):
        powers.append(fm @ powers[-1])
    mask = np.zeros((d, d, k, k), dtype=np.float64)
    for i in range(d):
        for j in range(i):
            mask[i, j] = powers[i - 1 - j]
    dev = xl.device
    obs32 = torch.from_numpy(obs.astype(np.float32)).to(dev)
    mask32 = torch.from_numpy(mask.astype(np.float32)).to(dev)
    bb = tuple(float(v) for v in b64)
    aa = tuple(float(v) for v in a64)

    y_zs, zeta = lfilter_device(bb, aa, xl[None], zi=xl.new_zeros(1, k))
    zetas = xl.new_empty(d * k)
    dist.all_gather_into_tensor(zetas, zeta[0].contiguous(), group=S.group(mesh, axis_name))
    apply_precision()  # the products below in full fp32 (JAX: Precision.HIGHEST)
    entries = torch.einsum("ijkl,jl->ik", mask32, zetas.reshape(d, k))
    mine = entries[S.axis_rank(mesh, axis_name)]
    return S.from_local((y_zs + (obs32 @ mine)[None])[0], mesh, places, (n,))
