"""Forward/inverse FFT — the public transform semantics of the JAX package
(``gpu_fft_tpu/ops/transform.py``), on torch devices.

* ``fft(x)``: real fp32 signal zero-padded to the next power of two; returns
  split-complex ``(real, imag)`` of the padded length.
* ``ifft(re, im)``: equal power-of-two lengths; returns ONE array of length
  2N laid out ``[real | imag]`` with 1/N normalization.
* ``fft_batch`` / ``ifft_batch``: every signal padded to the longest one's
  power of two, all in one device pass.
* ``rfft`` / ``irfft`` (and ``*_device``): the one-sided n/2 + 1 bins of a
  real signal and back, ``numpy.fft.rfft`` / ``irfft`` conventions on the
  padded length.
* ``fft_native`` / ``ifft_native``: the host API on the NATIVE backend (the
  host C++ library); ``warmup`` builds the kernels and the tables of given
  (B, n) shapes before the first call.

The host API takes lists / numpy arrays and returns numpy arrays; ``device``
picks where it runs (default ``"cuda"`` or ``GPU_FFT_TPU_TORCH_DEVICE``).
``fft_device`` / ``ifft_device`` / ``rfft_device`` / ``irfft_device`` take
tensors and return tensors on the same device; each body is the profiler
span ``gft.entry.<op>`` (``utils/profiling.py:span``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backends import Backend, backend_module, resolve_backend
from ..config import MAX_N, apply_precision, resolve_device
from ..utils.profiling import span

__all__ = [
    "fft",
    "ifft",
    "fft_batch",
    "ifft_batch",
    "fft_with",
    "ifft_with",
    "fft_native",
    "ifft_native",
    "fft_device",
    "ifft_device",
    "rfft",
    "irfft",
    "rfft_device",
    "irfft_device",
    "next_power_of_two",
    "warmup",
]


def next_power_of_two(n: int) -> int:
    """Rust ``usize::next_power_of_two`` semantics: 0 -> 1.

    >>> [next_power_of_two(n) for n in (0, 1, 2, 3, 1000, 1024)]
    [1, 1, 2, 4, 1024, 1024]
    """
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _check_n(n: int) -> None:
    if n > MAX_N:
        raise ValueError(f"transform length {n} exceeds the supported maximum {MAX_N}")


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _dispatch_forward(x2d: np.ndarray, backend, device):
    """(B, n) f32 ndarray -> split-complex (re, im) ndarrays.  NATIVE runs
    on the host and takes no device."""
    backend = resolve_backend(backend)
    mod = backend_module(backend)
    if backend is Backend.NATIVE:
        return mod.forward(x2d)
    yr, yi = mod.forward(_upload(x2d, resolve_device(device)))
    return yr.cpu().numpy(), yi.cpu().numpy()


def _dispatch_inverse(xr2d: np.ndarray, xi2d: np.ndarray, backend, device):
    """(B, n) split-complex ndarrays -> the 1/n inverse's (re, im)."""
    backend = resolve_backend(backend)
    mod = backend_module(backend)
    if backend is Backend.NATIVE:
        return mod.inverse(xr2d, xi2d)
    dev = resolve_device(device)
    yr, yi = mod.inverse(_upload(xr2d, dev), _upload(xi2d, dev))
    return yr.cpu().numpy(), yi.cpu().numpy()


# ── Scalar API ───────────────────────────────────────────────────────────────


def fft(input, backend=None, device=None):
    """Forward FFT of a real signal, zero-padded to the next power of two.

    Returns ``(real, imag)`` numpy arrays of length
    ``next_power_of_two(len(input))``.
    """
    x = np.asarray(input, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"fft expects a 1-D signal, got shape {x.shape}")
    n_orig = x.shape[0]
    n = next_power_of_two(n_orig)
    if n <= 1:
        real = np.zeros(n, dtype=np.float32)
        if n == 1 and n_orig == 1:
            real[0] = x[0]
        return real, np.zeros(n, dtype=np.float32)
    _check_n(n)
    padded = np.zeros((1, n), dtype=np.float32)
    padded[0, :n_orig] = x
    yr, yi = _dispatch_forward(padded, backend, device)
    return yr[0], yi[0]


def ifft(input_real, input_imag, backend=None, device=None):
    """Inverse FFT of a split-complex spectrum of power-of-two length N.

    Returns ONE array of length 2N: ``out[:N]`` the real part, ``out[N:]``
    the imaginary part (~0 for the spectrum of a real signal).
    """
    xr = np.asarray(input_real, dtype=np.float32)
    xi = np.asarray(input_imag, dtype=np.float32)
    if xr.shape != xi.shape or xr.ndim != 1:
        raise ValueError(
            f"ifft: real and imag must be equal-length 1-D arrays, got {xr.shape} vs {xi.shape}"
        )
    n = xr.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"ifft: input length {n} is not a power of two (pass fft output)")
    if n <= 1:
        return np.concatenate([xr, xi])
    _check_n(n)
    yr, yi = _dispatch_inverse(xr[None], xi[None], backend, device)
    return np.concatenate([yr[0], yi[0]])


# ── Batch API ────────────────────────────────────────────────────────────────


def fft_batch(signals, backend=None, device=None):
    """Forward FFT of a batch of real signals in one device pass, all padded
    to the next power of two of the LONGEST signal.  Returns one
    ``(real, imag)`` pair per signal."""
    if len(signals) == 0:
        return []
    arrays = [np.asarray(s, dtype=np.float32) for s in signals]
    for a in arrays:
        if a.ndim != 1:
            raise ValueError(f"fft_batch expects 1-D signals, got shape {a.shape}")
    max_len = max(a.shape[0] for a in arrays)
    n = max(1, next_power_of_two(max_len))
    if n <= 1:
        out = []
        for a in arrays:
            real = np.zeros(n, dtype=np.float32)
            if n == 1 and a.shape[0] > 0:
                real[0] = a[0]
            out.append((real, np.zeros(n, dtype=np.float32)))
        return out
    _check_n(n)
    batch = np.zeros((len(arrays), n), dtype=np.float32)
    for b, a in enumerate(arrays):
        batch[b, : a.shape[0]] = a
    yr, yi = _dispatch_forward(batch, backend, device)
    return [(yr[b].copy(), yi[b].copy()) for b in range(len(arrays))]


def ifft_batch(signals, backend=None, device=None):
    """Inverse FFT of a batch of ``(real, imag)`` spectra sharing one
    power-of-two length, in one device pass.  Returns one length-2N
    ``[real | imag]`` array per spectrum."""
    if len(signals) == 0:
        return []
    res = [np.asarray(r, dtype=np.float32) for r, _ in signals]
    ims = [np.asarray(i, dtype=np.float32) for _, i in signals]
    n = res[0].shape[0]
    for r, i in zip(res, ims):
        if r.ndim != 1 or r.shape != i.shape or r.shape[0] != n:
            raise ValueError("ifft_batch: all (real, imag) pairs must share one 1-D length")
    if n == 0 or n & (n - 1):
        raise ValueError(f"ifft_batch: length {n} is not a power of two (pass fft_batch output)")
    if n <= 1:
        return [np.concatenate([r, i]) for r, i in zip(res, ims)]
    _check_n(n)
    yr, yi = _dispatch_inverse(np.stack(res), np.stack(ims), backend, device)
    return [np.concatenate([yr[b], yi[b]]) for b in range(len(res))]


def fft_with(input, backend, device=None):
    """Forward FFT via an explicit backend."""
    return fft(input, backend=backend, device=device)


def ifft_with(input_real, input_imag, backend, device=None):
    """Inverse FFT via an explicit backend."""
    return ifft(input_real, input_imag, backend=backend, device=device)


def fft_native(input):
    """Forward FFT on the NATIVE backend (the host C++ library)."""
    return fft(input, backend=Backend.NATIVE)


def ifft_native(input_real, input_imag):
    """Inverse FFT on the NATIVE backend (the host C++ library)."""
    return ifft(input_real, input_imag, backend=Backend.NATIVE)


def warmup(sizes=(1024, 4096, 65536), batches=(1,), inverse: bool = True, device=None) -> None:
    """Do a transform's first-call work ahead of the first request: build
    the CUDA library (on a card), upload the tables of each (B, n) in
    ``sizes`` x ``batches`` through ``plan.on_device``, and run each forward
    (and inverse, with ``inverse``) once on ``device``, then synchronise.

    Warms the backend the process will use (``GPU_FFT_TPU_BACKEND``
    honoured); NATIVE, a host library with nothing to build, warms TORCH
    instead.
    """
    dev = resolve_device(device)
    backend = resolve_backend(None)
    if backend is Backend.NATIVE:
        backend = Backend.TORCH
    for n in sizes:
        if n < 2 or n & (n - 1):
            raise ValueError(f"warmup sizes must be powers of two >= 2, got {n}")
    if dev.type == "cuda" and backend is Backend.TORCH:
        from ..kernels import _build

        _build.library()
    for n in sizes:
        for b in batches:
            x = torch.zeros((b, n), dtype=torch.float32, device=dev)
            yr, yi = fft_device(x, backend=backend)
            if inverse:
                ifft_device(yr, yi, backend=backend)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ── Device-resident API ──────────────────────────────────────────────────────


def _as_tensor(x, device) -> torch.Tensor:
    """fp32 contiguous tensor; a tensor keeps its device unless ``device`` is
    given, anything else goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.float32).contiguous()
    # contiguous: torch refuses numpy's negative strides (a reversed view).
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=resolve_device(device))


def _check_device_n(n: int, name: str) -> None:
    if n & (n - 1) or n < 2:
        raise ValueError(f"{name} requires power-of-two n >= 2, got {n}")
    _check_n(n)


def _device_module(backend, name: str):
    """The backend module of a tensor call; NATIVE runs on the host only."""
    backend = resolve_backend(backend)
    if backend is Backend.NATIVE:
        raise ValueError(f"{name}: the NATIVE backend is host-side; use fft() / fft_batch()")
    return backend_module(backend)


def fft_device(x, backend=None, device=None):
    """Forward FFT of (n,) or (B, n) real rows (power-of-two n), staying on
    the tensor's device.  Returns ``(real, imag)`` tensors."""
    with span("gft.entry.fft"):
        x = _as_tensor(x, device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        _check_device_n(x.shape[-1], "fft_device")
        yr, yi = _device_module(backend, "fft_device").forward(x)
        return (yr[0], yi[0]) if squeeze else (yr, yi)


def ifft_device(xr, xi, backend=None, device=None):
    """Inverse FFT (1/n) of (n,) or (B, n) split-complex rows, staying on the
    tensors' device.  Returns ``(real, imag)`` tensors."""
    with span("gft.entry.ifft"):
        xr = _as_tensor(xr, device)
        xi = _as_tensor(xi, xr.device if device is None else device)
        if xr.shape != xi.shape:
            raise ValueError(
                f"ifft_device: real and imag must have the same shape, got {xr.shape} vs {xi.shape}"
            )
        squeeze = xr.dim() == 1
        if squeeze:
            xr, xi = xr[None], xi[None]
        _check_device_n(xr.shape[-1], "ifft_device")
        yr, yi = _device_module(backend, "ifft_device").inverse(xr, xi)
        return (yr[0], yi[0]) if squeeze else (yr, yi)


# ── One-sided real-input API (numpy.fft.rfft conventions) ────────────────────


def _one_sided_n(h: int, name: str) -> int:
    """n from h = n/2 + 1 bins of a power-of-two n."""
    n = 2 * (h - 1)
    if h < 2 or n & (n - 1):
        raise ValueError(f"{name}: expected n//2 + 1 bins of a power-of-two n, got {h} bins")
    _check_n(n)
    return n


def rfft(input, backend=None, device=None):
    """One-sided forward FFT of a real signal: :func:`fft` (zero-padded to
    the next power of two), then its n//2 + 1 non-negative-frequency bins."""
    re, im = fft(input, backend=backend, device=device)
    h = re.shape[-1] // 2 + 1
    return re[..., :h].copy(), im[..., :h].copy()


def irfft(input_real, input_imag, backend=None, device=None):
    """Inverse of :func:`rfft`: the Hermitian spectrum X[n - k] = conj(X[k])
    rebuilt from the n//2 + 1 bins (DC and Nyquist taken as real) and
    inverted by :func:`ifft`; returns the length-n real signal."""
    xr = np.asarray(input_real, dtype=np.float32)
    xi = np.asarray(input_imag, dtype=np.float32)
    if xr.shape != xi.shape or xr.ndim != 1:
        raise ValueError(
            f"irfft: real and imag must be equal-length 1-D arrays, got {xr.shape} vs {xi.shape}"
        )
    h = xr.shape[0]
    n = _one_sided_n(h, "irfft")
    full_r = np.concatenate([xr, xr[1:-1][::-1]])
    full_i = np.concatenate([xi, -xi[1:-1][::-1]])
    full_i[0] = 0.0
    full_i[h - 1] = 0.0
    return ifft(full_r, full_i, backend=backend, device=device)[:n]


def rfft_device(x, backend=None, device=None):
    """One-sided forward FFT of (n,) or (B, n) real rows (power-of-two n),
    staying on the tensor's device: the n//2 + 1 bins of :func:`fft_device`."""
    with span("gft.entry.rfft"):
        yr, yi = fft_device(x, backend=backend, device=device)
        h = yr.shape[-1] // 2 + 1
        return yr[..., :h], yi[..., :h]


def irfft_device(xr, xi, backend=None, device=None):
    """Inverse of :func:`rfft_device`: (h,) or (B, h) split-complex bins,
    h = n//2 + 1 of a power-of-two n, to the length-n real rows, on the
    tensors' device.  DC and Nyquist imaginary parts are ignored.

    ``TORCH`` runs the real-output inverse straight from the one-sided
    bins (``kernels/large.py:inverse_real_half``); ``TORCH_FFT`` rebuilds
    the Hermitian spectrum and keeps the real part of :func:`ifft_device`.
    """
    with span("gft.entry.irfft"):
        xr = _as_tensor(xr, device)
        xi = _as_tensor(xi, xr.device if device is None else device)
        if xr.shape != xi.shape:
            raise ValueError(f"irfft_device: shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
        h = xr.shape[-1]
        n = _one_sided_n(h, "irfft_device")
        if resolve_backend(backend) is Backend.TORCH:
            from ..kernels.large import inverse_real_half

            apply_precision()
            squeeze = xr.dim() == 1
            rr, ri = (xr[None], xi[None]) if squeeze else (xr, xi)
            yr = inverse_real_half(rr, ri, n, scale=1.0 / n)
            return yr[0] if squeeze else yr
        xi = xi.clone()
        xi[..., 0] = 0.0
        xi[..., h - 1] = 0.0
        full_r = torch.cat([xr, torch.flip(xr[..., 1:-1], (-1,))], dim=-1)
        full_i = torch.cat([xi, -torch.flip(xi[..., 1:-1], (-1,))], dim=-1)
        yr, _ = ifft_device(full_r, full_i, backend=backend)
        return yr
