"""NATIVE backend: the host C++ Stockham FFT behind a C ABI, loaded via ctypes.

Port of ``gpu_fft_tpu/backends/native.py``.  The library is the repo's own
``native/libtpufft.so`` (``native/fft_kernels.cpp``, built by
``make -C native``), shared with the JAX package: split-complex f32 buffers
on both sides and integer error codes.  It is found through an env var
override first, then the in-repo build location; when absent the backend is
simply unavailable.  NATIVE runs on the host: numpy in, numpy out, no
device.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib

import numpy as np

from ..config import NATIVE_LIB_ENV_VAR

__all__ = ["is_available", "forward", "inverse", "lib_path"]

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def lib_path() -> pathlib.Path | None:
    override = os.environ.get(NATIVE_LIB_ENV_VAR)
    candidates = []
    if override:
        candidates.append(pathlib.Path(override))
    candidates.append(_REPO_ROOT / "native" / "libtpufft.so")
    for c in candidates:
        if c.is_file():
            return c
    return None


@functools.lru_cache(maxsize=1)
def _load():
    path = lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    # int tpufft_transform(const float* re_in, const float* im_in,
    #                      float* re_out, float* im_out,
    #                      size_t batch, size_t n, int sign)
    lib.tpufft_transform.argtypes = [fp, fp, fp, fp, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
    lib.tpufft_transform.restype = ctypes.c_int
    return lib


def is_available() -> bool:
    return _load() is not None


def _run(xr: np.ndarray, xi: np.ndarray, sign: int) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native backend not built — run `make -C native` or set "
            f"{NATIVE_LIB_ENV_VAR} to the shared library path"
        )
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(
            f"native transform expects matching (B, n) arrays, got {xr.shape} vs {xi.shape}"
        )
    b, n = xr.shape
    xr = np.ascontiguousarray(xr, dtype=np.float32)
    xi = np.ascontiguousarray(xi, dtype=np.float32)
    yr = np.empty_like(xr)
    yi = np.empty_like(xi)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.tpufft_transform(
        xr.ctypes.data_as(fp),
        xi.ctypes.data_as(fp),
        yr.ctypes.data_as(fp),
        yi.ctypes.data_as(fp),
        b,
        n,
        sign,
    )
    if rc != 0:
        # The C ABI's contract: nonzero = invalid input.
        raise ValueError(f"tpufft_transform failed with code {rc} (n={n}, batch={b})")
    return yr, yi


def forward(x):
    """(B, n) real f32 ndarray -> split-complex spectrum ndarrays."""
    x = np.asarray(x, dtype=np.float32)
    return _run(x, np.zeros_like(x), -1)


def inverse(xr, xi):
    """(B, n) split-complex ndarrays -> signal normalized by 1/n."""
    xr = np.asarray(xr, dtype=np.float32)
    xi = np.asarray(xi, dtype=np.float32)
    yr, yi = _run(xr, xi, +1)
    scale = np.float32(1.0 / xr.shape[-1])
    return yr * scale, yi * scale
