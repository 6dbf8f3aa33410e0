"""The left-matmul fused four-step (S1) of the engine ablation, beside its
plain version.

``scripts/ablate_engines.py`` measures two left-matmul forms of the real
input fused four-step: ``pallas_lm``, a Pallas kernel, and ``jnp_lm``, the
same contractions in jnp.  Here ``pallas_lm`` is the CUDA kernel
``csrc/fused_lm.cu`` behind :func:`fused_fft_lm` (the whole-transform radix
kernel of K1 at n2 = 64, 128 or 256, launch shape from
:func:`.fused.lm_geometry`) and ``jnp_lm`` is its plain version
:func:`fused_fft_lm_plain`.  Both read :func:`lm_tables`: the
balanced split (n1 <= n2), the Karatsuba table groups of both digits and the
(n1, n2) twiddle oriented [k1, c].

As in :mod:`.fused`, :func:`fused_fft_lm` runs its plain torch version for a
tensor on the CPU and launches its kernel or raises for a CUDA tensor;
``COUNTS["fused_fft_lm"]`` counts both.
"""

from __future__ import annotations

import torch

from ..plan import balanced_split
from . import _build
from .fused import LaunchCount, _check, _launch, _on_cpu, _ptr, _stream, lm_geometry, sm_count
from .tables import dft_matrix_ext, twiddle_table

__all__ = [
    "COUNTS",
    "LM_N2",
    "fused_fft_lm",
    "fused_fft_lm_plain",
    "lm_tables",
    "reset_counts",
]

LM_N2 = (64, 128, 256)  # the kernel's n2 instantiations: n = 2,048 ... 65,536

COUNTS = {"fused_fft_lm": LaunchCount()}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


def lm_tables(n: int, sign: int) -> dict:
    """Left-matmul tables for length n (the script's ``lm_tables``): numpy
    f32, bit-equal to the JAX package's."""
    n1, n2 = balanced_split(n)
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    f2r, f2i, f2s, f2d = dft_matrix_ext(n2, sign)
    twr, twi = twiddle_table(n1, n2, n, sign)
    return {
        "n1": n1, "n2": n2,
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "f2r": f2r, "f2i": f2i, "f2s": f2s, "f2d": f2d,
        "twr": twr, "twi": twi,
    }


def fused_fft_lm_plain(x, t: dict):
    """Plain torch version of :func:`fused_fft_lm` and the ``jnp_lm`` variant
    (JAX: ``fused_fft_jnp_lm``): batched matmuls in the kernel's order,
    Karatsuba stage 2 included."""
    b, n = x.shape
    n1, n2 = t["n1"], t["n2"]
    x3 = x.reshape(b, n1, n2)
    pr = t["f1r"] @ x3
    pi = t["f1i"] @ x3
    zr = pr * t["twr"] - pi * t["twi"]
    zi = pr * t["twi"] + pi * t["twr"]
    s1 = (zr + zi) @ t["f2r"]
    s2 = zr @ t["f2d"]
    s3 = zi @ t["f2s"]
    return (s1 - s3).transpose(1, 2).reshape(b, n), (s1 + s2).transpose(1, 2).reshape(b, n)


def fused_fft_lm(x, t: dict):
    """Real-input fused four-step in ONE launch (JAX: ``fused_fft_pallas_lm``).

    ``x``: (B, n) fp32; ``t``: :func:`lm_tables` on ``x``'s device, with n2 in
    :data:`LM_N2`.  Returns split-complex (B, n), natural order.
    """
    if _on_cpu(x, "fused_fft_lm"):
        COUNTS["fused_fft_lm"].plain_calls += 1
        return fused_fft_lm_plain(x, t)
    b, n = x.shape
    n1, n2 = t["n1"], t["n2"]
    if n != n1 * n2:
        raise ValueError(f"fused_fft_lm: x is (B, {n}), tables are n1={n1} x n2={n2}")
    geometry = lm_geometry(b, n1, n2, sm_count(x.device))
    names = ("f1r", "f1i", "twr", "twi", "f2r", "f2s", "f2d")
    shapes = {"x": (b, n), "f1r": (n1, n1), "f1i": (n1, n1), "twr": (n1, n2), "twi": (n1, n2),
              "f2r": (n2, n2), "f2s": (n2, n2), "f2d": (n2, n2)}
    _check("fused_fft_lm", x.device, {"x": x, **{k: t[k] for k in names}}, shapes)
    yr = torch.empty_like(x)
    yi = torch.empty_like(x)
    _launch(
        COUNTS, "fused_fft_lm", _build.library().gft_fused_lm,
        _ptr(x), *(_ptr(t[k]) for k in names), _ptr(yr), _ptr(yi), b, n1, n2, *geometry,
        _stream(x.device),
    )
    return yr, yi
