"""TORCH backend: the port's engines (kernels/large.py:transform_any)."""

from __future__ import annotations

from ..config import apply_precision
from ..kernels.large import transform_any

__all__ = ["forward", "inverse"]


def forward(x):
    """(B, n) real fp32 -> split-complex spectrum ((B, n), (B, n))."""
    apply_precision()
    return transform_any(x, None, x.shape[-1], -1)


def inverse(xr, xi):
    """(B, n) split-complex spectrum -> signal normalized by 1/n."""
    apply_precision()
    n = xr.shape[-1]
    return transform_any(xr, xi, n, +1, scale=1.0 / n)
