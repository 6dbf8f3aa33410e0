"""Planning thresholds, precision and device selection for the PyTorch port.

The size thresholds are the JAX package's (``gpu_fft_tpu/config.py``), so
both packages factor every length the same way and compute from identical
tables.
"""

from __future__ import annotations

import os

import torch

# Largest transform computed as ONE direct DFT matrix product.
DIRECT_MAX = 512

# Largest transform run as a fused four-step; above it the staged path
# (kernels/large.py) factors n = n1 * n2 with n2 <= FUSED_MAX.
FUSED_MAX = 65536

# Maximum supported transform length (two staged levels cover FUSED_MAX**2).
MAX_N = 1 << 24

# Gauss/Karatsuba 3-multiplication complex products in the plain engines
# (kernels/fused_torch.py), as in the JAX package.
KARATSUBA = True

# Precision: only "full" exists in the port — IEEE fp32 everywhere with TF32
# off.  TF32 keeps ~10 mantissa bits (~5e-4 relative error), far outside the
# 5*log2(N)*eps roundtrip gate (6.1e-6 at n = 1024).
PRECISION = os.environ.get("GPU_FFT_TPU_PRECISION", "full").strip().lower()
if PRECISION != "full":
    raise NotImplementedError(
        f"GPU_FFT_TPU_PRECISION={PRECISION!r}: the PyTorch port implements only 'full' "
        "(fp32 with TF32 off); 'high' and 'fast' are not ported yet"
    )

DEVICE_ENV_VAR = "GPU_FFT_TPU_TORCH_DEVICE"

# Default backend override, the JAX package's variable (read by
# backends.default_backend, which maps the JAX package's names).
BACKEND_ENV_VAR = "GPU_FFT_TPU_BACKEND"


def env_backend_name() -> str | None:
    """The backend name requested through ``GPU_FFT_TPU_BACKEND``, or None."""
    v = os.environ.get(BACKEND_ENV_VAR)
    return v.strip().lower() if v else None


def apply_precision() -> None:
    """Pin fp32 matmuls to full IEEE precision (TF32 off) for this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device a host-API call runs on.

    ``device`` wins; otherwise ``GPU_FFT_TPU_TORCH_DEVICE``, else ``"cuda"``.
    Asking for CUDA where there is none raises — there is no CPU fallback.
    """
    if device is None:
        device = os.environ.get(DEVICE_ENV_VAR, "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' or set {DEVICE_ENV_VAR}=cpu"
        )
    return dev

