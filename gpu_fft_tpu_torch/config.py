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

# Precision mode (``GPU_FFT_TPU_PRECISION``), the JAX package's three:
#   "full" (default) -- fp32 products everywhere (TF32 off); the only mode
#                       within the 5*log2(N)*eps roundtrip gate;
#   "high"           -- the torch engines take bf16x3 products (each operand
#                       split a = hi + lo in bf16, hi*hi + hi*lo + lo*hi
#                       summed in fp32); the kernels K1/K2/K3 are not used
#                       (``plan.route``);
#   "fast"           -- bf16x1 products (the operands rounded to bf16, fp32
#                       accumulation) in the engines, and K1/K2/K3 run their
#                       bf16 tensor-core counterparts K1F/K2F/K3F.
# TF32 (a 10-bit mantissa) is none of these and stays off in every mode.
# The mode is read at call time, so setting ``PRECISION`` in a running
# process switches it for the next call.
PRECISION = os.environ.get("GPU_FFT_TPU_PRECISION", "full").strip().lower()
if PRECISION not in ("full", "high", "fast"):
    raise ValueError(
        f"GPU_FFT_TPU_PRECISION must be one of full|high|fast, got {PRECISION!r}"
    )


def matmul_precision() -> str:
    """The product the torch engines take in the current mode: ``"fp32"``,
    ``"bf16x3"`` or ``"bf16x1"`` (JAX: ``matmul_precision``).  An unknown
    mode raises KeyError."""
    return {"full": "fp32", "high": "bf16x3", "fast": "bf16x1"}[PRECISION]


def mosaic_precision() -> str:
    """The product the kernels take in the current mode (JAX:
    ``mosaic_precision``): ``"bf16x1"`` under "fast" (K1F/K2F/K3F), else
    ``"fp32"`` (K1/K2/K3; the dispatch keeps "high" away from them)."""
    return "bf16x1" if PRECISION == "fast" else "fp32"


DEVICE_ENV_VAR = "GPU_FFT_TPU_TORCH_DEVICE"

# Default backend override, the JAX package's variable (read by
# backends.default_backend, which maps the JAX package's names).
BACKEND_ENV_VAR = "GPU_FFT_TPU_BACKEND"

# Path override for the NATIVE backend's host C++ library (built by
# ``make -C native``), the JAX package's variable.
NATIVE_LIB_ENV_VAR = "GPU_FFT_TPU_NATIVE_LIB"


def env_backend_name() -> str | None:
    """The backend name requested through ``GPU_FFT_TPU_BACKEND``, or None."""
    v = os.environ.get(BACKEND_ENV_VAR)
    return v.strip().lower() if v else None


def apply_precision() -> None:
    """Pin fp32 matmuls to full IEEE precision (TF32 off) for this process,
    whatever the mode: "high" and "fast" round their operands to bf16
    explicitly and never go through TF32."""
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

