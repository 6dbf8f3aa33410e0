"""gpu_fft_tpu_torch — the gpu_fft_tpu FFT library on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

Same split-complex fp32 API and conventions as the JAX package
``gpu_fft_tpu``: zero-padding to the next power of two, ``ifft`` returning
``[real | imag]`` scaled by 1/N, batches padded to their longest signal.
The host API takes numpy and returns numpy and runs on ``device`` (default
``"cuda"``, or ``GPU_FFT_TPU_TORCH_DEVICE``); ``*_device`` functions take and
return tensors.  ``rfft`` / ``irfft`` give and take the one-sided n/2 + 1
bins.  This package never imports jax.
"""

from .backends import Backend, available_backends, default_backend
from .ops.spectral import one_sided_bins, power_spectrum_device, psd, psd_device
from .ops.transform import (
    fft,
    fft_batch,
    fft_device,
    fft_with,
    ifft,
    ifft_batch,
    ifft_device,
    ifft_with,
    irfft,
    irfft_device,
    next_power_of_two,
    rfft,
    rfft_device,
)
from .utils.signal import (
    calculate_frequencies,
    calculate_one_sided_frequencies,
    fftfreq,
    find_dominant_frequencies,
    generate_sine_wave,
    rfftfreq,
)

__version__ = "0.1.0"

__all__ = [
    "Backend",
    "available_backends",
    "calculate_frequencies",
    "calculate_one_sided_frequencies",
    "default_backend",
    "fft",
    "fft_batch",
    "fft_device",
    "fft_with",
    "fftfreq",
    "find_dominant_frequencies",
    "generate_sine_wave",
    "ifft",
    "ifft_batch",
    "ifft_device",
    "ifft_with",
    "irfft",
    "irfft_device",
    "next_power_of_two",
    "one_sided_bins",
    "power_spectrum_device",
    "psd",
    "psd_device",
    "rfft",
    "rfft_device",
    "rfftfreq",
]
