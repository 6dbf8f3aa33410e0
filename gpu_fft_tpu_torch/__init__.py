"""gpu_fft_tpu_torch — the gpu_fft_tpu FFT library on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

Same split-complex fp32 API and conventions as the JAX package
``gpu_fft_tpu``: zero-padding to the next power of two, ``ifft`` returning
``[real | imag]`` scaled by 1/N, batches padded to their longest signal.
The host API takes numpy and returns numpy and runs on ``device`` (default
``"cuda"``, or ``GPU_FFT_TPU_TORCH_DEVICE``); ``*_device`` functions take and
return tensors.  ``rfft`` / ``irfft`` give and take the one-sided n/2 + 1
bins.  Autodiff runs through every transform (the kernels sit behind
``torch.autograd.Function``s); windows, STFT / ISTFT, the Welch family,
spectrograms, periodograms and the exact-length transform (``fft_exact``,
any n) build on it.  This package never imports jax.
"""

from .backends import Backend, available_backends, default_backend
from .ops.exact import fft_exact, fft_exact_device, ifft_exact, ifft_exact_device
from .ops.short_time_fft import ShortTimeFFT
from .ops.spectral import (
    coherence,
    coherence_device,
    csd,
    csd_device,
    lombscargle,
    one_sided_bins,
    periodogram,
    periodogram_device,
    power_spectrum_device,
    psd,
    psd_device,
    spectrogram,
    spectrogram_device,
    spectrogram_scipy,
    welch,
    welch_device,
)
from .ops.stft import (
    check_COLA,
    check_NOLA,
    closest_STFT_dual_window,
    istft,
    istft_device,
    istft_scipy,
    stft,
    stft_device,
    stft_scipy,
    window_table,
)
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
    "available_backends",
    "Backend",
    "calculate_frequencies",
    "calculate_one_sided_frequencies",
    "check_COLA",
    "check_NOLA",
    "closest_STFT_dual_window",
    "coherence",
    "coherence_device",
    "csd",
    "csd_device",
    "default_backend",
    "fft",
    "fft_batch",
    "fft_device",
    "fft_exact",
    "fft_exact_device",
    "fft_with",
    "fftfreq",
    "find_dominant_frequencies",
    "generate_sine_wave",
    "ifft",
    "ifft_batch",
    "ifft_device",
    "ifft_exact",
    "ifft_exact_device",
    "ifft_with",
    "irfft",
    "irfft_device",
    "istft",
    "istft_device",
    "istft_scipy",
    "lombscargle",
    "next_power_of_two",
    "one_sided_bins",
    "periodogram",
    "periodogram_device",
    "power_spectrum_device",
    "psd",
    "psd_device",
    "rfft",
    "rfft_device",
    "rfftfreq",
    "spectrogram",
    "spectrogram_device",
    "spectrogram_scipy",
    "stft",
    "stft_device",
    "stft_scipy",
    "welch",
    "welch_device",
    "window_table",
]
