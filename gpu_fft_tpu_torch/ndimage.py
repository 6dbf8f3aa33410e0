"""``scipy.ndimage`` drop-in namespace: the Fourier-domain filter family.

Port of ``gpu_fft_tpu/ndimage.py``.  The four fourier_* filters are spectral
multipliers (f64 host tables, f32 device multiplies); see
``ops/ndimage_fourier.py``.

Usage (scipy signatures)::

    import gpu_fft_tpu_torch as gt
    import gpu_fft_tpu_torch.ndimage as ndi
    fr, fi = gt.fft2_device(img)
    br, bi = ndi.fourier_gaussian_device(fr, fi, sigma=4)
    blurred = gt.ifft2_device(br, bi)[0]
"""

from .ops.ndimage_fourier import (  # noqa: F401
    fourier_ellipsoid,
    fourier_ellipsoid_device,
    fourier_gaussian,
    fourier_gaussian_device,
    fourier_shift,
    fourier_shift_device,
    fourier_uniform,
    fourier_uniform_device,
)

__all__ = [
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_ellipsoid",
    "fourier_shift",
    "fourier_gaussian_device",
    "fourier_uniform_device",
    "fourier_ellipsoid_device",
    "fourier_shift_device",
]
