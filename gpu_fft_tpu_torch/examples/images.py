"""Fourier-domain image processing: fft2 + the scipy.ndimage filter family.

Gaussian blur, sub-pixel shift, and box blur — all as spectral multiplies
between one forward and one inverse 2-D transform, every step a device op
on ``device``.

Run: python -m gpu_fft_tpu_torch.examples.images
"""

import numpy as np

import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.ndimage as ndi


def main(device=None) -> int:
    # A synthetic "image": a bright square on a gradient background.
    h, w = 128, 128
    yy, xx = np.mgrid[0:h, 0:w]
    img = (0.2 * xx / w + ((40 <= yy) & (yy < 88) & (40 <= xx) & (xx < 88))).astype(
        np.float32
    )

    def inverse(sr, si):
        return gt.ifft2_device(sr, si)[0].cpu().numpy()

    # One forward transform, three filtered inverses.
    fr, fi = gt.fft2_device(img, device=device)

    # Gaussian blur (sigma in pixels): the sharp square edge spreads out.
    blur = inverse(*ndi.fourier_gaussian_device(fr, fi, sigma=3.0))
    print(f"gaussian blur:  sharpest edge {np.abs(np.diff(img, axis=1)).max():.2f} -> "
          f"{np.abs(np.diff(blur, axis=1)).max():.2f}")

    # Sub-pixel shift (a phase ramp — impossible in the spatial domain).
    shifted = inverse(*ndi.fourier_shift_device(fr, fi, (10.5, -20.25)))
    p0 = np.unravel_index(np.argmax(img), img.shape)
    p1 = np.unravel_index(np.argmax(shifted), shifted.shape)
    print(f"fourier shift:  brightest pixel {tuple(map(int, p0))} -> {tuple(map(int, p1))} "
          f"(shift (+10.5, -20.25))")

    # Box blur via the uniform filter.
    box = inverse(*ndi.fourier_uniform_device(fr, fi, size=9.0))
    print(f"uniform 9x9:    max {img.max():.2f} -> {box.max():.2f} (plateau preserved)")

    # Round-trip sanity: an identity filter (sigma=0) returns the image.
    back = inverse(*ndi.fourier_gaussian_device(fr, fi, sigma=0.0))
    err = np.abs(back - img).max()
    limit = 5 * np.log2(h * w) * np.finfo(np.float32).eps * np.abs(img).max()
    status = "[OK]" if err <= max(limit, 1e-5) else "[FAIL]"
    print(f"roundtrip:      max error {err:.3e} {status}")
    return 0 if status == "[OK]" else 1


if __name__ == "__main__":
    raise SystemExit(main())
