"""Enumerate the available backends and roundtrip through each.

TORCH (the port's kernels) and TORCH_FFT (``torch.fft``) run on ``device``;
NATIVE, listed where ``make -C native`` has built the host library, runs on
the host.  Gate: every roundtrip within 1e-3.

Run: python -m gpu_fft_tpu_torch.examples.backends
"""

import numpy as np

import gpu_fft_tpu_torch as gt


def main(device=None) -> int:
    x = np.array([0.0, 1.0, 2.0, 3.0, 2.0, 1.0, 0.0, -1.0], dtype=np.float32)
    print("Available backends:", [b.name for b in gt.available_backends()])
    ok = True
    for backend in gt.available_backends():
        re, im = gt.fft_with(x, backend, device=device)
        out = gt.ifft_with(re, im, backend, device=device)
        err = float(np.abs(out[: len(x)] - x).max())
        print(f"{backend.name:9s} roundtrip max error: {err:.3e}")
        ok &= err < 1e-3
    print("[OK]" if ok else "[FAIL]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
