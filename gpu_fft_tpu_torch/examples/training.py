"""Training through the transform: learn FIR taps with torch.autograd.

Fits a 64-tap filter to a target band-pass frequency response by gradient
descent on a spectral loss; the loss and its gradient run through the
library's transform (``rfft_device``: K2 at 1,024 points on a card, behind
its autograd Function), so the FFT sits inside the backward pass.  The
learned filter is then applied with ``fftfilt`` and judged by ``welch``.

Run: python -m gpu_fft_tpu_torch.examples.training
"""

import numpy as np
import torch
import torch.nn.functional as F

import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.config import resolve_device

N_TAPS = 64
N_FFT = 1024
H = N_FFT // 2 + 1


def main(device=None) -> int:
    dev = resolve_device(device)
    # Target: a 0.2..0.3 (normalized) band-pass magnitude response.
    freqs = np.arange(H) / N_FFT
    target = ((freqs >= 0.2) & (freqs <= 0.3)).astype(np.float32)
    target_dev = torch.from_numpy(target).to(dev)

    def response(taps):
        # zero-pad the taps to the analysis length; one-sided magnitude
        hr, hi = gt.rfft_device(F.pad(taps, (0, N_FFT - N_TAPS)))
        return torch.sqrt(hr**2 + hi**2 + 1e-12)

    def loss(taps):
        return torch.mean((response(taps) - target_dev) ** 2)

    def step(taps, lr):
        taps = taps.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(taps), taps)
        return (taps - lr * g).detach()

    taps = torch.zeros(N_TAPS, device=dev)
    taps[0] = 1.0  # identity filter
    with torch.no_grad():
        l0 = float(loss(taps))
    for _ in range(500):
        taps = step(taps, 0.5)
    with torch.no_grad():
        l1 = float(loss(taps))
    print(f"spectral MSE: {l0:.5f} -> {l1:.5f} after 500 gradient steps")

    # Compare with the classical windowed design as a sanity reference.
    ref = gt.firwin(N_TAPS + 1, [0.2, 0.3], window="hamming", pass_zero=False, fs=1.0)
    ref_resp = np.abs(np.fft.rfft(ref, N_FFT))
    ref_mse = float(np.mean((ref_resp - target) ** 2))
    print(f"firwin(65) reference MSE: {ref_mse:.5f} (different tap budget, for scale)")

    # Apply the learned filter with the library's streaming path.
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8192).astype(np.float32)
    y = gt.fftfilt(x, taps.cpu().numpy(), device=device)
    f, pxx = gt.welch(y, fs=1.0, nperseg=256, device=device)
    band = (f >= 0.2) & (f <= 0.3)
    stop = (f < 0.15) | (f > 0.35)
    ratio = float(pxx[band].mean() / pxx[stop].mean())
    print(f"filtered noise: pass-band/stop-band power ratio {ratio:.1f}x")

    ok = l1 < 0.2 * l0 and ratio > 3.0
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
