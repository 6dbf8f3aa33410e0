"""Operator learning with the FNO model family.

Trains a 1-D Fourier Neural Operator to learn the antiderivative operator
u -> ∫u (a nonlocal operator that a local convolution cannot represent but
a spectral mix learns in a few dozen steps), then runs a 2-D FNO forward
pass on an image-sized input.  Every transform inside the model rides the
library's device dispatch, and the backward pass runs through the
transforms' autograd seams.

Run: python -m gpu_fft_tpu_torch.examples.fno
"""

import numpy as np
import torch

from gpu_fft_tpu_torch.config import resolve_device
from gpu_fft_tpu_torch.models import FNO1d, FNO2d, fit, make_train_step


def antiderivative_batch(rng, batch, length):
    """Band-limited u and its zero-mean antiderivative, both (B, L, 1)."""
    k = np.arange(1, 6)
    t = np.arange(length) / length
    amp = rng.standard_normal((batch, k.size))
    phase = rng.uniform(0, 2 * np.pi, (batch, k.size))
    arg = 2 * np.pi * k[None, :, None] * t + phase[..., None]
    u = np.einsum("bk,bkl->bl", amp, np.cos(arg))
    anti = np.einsum("bk,bkl->bl", amp / (2 * np.pi * k), np.sin(arg))
    return u[..., None].astype(np.float32), anti[..., None].astype(np.float32)


def main(device=None) -> int:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x_train, y_train = (torch.from_numpy(a).to(dev) for a in antiderivative_batch(rng, 32, 128))
    x_test, y_test = antiderivative_batch(rng, 8, 128)

    gen = torch.Generator().manual_seed(0)
    model = FNO1d(modes=8, width=24, depth=3, in_channels=1, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"FNO1d: {n_params} parameters, modes=8 width=24 depth=3")

    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = fit(make_train_step(model, opt), [(x_train, y_train)], 80)
    print(f"train mse: step 0 = {losses[0]:.5f}, step 79 = {losses[-1]:.6f}")

    with torch.no_grad():
        pred = model(torch.from_numpy(x_test).to(dev)).cpu().numpy()
    test_mse = float(np.mean((pred - y_test) ** 2))
    rel = test_mse / float(np.mean(y_test**2))
    print(f"held-out mse = {test_mse:.6f} (relative {rel:.4f})")
    ok = losses[-1] < losses[0] / 10 and rel < 0.1

    # 2-D path: one forward through an image-sized FNO.
    model2 = FNO2d(modes1=6, modes2=6, width=12, depth=2, in_channels=1, device=dev, generator=gen)
    x2 = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    with torch.no_grad():
        y2 = model2(torch.from_numpy(x2).to(dev))
    print(f"FNO2d forward: {x2.shape} -> {tuple(y2.shape)}")
    print(f"{'[OK]' if ok else '[FAIL]'} antiderivative operator learned")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
