"""A sine in white noise, as scipy.signal.welch's documented example makes
it: ``amplitude * sin(2*pi*frequency_hz*t)`` at ``t = arange(L) / fs``,
plus Gaussian noise of power ``noise_power`` V**2/Hz (variance
``noise_power * fs / 2``), on every row.  The seed draws the noise."""

from __future__ import annotations

import math

import numpy as np
import torch


def make(shape, data, seed: int, k: int, device) -> torch.Tensor:
    rng = np.random.default_rng([seed % (1 << 64), k])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    fs = data["fs"]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    x.mul_(math.sqrt(data["noise_power"] * fs / 2.0))
    t = torch.arange(shape[-1], device=device, dtype=torch.float64) / fs
    x += data["amplitude"] * torch.sin(2.0 * math.pi * data["frequency_hz"] * t)
    return x.to(torch.float32)
