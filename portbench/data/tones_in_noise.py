"""Gaussian noise plus tones: the data of a recording (tones along each row)
or of images (plane waves over each image)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), k])


def make(shape, data, seed: int, k: int, device) -> torch.Tensor:
    """Gaussian noise of ``noise_std`` plus ``tones`` sinusoids along the
    last ``tone_dims`` axes (1: along each row; 2: plane waves over each
    image), with amplitudes, frequencies (cycles per sample) and phases drawn
    from the seed; fp32."""
    rng = _rng(seed, k)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    x.mul_(data["noise_std"])
    dims = data["tone_dims"]
    lead = math.prod(shape[:-dims])
    tones = data["tones"]
    amp = torch.from_numpy(rng.uniform(*data["amplitude"], size=(lead, tones))).to(device)
    phase = torch.from_numpy(rng.uniform(0.0, 2.0 * math.pi, size=(lead, tones))).to(device)
    freq = torch.from_numpy(rng.uniform(*data["frequency"], size=(lead, tones, dims))).to(device)
    flat = x.view(lead, *shape[-dims:])
    axes = [torch.arange(s, device=device, dtype=torch.float64) for s in shape[-dims:]]
    for t in range(tones):
        arg = phase[:, t].view(lead, *([1] * dims)).clone()
        for d, ax in enumerate(axes):
            view = [1] * dims
            view[d] = -1
            arg = arg + 2.0 * math.pi * freq[:, t, d].view(lead, *([1] * dims)) * ax.view(*view)
        flat += (amp[:, t].view(lead, *([1] * dims)) * torch.sin(arg)).to(torch.float32)
    return x
