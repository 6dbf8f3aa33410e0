"""One strain segment of a compact-binary search and a block of templates,
in the frequency domain, as PyCBC's ``pycbc_inspiral`` hands them to
``matched_filter_core``: an input of shape (T + 2, 2, h), h = N/2 + 1
one-sided bins of an N-sample segment at ``sample_rate``.

- Row 0, s̃ (re, im): Gaussian noise coloured by S, 0.5·√(S/Δf) a part
  (``pycbc.noise.gaussian.frequency_noise_from_psd``), plus template 0 of
  the block at a seeded coalescence time inside the valid window
  [``segment_start_pad_s``, duration − ``segment_end_pad_s``), a whole
  sample, and a seeded phase, scaled to optimal SNR ``snr`` over
  [f_low, Nyquist).
- Row 1, S (re; im zero): the analytic Advanced-LIGO fit
  1e-49·[x^-4.14 − 5x^-2 + 111(1 − x² + x⁴/2)/(1 + x²/2)], x = f / 215 Hz
  (Arun et al. 2005, PRD 71 084008), held at its f_low value below f_low
  so that it stays finite at DC.
- Rows 2 …: T Newtonian stationary-phase chirps (Cutler & Flanagan 1994),
  h̃ = 𝓜^{5/6} f^{-7/6} e^{−iΨ}, Ψ = 2πf t_c − φ_c − π/4 + (3/128)(π𝓜f)^{-5/3},
  t_c = φ_c = 0, zero outside [f_low, f_ISCO), f_ISCO = 1/(6^{3/2}πM),
  M = 𝓜·4^{3/5} (equal masses), 𝓜 drawn from the seed in ``chirp_mass``
  (solar masses, as G𝓜/c³ seconds).

Strain and S are scaled by PyCBC's ``DYN_RANGE_FAC`` (2^69) and its square,
as PyCBC stores single-precision data, so that S is a normal fp32 number.
Phases are computed in float64 and the values stored as fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MTSUN_S = 4.925490947641267e-06  # G M_sun / c^3 (LAL's MTSUN_SI), seconds
DYN_RANGE_FAC = 5.9029581035870565e20  # pycbc.DYN_RANGE_FAC, 2^69


def aligo_psd(f: torch.Tensor, f_low: float) -> torch.Tensor:
    """The analytic Advanced-LIGO one-sided PSD at frequencies ``f`` (Hz,
    float64), 1/Hz, held at its ``f_low`` value below ``f_low``."""
    x = torch.clamp(f, min=f_low) / 215.0
    x2 = x * x
    return 1e-49 * (x.pow(-4.14) - 5.0 / x2 + 111.0 * (1.0 - x2 + 0.5 * x2 * x2) / (1.0 + 0.5 * x2))


def chirps(f: torch.Tensor, mchirp_s: torch.Tensor, f_low: float, t_c=0.0, phi_c=0.0):
    """Split-complex Newtonian chirps, float64, one row per chirp mass
    (seconds) of ``mchirp_s``: (re, im) of shape (len(mchirp_s), len(f))."""
    mc = mchirp_s[:, None]
    f_isco = 1.0 / (6.0 ** 1.5 * math.pi * mc * 4.0 ** 0.6)
    band = (f[None, :] >= f_low) & (f[None, :] < f_isco)
    fs = torch.where(band, f[None, :], torch.full_like(f[None, :], f_low))  # no 0 ** negative
    psi = (2.0 * math.pi * fs * t_c - phi_c - math.pi / 4.0
           + (3.0 / 128.0) * (math.pi * mc * fs).pow(-5.0 / 3.0))
    amp = torch.where(band, mc.pow(5.0 / 6.0) * fs.pow(-7.0 / 6.0), torch.zeros_like(fs))
    return amp * torch.cos(psi), -amp * torch.sin(psi)


def _draws(shape, data, seed: int, k: int):
    """What the seed decides for input ``k``: the noise generator's seed,
    the T chirp masses (solar masses), template 0's coalescence sample and
    its phase."""
    n = 2 * (shape[-1] - 1)
    fs = float(data["sample_rate"])
    rng = np.random.default_rng([seed % (1 << 64), k])
    noise_seed = int(rng.integers(0, 1 << 62))
    mchirp = rng.uniform(*data["chirp_mass"], size=shape[0] - 2)
    first = int(round(data["segment_start_pad_s"] * fs))
    last = n - int(round(data["segment_end_pad_s"] * fs))
    return noise_seed, mchirp, int(rng.integers(first, last)), float(rng.uniform(0.0, 2.0 * math.pi))


def injection(shape, data, seed: int, k: int = 0) -> int:
    """The sample at which :func:`make` puts template 0 into input ``k``."""
    return _draws(shape, data, seed, k)[2]


def make(shape, data, seed: int, k: int, device) -> torch.Tensor:
    rows, parts, h = shape
    if parts != 2 or rows < 3:
        raise ValueError(f"gw_segment: shape must be (T + 2, 2, h) with T >= 1, got {tuple(shape)}")
    n = 2 * (h - 1)
    fs = float(data["sample_rate"])
    df = fs / n
    f_low = float(data["f_low"])
    kmin, kmax = int(f_low / df), n // 2
    noise_seed, mchirp, at, phi_c = _draws(shape, data, seed, k)
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    f64 = dict(dtype=torch.float64, device=device)

    f = torch.arange(h, **f64) * df
    psd = aligo_psd(f, f_low) * DYN_RANGE_FAC ** 2
    mchirp = torch.as_tensor(mchirp, **f64) * MTSUN_S
    tr, ti = chirps(f, mchirp, f_low)

    # Template 0, coalescing at sample ``at``, at optimal SNR ``snr``.
    ir, ii = chirps(f, mchirp[:1], f_low, at / fs, phi_c)
    sigmasq = 4.0 * df * ((ir * ir + ii * ii)[0, kmin:kmax] / psd[kmin:kmax]).sum()
    scale = data["snr"] / float(sigmasq.sqrt())

    sigma = 0.5 * (psd / df).sqrt()
    x = torch.empty((rows, 2, h), **f64)
    x[0, 0] = torch.randn(h, generator=gen, **f64) * sigma + scale * ir[0]
    x[0, 1] = torch.randn(h, generator=gen, **f64) * sigma + scale * ii[0]
    x[1, 0] = psd
    x[1, 1] = 0.0
    x[2:, 0] = tr
    x[2:, 1] = ti
    return x.to(torch.float32)
