"""Fourier Neural Operators riding the library's device FFT dispatch.

Port of ``gpu_fft_tpu/models/fno.py`` as ``torch.nn`` modules: the FNO
(Li et al., "Fourier Neural Operator for Parametric PDEs", ICLR 2021).
One block is

    lift -> [ rfft -> truncate modes -> complex channel mix (four real
              einsums) -> zero-pad -> irfft  (+) pointwise 1x1 conv ] x depth
         -> project

The transforms are the library's: ``rfft_device`` / ``irfft_device`` for
1-D and ``rfft2_device`` / ``irfft2_device`` for 2-D, so a record longer
than 65,536 samples runs K3 inside the step and autograd runs through the
kernels' ``torch.autograd.Function`` seams (``kernels/large.py``).

Layout contract: channels-last activations ``(B, spatial..., C)``, as the
JAX package's flax modules take them; the channel dim folds into the FFT
batch (permute, then contiguous), so every transform is one batched
dispatch.  Spectra are split-complex ``(real, imag)`` f32 pairs.

Differences from the flax modules: torch infers no shapes, so every
constructor takes ``in_channels`` (the data's channels, before the grid),
and ``device`` (default ``"cuda"``, or ``GPU_FFT_TPU_TORCH_DEVICE``) and a
``generator`` for the initial weights, drawn on the CPU from flax's
initializers (normal(1/(C*O)) for the spectral weights, LeCun normal
kernels and zero biases for the dense layers).  The submodule and
parameter names are flax's (``lift``, ``spec{i}``, ``pw{i}``, ``proj0``,
``proj1``; ``w_real``/``w_imag``, ``w1_real`` … ``w2_imag``), so
:func:`load_flax_params` carries a flax parameter tree across one to one.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import apply_precision, resolve_device
from ..ops.fft2d import irfft2_device, rfft2_device
from ..ops.transform import irfft_device, rfft_device

__all__ = ["SpectralConv1d", "SpectralConv2d", "FNO1d", "FNO2d", "append_grid", "load_flax_params"]


def _cmul_mix(yr, yi, wr, wi):
    """Complex channel contraction ``(B, C, *modes) x (C, O, *modes)``.

    One complex multiply-accumulate over the channel axis per kept mode:
    four real einsums with the mode grid as free indices.  Split-complex
    in, split-complex out.
    """
    sub = "xy"[: yr.dim() - 2]
    spec = f"bc{sub},co{sub}->bo{sub}"
    rr = torch.einsum(spec, yr, wr) - torch.einsum(spec, yi, wi)
    ii = torch.einsum(spec, yr, wi) + torch.einsum(spec, yi, wr)
    return rr, ii


def _normal(shape, std: float, generator):
    """flax's ``initializers.normal(std)``, drawn on the CPU."""
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _dense(fan_in: int, features: int, generator) -> nn.Linear:
    """flax's ``nn.Dense`` initialisation: a LeCun-normal kernel (truncated
    at two deviations, rescaled to unit variance) and a zero bias."""
    layer = nn.utils.skip_init(nn.Linear, fan_in, features)
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        layer.bias.zero_()
    return layer


def _check_channels(c: int, in_channels: int, name: str) -> None:
    if c != in_channels:
        raise ValueError(f"{name} was built for {in_channels} input channels, got {c}")


class SpectralConv1d(nn.Module):
    """Spectral convolution: per-mode dense channel mix in rfft space.

    Keeps the ``modes`` lowest frequency bins of a length-``L`` signal
    (power-of-two ``L``), mixes channels with a learned complex matrix per
    bin, zero-fills the rest, and inverts.  A global-receptive-field
    convolution for the cost of two transforms and four einsums.
    """

    def __init__(self, out_channels: int, modes: int, *, in_channels: int, device=None, generator=None):
        super().__init__()
        self.in_channels, self.out_channels, self.modes = in_channels, out_channels, modes
        scale = 1.0 / (in_channels * out_channels)
        shape = (in_channels, out_channels, modes)
        self.w_real = _normal(shape, scale, generator)
        self.w_imag = _normal(shape, scale, generator)
        self.to(resolve_device(device))

    def forward(self, x):
        """``x``: (B, L, C) real f32 -> (B, L, out_channels)."""
        b, length, c = x.shape
        half = length // 2 + 1
        if not (0 < self.modes <= half):
            raise ValueError(f"modes must be in [1, {half}], got {self.modes}")
        _check_channels(c, self.in_channels, "SpectralConv1d")
        m, o = self.modes, self.out_channels
        apply_precision()
        # (B, L, C) -> (B*C, L): channels fold into the FFT batch.
        xc = x.permute(0, 2, 1).contiguous().reshape(b * c, length)
        yr, yi = rfft_device(xc)
        yr = yr.reshape(b, c, half)[:, :, :m]
        yi = yi.reshape(b, c, half)[:, :, :m]
        zr, zi = _cmul_mix(yr, yi, self.w_real, self.w_imag)
        zr = F.pad(zr, (0, half - m)).reshape(b * o, half)
        zi = F.pad(zi, (0, half - m)).reshape(b * o, half)
        out = irfft_device(zr, zi).reshape(b, o, length)
        return out.permute(0, 2, 1)


class SpectralConv2d(nn.Module):
    """2-D spectral convolution over the rfft2 corner modes.

    Keeps ``modes1`` row frequencies from EACH end of the height axis (the
    positive and negative low frequencies — the one-sided rfft2 layout
    stores them at the top and bottom of the row axis) and the ``modes2``
    lowest column bins, as in the original FNO.  Transforms ride
    ``rfft2_device`` / ``irfft2_device``.
    """

    def __init__(self, out_channels: int, modes1: int, modes2: int, *, in_channels: int, device=None,
                 generator=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes1, self.modes2 = modes1, modes2
        scale = 1.0 / (in_channels * out_channels)
        shape = (in_channels, out_channels, modes1, modes2)
        self.w1_real = _normal(shape, scale, generator)
        self.w1_imag = _normal(shape, scale, generator)
        self.w2_real = _normal(shape, scale, generator)
        self.w2_imag = _normal(shape, scale, generator)
        self.to(resolve_device(device))

    def forward(self, x):
        """``x``: (B, H, W, C) real f32 -> (B, H, W, out_channels)."""
        b, h, w, c = x.shape
        hw = w // 2 + 1
        if not (0 < self.modes1 <= h // 2):
            raise ValueError(f"modes1 must be in [1, {h // 2}], got {self.modes1}")
        if not (0 < self.modes2 <= hw):
            raise ValueError(f"modes2 must be in [1, {hw}], got {self.modes2}")
        _check_channels(c, self.in_channels, "SpectralConv2d")
        m1, m2, o = self.modes1, self.modes2, self.out_channels
        apply_precision()
        xc = x.permute(0, 3, 1, 2).contiguous().reshape(b * c, h, w)
        yr, yi = rfft2_device(xc)
        yr = yr.reshape(b, c, h, hw)
        yi = yi.reshape(b, c, h, hw)

        tr, ti = _cmul_mix(yr[:, :, :m1, :m2], yi[:, :, :m1, :m2], self.w1_real, self.w1_imag)
        br, bi = _cmul_mix(yr[:, :, h - m1 :, :m2], yi[:, :, h - m1 :, :m2], self.w2_real, self.w2_imag)
        gap = tr.new_zeros(b, o, h - 2 * m1, m2)
        zr = F.pad(torch.cat([tr, gap, br], dim=2), (0, hw - m2)).reshape(b * o, h, hw)
        zi = F.pad(torch.cat([ti, gap, bi], dim=2), (0, hw - m2)).reshape(b * o, h, hw)
        out = irfft2_device(zr, zi).reshape(b, o, h, w)
        return out.permute(0, 2, 3, 1)


def append_grid(x):
    """Append normalized coordinate channels to ``(B, spatial..., C)``.

    The standard FNO input featurization: the model sees where each sample
    sits in the domain.  1-D inputs gain one channel, 2-D inputs two; the
    coordinates are ``k * (1/s)`` in f32, as ``jnp.linspace(0, 1, s,
    endpoint=False)`` computes them.
    """
    b = x.shape[0]
    spatial = tuple(x.shape[1:-1])
    coords = [torch.arange(s, dtype=torch.float32, device=x.device) * (1.0 / s) for s in spatial]
    grids = torch.meshgrid(*coords, indexing="ij")
    tiled = [g[None, ..., None].expand(b, *spatial, 1).to(x.dtype) for g in grids]
    return torch.cat([x, *tiled], dim=-1)


class _FNOBase(nn.Module):
    """Shared lift -> spectral blocks -> project scaffold."""

    def _build(self, in_channels: int, grid_channels: int, make_spectral, device, generator) -> None:
        self.lift = _dense(in_channels + grid_channels, self.width, generator)
        for i in range(self.depth):
            setattr(self, f"spec{i}", make_spectral())
            setattr(self, f"pw{i}", _dense(self.width, self.width, generator))  # 1x1 conv skip
        self.proj0 = _dense(self.width, 2 * self.width, generator)
        self.proj1 = _dense(2 * self.width, self.out_channels, generator)
        self.to(resolve_device(device))

    def forward(self, x):
        apply_precision()
        if self.with_grid:
            x = append_grid(x)
        x = self.lift(x)
        for i in range(self.depth):
            y = getattr(self, f"spec{i}")(x) + getattr(self, f"pw{i}")(x)
            x = F.gelu(y, approximate="tanh") if i < self.depth - 1 else y  # flax's nn.gelu
        x = F.gelu(self.proj0(x), approximate="tanh")
        return self.proj1(x)


class FNO1d(_FNOBase):
    """1-D Fourier Neural Operator: ``(B, L, in_channels) -> (B, L, out_channels)``.

    ``L`` must be a power of two (the library's native dispatch domain;
    use ``gpu_fft_tpu_torch.resample_device`` to regrid other inputs).
    """

    def __init__(self, modes: int = 16, width: int = 64, depth: int = 4, out_channels: int = 1,
                 with_grid: bool = True, *, in_channels: int, device=None, generator=None):
        super().__init__()
        self.modes, self.width, self.depth = modes, width, depth
        self.out_channels, self.with_grid = out_channels, with_grid
        self._build(in_channels, 1 if with_grid else 0,
                    lambda: SpectralConv1d(width, modes, in_channels=width, device="cpu", generator=generator),
                    device, generator)


class FNO2d(_FNOBase):
    """2-D Fourier Neural Operator: ``(B, H, W, in_channels) -> (B, H, W, out_channels)``.

    Power-of-two sides.
    """

    def __init__(self, modes1: int = 12, modes2: int = 12, width: int = 32, depth: int = 4,
                 out_channels: int = 1, with_grid: bool = True, *, in_channels: int, device=None,
                 generator=None):
        super().__init__()
        self.modes1, self.modes2, self.width, self.depth = modes1, modes2, width, depth
        self.out_channels, self.with_grid = out_channels, with_grid
        self._build(in_channels, 2 if with_grid else 0,
                    lambda: SpectralConv2d(width, modes1, modes2, in_channels=width, device="cpu",
                                           generator=generator),
                    device, generator)


def _flatten(tree, prefix: str = "") -> dict:
    """A nested mapping of arrays as ``{"a.b": array}``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree into ``model`` in place, and return it.

    ``params`` is the JAX module's ``variables["params"]`` as a tree of
    arrays (numpy, or anything ``np.asarray`` takes).  A dense layer's
    ``kernel`` (in, out) becomes ``Linear.weight`` (out, in) and its
    ``bias`` carries as it is; the spectral weights carry as they are.  A
    missing or extra key, or a wrong shape, raises ``ValueError``.
    """
    flat = {}
    for key, arr in _flatten(params).items():
        if key.endswith(".kernel"):
            flat[key[: -len("kernel")] + "weight"] = arr.T
        else:
            flat[key] = arr
    own = dict(model.named_parameters())
    missing, extra = sorted(own.keys() - flat.keys()), sorted(flat.keys() - own.keys())
    if missing or extra:
        raise ValueError(f"load_flax_params: the trees differ: missing {missing}, extra {extra}")
    for key, p in own.items():
        if tuple(flat[key].shape) != tuple(p.shape):
            raise ValueError(f"load_flax_params: {key} has shape {tuple(flat[key].shape)}, "
                             f"the model's is {tuple(p.shape)}")
    with torch.no_grad():
        for key, p in own.items():
            p.copy_(torch.from_numpy(np.array(flat[key])))  # a writable copy
    return model
