"""Ahead-of-time export for serving: trace once, ship the artifact.

Port of ``gpu_fft_tpu/utils/serving.py`` on ``torch.export``.
:func:`export_transform` traces one (kind, batch, n) device transform into
an ``ExportedProgram``: the dispatch (plan choice, tables, kernel
geometry) is decided at export time, the plan's tables enter the program
as constants, and the hand-written kernels appear as the
``gpu_fft_tpu_torch::`` operators (``kernels/fused.py``).  A serving
process loads the artifact and runs it with no Python-side planning; it
needs ``import gpu_fft_tpu_torch``, which registers those operators and,
on a card, builds the CUDA library at the first launch.

Artifacts are per-(kind, batch, n) and per-device, like the reference's
per-variant shaders: the dispatch predicates (plan.py, tuning.py) branch on
concrete shapes at export time.  JAX's ``platforms`` argument becomes
``device`` (default: the card): an artifact runs on the device type it was
exported for.

CLI: ``python -m gpu_fft_tpu_torch export --kind fft --batch 16 -n 65536 -o fft.pt2``
and ``python -m gpu_fft_tpu_torch serve-check fft.pt2``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = [
    "EXPORT_KINDS",
    "export_transform",
    "save_transform",
    "load_transform",
    "exported_call",
]

EXPORT_KINDS = ("fft", "ifft", "rfft", "irfft", "roundtrip", "psd")


def _builders():
    """kind -> (callable, input shapes of a (b, n) call).  Each callable is
    the device-resident transform of the JAX builders
    (``gpu_fft_tpu/utils/serving.py:_builders``)."""
    from ..ops.spectral import power_spectrum_device
    from ..ops.transform import fft_device, ifft_device, irfft_device, rfft_device

    def one(b, n):
        return ((b, n),)

    def two(b, n):
        return ((b, n), (b, n))

    def half(b, n):
        return ((b, n // 2 + 1), (b, n // 2 + 1))

    return {
        "fft": (lambda x: fft_device(x), one),
        "ifft": (lambda r, i: ifft_device(r, i), two),
        "rfft": (lambda x: rfft_device(x), one),
        "irfft": (lambda r, i: irfft_device(r, i), half),
        "roundtrip": (lambda x: ifft_device(*fft_device(x))[0], one),
        "psd": (lambda x: power_spectrum_device(x), one),
    }


class _Transform(torch.nn.Module):
    """The module ``torch.export`` traces: one device transform."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_transform(kind: str, batch: int, n: int, device=None):
    """Trace one (kind, batch, n) transform on ``device`` (default: the card);
    returns a ``torch.export.ExportedProgram``.

    The transform runs once first on zero inputs (the plan tables of
    ``plan.on_device`` uploaded, the CUDA library built), so that the
    tables enter the program as constants; then ``torch.export.export``
    (non-strict) records it.
    """
    from ..config import resolve_device

    if kind not in EXPORT_KINDS:
        raise ValueError(f"kind must be one of {EXPORT_KINDS}, got {kind!r}")
    if n < 2 or n & (n - 1):
        raise ValueError(f"export requires power-of-two n >= 2, got {n}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = resolve_device(device)
    fn, shapes_of = _builders()[kind]
    args = tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes_of(batch, n))
    with torch.no_grad():
        fn(*args)  # warm the plan cache on dev: no table is made while tracing
    return torch.export.export(_Transform(fn), args, strict=False)


def save_transform(path: str, kind: str, batch: int, n: int, device=None) -> int:
    """Export one transform and write it to ``path`` (``torch.export.save``);
    returns the byte size."""
    import os

    torch.export.save(export_transform(kind, batch, n, device=device), path)
    return os.path.getsize(path)


def load_transform(path: str):
    """Read an artifact (``torch.export.load``); returns the
    ``ExportedProgram`` (run it with :func:`exported_call`).  Loading needs
    the ``gpu_fft_tpu_torch::`` operators, registered on import."""
    from ..kernels import fused  # noqa: F401  (registers the operators)

    return torch.export.load(path)


def input_specs(exported) -> list:
    """(shape, device) of each input an artifact takes (JAX: ``in_avals``)."""
    names = set(exported.graph_signature.user_inputs)
    return [(tuple(node.meta["val"].shape), node.meta["val"].device)
            for node in exported.graph.nodes if node.op == "placeholder" and node.name in names]


#: The callable module of each artifact, made once (``ep.module()`` builds a
#: new GraphModule on every call).
_MODULES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def exported_call(exported, *args):
    """Run an artifact on its device and return NumPy results — the minimal
    serving loop body.  Inputs are moved to the artifact's device as
    float32."""
    module = _MODULES.get(exported)
    if module is None:
        module = _MODULES[exported] = exported.module()
    specs = input_specs(exported)
    if len(args) != len(specs):
        raise ValueError(f"the artifact takes {len(specs)} input(s), got {len(args)}")
    ins = [torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev) for a, (_, dev) in zip(args, specs)]
    with torch.no_grad():
        out = module(*ins)
    if isinstance(out, (tuple, list)):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()
