"""Faults planted under the timed path, for the checks that ``correct``
catches them: half of the batch left out, and one answer altered where it
is produced.  ``Broken`` stands in for the program with a fault in each of
its entry ops."""

from __future__ import annotations

import torch


def half_batch(kind, op, x):
    """The op on half of the batch, the rest left out: Welch averages over the
    first half of the segments; one image loses half of its rows; a batch
    of rows or images repeats its first half in place of the second."""
    if kind == "welch":
        return op(x[:, : x.shape[-1] // 2].contiguous())
    if x.shape[0] == 1:
        y = x.clone()
        y[:, y.shape[1] // 2:] = 0
        return op(y)
    half = x.shape[0] // 2
    yr, yi = op(x[:half].contiguous())
    rest = x.shape[0] - half
    return torch.cat([yr, yr[:rest]]), torch.cat([yi, yi[:rest]])


def altered(out):
    """One answer altered: 1e-3 of max|out| added at one place of the output."""
    t = out[0] if isinstance(out, tuple) else out
    t = t.clone(memory_format=torch.contiguous_format)
    flat = t.view(-1)
    flat[flat.numel() // 3] += 1e-3 * float(t.abs().max())
    return (t, out[1]) if isinstance(out, tuple) else t


ENTRIES = {"fft_device": "fft", "fft2_device": "fft2", "welch_device": "welch"}


class Broken:
    """The program with ``fault`` ("half_batch" or "altered") planted in each
    entry op; every other attribute is the program's own."""

    def __init__(self, port, fault: str):
        self._port = port
        self._fault = fault

    def __getattr__(self, name):
        real = getattr(self._port, name)
        if name not in ENTRIES:
            return real
        kind = ENTRIES[name]

        def entry(x, *args, **kwargs):
            def op(y):
                return real(y, *args, **kwargs)

            if self._fault == "half_batch":
                return half_batch(kind, op, x)
            out = op(x)
            if kind == "welch":  # (freqs, psd): the PSD is the answer
                return out[0], altered(out[1])
            return altered(out)

        return entry
