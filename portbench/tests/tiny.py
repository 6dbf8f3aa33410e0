"""A cell of BENCHMARK.json at a size that the CPU runs in a moment: the
same configuration, traffic, limits and metrics, the shape cut down (a
batch to at most 4 rows, a row to 4,096 points, a recording to 10,000
samples)."""

from __future__ import annotations

import dataclasses

from portbench.harness import spec


def tiny_shape(op: str, shape):
    if op == "fft":
        return [min(shape[0], 4), 1 << 12]
    if op == "welch":
        return [shape[0], 10_000]
    if op == "fft2":
        return [shape[0], 64, 64] if shape[0] == 1 else [4, 32, 32]
    raise ValueError(f"no tiny shape for op {op!r}")


def tiny_cell(name: str, **traffic) -> spec.Cell:
    c = spec.load_cell(name)
    tr = dict(c.traffic, **traffic)
    tr["shape"] = tiny_shape(tr["op"], tr["shape"])
    tr["warmup_calls"] = min(tr["warmup_calls"], 3)
    return dataclasses.replace(c, traffic=tr, config=dict(c.config, shapes=[tr["shape"]]))
