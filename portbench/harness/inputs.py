"""Inputs made on the device from ``--seed``, by the data kind that the
configuration names (``portbench/data/<kind>.py``).  The same seed gives the
same inputs; every seed gives the same shapes.  A pool of
``traffic["pool"]`` distinct inputs is made, and the window cycles through
it."""

from __future__ import annotations

import importlib

import torch


def make_pool(config: dict, traffic: dict, seed: int, device) -> list[torch.Tensor]:
    data = config["data"]
    kind = importlib.import_module(f"portbench.data.{data['kind']}")
    shape = tuple(traffic["shape"])
    return [kind.make(shape, data, seed, k, device) for k in range(traffic["pool"])]
