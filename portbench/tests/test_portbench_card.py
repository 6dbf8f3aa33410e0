"""On the card: each cell runs short and is correct; its control (the
reference put in the program's place and computed in TF32, the precision
next below the configuration's float32 with TF32 off) fails the cell's
limits, and so does the program under its own lower precision "high"
(bf16x3 products).  Marked ``cuda``: skipped where no card is present.

    python3 -m pytest portbench/tests -m cuda
"""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from portbench.harness import core, inputs, spec

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
T0 = time.perf_counter()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def port(dev):
    return core.import_port("full")


@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, dev, port):
    c = spec.load_cell(cell)
    result, checks = core.run_cell(c, 2**31 + 77, 1.0, False, dev, T0, port=port)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    # every end-to-end metric is read on the card, the device meter's too
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell, dev):
    c = spec.load_cell(cell)
    ref = importlib.import_module(f"portbench.reference.{c.traffic['op']}")
    x = inputs.make_pool(c.config, c.traffic, 2**31 + 78, dev)[0]
    want = ref.reference(x, c.traffic["params"], "float64")
    got = ref.judge(ref.reference(x, c.traffic["params"], "tf32"), want)
    assert any(got[name] > float(lim["limit"]) for name, lim in c.limits.items()), got


@pytest.mark.parametrize("cell", CELLS)
def test_high_precision_is_not_correct(cell, dev, port):
    c = spec.load_cell(cell)
    kind = c.traffic["op"]
    ref = importlib.import_module(f"portbench.reference.{kind}")
    op = importlib.import_module(f"portbench.ops.{kind}")
    x = inputs.make_pool(c.config, c.traffic, 2**31 + 79, dev)[0]
    want = ref.reference(x, c.traffic["params"], "float64")
    port.config.PRECISION = "high"
    try:
        got = ref.judge(op.call(port, x, c.traffic["params"]), want)
    finally:
        port.config.PRECISION = "full"
    assert any(got[name] > float(lim["limit"]) for name, lim in c.limits.items()), got
