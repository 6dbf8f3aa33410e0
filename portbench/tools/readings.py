"""The readings that a cell's limits are set from, in one process on the card.

    python3 portbench/tools/readings.py --workload <cell> [<cell> ...] --seeds 12 --controls 3 --seconds 2

For each cell and each of ``--seeds`` seeds, one short run of the cell
through the harness (the timed path at the cell's sizes): the numbers
compared, which give the lower reading.  For each of the first
``--controls`` seeds, the same numbers for the controls on the same inputs:
the reference computed in TF32 and in float32 (TF32 off) put in the
program's place, and the program's own lower precisions, "high" (bf16x3
products in the torch engines, the kernels left out) and "fast" (bf16x1);
and for two faults planted in the program's output: half of the batch left
out, and one answer altered.  Prints one JSON line per reading and appends
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench.harness import core, inputs  # noqa: E402
from portbench.harness.spec import load_cell  # noqa: E402
from portbench.tools import faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_011)
    p.add_argument("--out", default="readings.jsonl")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    rows = []
    for name in args.workload:
        rows += cell_readings(args, name, dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


def cell_readings(args, name, dev) -> list:
    """Every reading of one cell, in this process."""
    cell = load_cell(name)
    tr = cell.traffic
    port = core.import_port(cell.config["guarantees"]["precision"])
    ref = importlib.import_module(f"portbench.reference.{tr['op']}")
    op_mod = importlib.import_module(f"portbench.ops.{tr['op']}")
    rows = []

    def emit(row):
        row = {"cell": name, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    for seed in seeds:
        t = time.perf_counter()
        res, checks = core.run_cell(cell, seed, args.seconds, False, dev, T0, port=port)
        emit({"what": "program", "seed": seed, "correct": res["correct"],
              "attempted": res["attempted"], **{n: v for n, v, _ in checks},
              "seconds": time.perf_counter() - t})
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def op(x):
        return op_mod.call(port, x, tr["params"])

    for seed in seeds[: args.controls]:
        x = inputs.make_pool(cell.config, tr, seed, dev)[0]
        want = ref.reference(x, tr["params"], "float64")
        for prec in ("tf32", "float32"):
            t = time.perf_counter()
            got = ref.reference(x, tr["params"], prec)
            emit({"what": f"control_{prec}", "seed": seed, **ref.judge(got, want),
                  "seconds": time.perf_counter() - t})
            del got
        for prec in ("high", "fast"):
            port.config.PRECISION = prec
            try:
                emit({"what": f"program_{prec}", "seed": seed, **ref.judge(op(x), want)})
            finally:
                port.config.PRECISION = cell.config["guarantees"]["precision"]
        emit({"what": "fault_half_batch", "seed": seed,
              **ref.judge(faults.half_batch(tr["op"], op, x), want)})
        emit({"what": "fault_altered", "seed": seed, **ref.judge(faults.altered(op(x)), want)})
        del x, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
