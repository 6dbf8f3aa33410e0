"""Command line of one run: ``run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  Prints the result as the last line of standard
output and the numbers compared, each beside its limit, as the last lines
of standard error."""

from __future__ import annotations

import argparse
import json
import math
import sys


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    from .spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 3
    from . import core

    result, checks = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   core.devices_of(cell), t0)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    result["check"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                       for name, v, lim in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, v, lim in checks:
        print(f"check {name} = {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
    return 0
