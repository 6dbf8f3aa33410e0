"""Spread of each end-to-end metric over sets of runs, as the bounds are set.

    python3 portbench/tools/spread.py <dir> [<dir> ...]

Reads the result lines that ``portbench/run.py`` printed into
``<cell>.<tag>.out`` files (``setA<k>`` / ``setB<k>`` for the two sets of
runs on the same seeds, ``first`` for a run on a fresh build, ``trace<k>``
for traced runs).  For each cell, set and metric: the median and the spread,
the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; for both
sets, the mean spread of each set without its run farthest from its median
(a bound under twice it is too tight) and the spread of all runs together
(a bound over eight times it is too loose).  Then, for each metric, the
widest spread over the cells and five times it.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path


def last_json(path: Path):
    lines = [ln for ln in path.read_text().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def spread_without_farthest(values) -> float:
    """The spread of a set without its run farthest from its median, where
    that narrows it: the reading that a bound is too tight by."""
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda v: abs(v - med)))
    return min(spread(values), spread(rest)) if len(rest) >= 2 else spread(values)


def main(dirs) -> int:
    sets = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))  # cell -> set -> metric -> values
    other = defaultdict(list)
    for d in dirs:
        for f in sorted(Path(d).glob("*.out")):
            m = re.match(r"(.+)\.(set[AB]\d+|first|trace\d+)\.out$", f.name)
            r = last_json(f) if m else None
            if r is None:
                continue
            cell, tag = m.groups()
            if tag.startswith("set"):
                for k, v in r["metrics"].items():
                    sets[cell][tag[3]][k].append(v["value"])
                sets[cell][tag[3]]["correct"].append(r["correct"])
            else:
                other[cell].append((tag, r["correct"], {k: v["value"] for k, v in r["metrics"].items()}))
    widest = defaultdict(float)
    for cell, by_set in sorted(sets.items()):
        print(cell)
        for s, metrics in sorted(by_set.items()):
            print(f"  set {s}: correct {sum(metrics['correct'])}/{len(metrics['correct'])}")
            for k, vals in sorted(metrics.items()):
                if k == "correct" or len(vals) < 2:
                    continue
                sp = spread(vals)
                if k != "setup_s":
                    widest[k] = max(widest[k], sp)
                print(f"    {k:16s} median {statistics.median(vals):.6g}  spread {100 * sp:.3f}%  "
                      f"values {', '.join(f'{v:.6g}' for v in vals)}")
        if len(by_set) == 2:
            a, b = by_set["A"], by_set["B"]
            for k in sorted(a):
                if k != "correct":
                    ma, mb = statistics.median(a[k]), statistics.median(b[k])
                    print(f"    B / A median {k}: {mb / ma:.5f}")
                    if len(a[k]) >= 3 and len(b[k]) >= 3:
                        tight = (spread_without_farthest(a[k]) + spread_without_farthest(b[k])) / 2
                        wide = spread(a[k] + b[k])
                        print(f"    {k}: each set without its farthest run, mean spread "
                              f"{100 * tight:.3f}%; all runs together {100 * wide:.3f}%")
        for tag, ok, vals in other[cell]:
            print(f"  {tag}: correct {ok} " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    for k, sp in sorted(widest.items()):
        print(f"{k}: widest spread {100 * sp:.3f}%, five times {500 * sp:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
