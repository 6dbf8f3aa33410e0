"""Find a cell and everything that belongs to it by the names in
BENCHMARK.json: its configuration file, its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and the
metrics that it reports."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # number compared -> {"limit": ..., readings}
    end_to_end: tuple  # the BENCHMARK.json entries that this cell reports
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    wl = _by_name(bench["workloads"], name, "workload")
    cfg = _by_name(bench["configs"], wl["config"], "config")
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    if list(traffic["shape"]) not in [list(s) for s in config["shapes"]]:
        raise ValueError(f"{name}: traffic shape {traffic['shape']} is not one of "
                         f"{wl['config']}'s shapes {config['shapes']}")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=wl["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=tuple(m for m in bench["end_to_end"] if applies(m)),
                per_layer=tuple(m for m in bench["per_layer"] if applies(m)))
