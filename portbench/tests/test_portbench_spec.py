"""BENCHMARK.json against the benchmark's contract, and every file that it
names: each configuration, traffic mix, limits file, op, reference, work
count and metric reader can be loaded."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits: 2 + 14 * cells runs, each run_seconds + 60.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_metrics():
    e2e, per_layer = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    names = [m["name"] for m in (*e2e, *per_layer)]
    assert len(set(names)) == len(names)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    e2e_names = {m["name"] for m in e2e}
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e_names and _line(m["layer"])
    for m in (*e2e, *per_layer):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:  # setup_s, another end-to-end metric and a per-layer metric in each
        has = [m["name"] for m in e2e if cell in m.get("workloads", CELLS)]
        assert "setup_s" in has and len(has) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in per_layer)


def test_per_layer_moves_an_end_to_end_metric_of_each_of_its_cells():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_loads(cell):
    c = spec.load_cell(cell)
    kind = c.traffic["op"]
    for part in ("ops", "reference", "work"):
        importlib.import_module(f"portbench.{part}.{kind}")
    importlib.import_module(f"portbench.data.{c.config['data']['kind']}")
    assert c.traffic["dispatch"] in ("sync", "ahead") and c.traffic["pool"] >= 1
    assert c.limits and all(float(v["limit"]) > 0 for v in c.limits.values())
    for m in (*c.end_to_end, *c.per_layer):
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_criterions_loop(cell):
    """One synchronous caller, as the sources' loops call (Criterion's
    ``b.iter``; scipy's example calls welch once and uses the result)."""
    tr = spec.load_cell(cell).traffic
    assert tr["dispatch"] == "sync" and tr["depth"] == 1 and tr["pool"] == 1


def test_benchmark_files_are_named_from_name_characters():
    for f in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel
