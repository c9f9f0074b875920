"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric is found by name, and names, units and lengths keep to the
benchmark's rules."""
import json
import re
from pathlib import Path

import pytest

from graphbench import harness, judge

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
LAYER = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = {c["name"]: c for c in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert line_ok(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_found_by_name(name):
    cell, config, mix = harness.cell_parts(BENCH, name)
    assert NAME.match(name) and NAME.match(cell["traffic"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and line_ok(cell["why"])
    assert config["name"] == cell["config"]
    assert mix["batch_updates"] % 2 == 0
    assert callable(harness.loop(mix))
    for job in mix["jobs"]:
        ref = judge.job(job["name"])
        assert callable(ref.solve) and callable(ref.compare)
    reported = {m["name"] for m in harness.metric_specs(BENCH, name, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metric_specs(BENCH, name, True)


def test_pairs_once_and_cells_use_every_config():
    pairs = [(c["config"], c["traffic"]) for c in CELLS.values()]
    assert len(pairs) == len(set(pairs))
    assert {c["config"] for c in CELLS.values()} == set(CONFIGS)
    assert sum(c["chips"] == 4 for c in CELLS.values()) <= 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_found_by_name(name):
    entry = CONFIGS[name]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(name) and line_ok(entry["source"])
    assert line_ok(entry["why"]) and len(entry["reduced"]) <= 16
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"]
    assert data["guarantees"]["consistency"].startswith("snapshot")
    files = [c["file"] for c in CONFIGS.values()]
    assert files.count(entry["file"]) == 1


@pytest.mark.parametrize("name", sorted(E2E) + sorted(LAYER))
def test_metric_reader_found_by_name(name):
    m = E2E.get(name) or LAYER[name]
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.reader(name))
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if name in E2E:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in E2E
        for cell in m["workloads"]:
            moved = E2E[m["moves"]]
            assert cell in moved.get("workloads", [cell])


def test_layers_named_alike():
    seen = {}
    for m in LAYER.values():
        assert seen.setdefault(m["layer"].lower(), m["layer"]) == m["layer"]


def test_files_named_from_name_characters():
    for path in (ROOT / "graphbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert PATH.match(path.relative_to(ROOT).as_posix()), path
