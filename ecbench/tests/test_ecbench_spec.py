"""BENCHMARK.json and the files it names: every piece loads by name, each
per-layer metric's cells report the end-to-end metric it moves, and the
benchmark's modules keep to their import rules."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from ecbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ecbench/run.py"]
    assert BENCH["paths"] == ["ecbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = spec.cell(cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cfg = spec.config(c["config"])
    assert cfg["name"] == c["config"]
    assert os.path.exists(os.path.join(spec.HERE, "deploy",
                                       cfg["deployment"] + ".py"))
    assert spec.traffic(c["traffic"])["loop"] in ("open", "calls")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_entries_match_their_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert entry["file"] == f"ecbench/configs/{config}.json"
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert cfg["guarantees"] and cfg["assumed"] and cfg["source"]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_readers_load_and_names_are_valid(metric):
    m = next(x for x in BENCH["end_to_end"] + BENCH["per_layer"]
             if x["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.reader(metric))
    for cell in m.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics_for(cell, False, BENCH)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(cell, True, BENCH)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def _modules():
    for base, _, files in os.walk(spec.HERE):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(base, fn)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "seaweedfs_tpu"}


@pytest.mark.parametrize("path", sorted(
    p for p in _modules() if os.sep + "reference" + os.sep in p))
def test_reference_imports_nothing_of_the_port(path):
    assert "seaweedfs_tpu_torch" not in _imports(path)


def test_load_processes_use_the_standard_library_only():
    assert _imports(os.path.join(spec.HERE, "loader.py")) <= {
        "__future__", "hashlib", "http", "json", "queue", "sys",
        "threading", "time"}
