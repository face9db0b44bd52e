"""Find a cell's pieces by name: BENCHMARK.json, the cell, its
configuration, its traffic mix and the readers of its metrics.

    ecbench/cells/<cell>.json      configuration, traffic, chips, why,
                                   and the cell's own parameters
    ecbench/configs/<config>.json  the deployment's sizes, source, cuts,
                                   guarantees, and the deploy module
    ecbench/traffic/<mix>.json     the mix's parameters for the generator
    ecbench/metrics/<metric>.py    read(ctx) -> number or None
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return _json("cells", name + ".json")


def config(name: str) -> dict:
    return _json("configs", name + ".json")


def traffic(name: str) -> dict:
    return _json("traffic", name + ".json")


def metrics_for(cell_name: str, trace: bool, bench: dict = None) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with `trace` its per-layer metrics, each kept where its `workloads`
    names the cell or is absent."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """The `read(ctx)` of ecbench/metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "ecbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
