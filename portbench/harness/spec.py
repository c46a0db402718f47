"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix; each is a file of its
own under ``portbench/`` (``configs/<config>.json``,
``traffic/<traffic>.json``, ``cells/<cell>.json``, ``metrics/<metric>.py``),
so a later change adds a cell by adding files."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]       # the configuration file: "config" holds the tree
    traffic_name: str
    traffic: Dict[str, Any]
    cell: Dict[str, Any]         # the cell's own file: the check's limits
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: str = ROOT


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    base = os.path.join(root, "portbench")
    return Cell(
        name=name, chips=int(work["chips"]), config_name=conf["name"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=work["traffic"],
        traffic=load_json(os.path.join(base, "traffic", work["traffic"] + ".json")),
        cell=load_json(os.path.join(base, "cells", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)], root=root)


def metric_reader(name: str, root: str = ROOT):
    """The module ``portbench/metrics/<name>.py``: its ``read(ctx)`` returns
    the metric's value, or None where the run holds nothing to read."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(metrics: List[Dict[str, Any]], ctx: Dict[str, Any],
                 root: str = ROOT) -> Dict[str, Dict[str, Any]]:
    """The per-layer metrics that find something to read in ``ctx``."""
    out = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
