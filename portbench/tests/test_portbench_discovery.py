"""A configuration, traffic mix, per-layer metric and cell added as new
files are found by name, with no existing file edited."""

import hashlib
import json
import os

from portbench.harness import spec
from portbench.tests.tiny import make_root


def digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    before = digests(os.path.join(root, "portbench"))
    base = os.path.join(root, "portbench")
    json.dump({"config": {"model": {"G": {"netG": "stylegan3"}}}},
              open(os.path.join(base, "configs/new_model.json"), "w"))
    json.dump({"kind": "serve", "pool": 3}, open(os.path.join(base, "traffic/new_mix.json"), "w"))
    json.dump({"limits": {"rel_l2": 0.5}}, open(os.path.join(base, "cells/new-cell.json"), "w"))
    with open(os.path.join(base, "metrics/new_share.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['window']['x'] * 2\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "new_model", "source": "s", "why": "w", "reduced": [],
                             "file": "portbench/configs/new_model.json"})
    bench["workloads"].append({"name": "new-cell", "config": "new_model",
                               "traffic": "new_mix", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "serve loop",
                               "moves": "slices_per_s", "workloads": ["new-cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.find_cell("new-cell", root)
    assert cell.config["config"]["model"]["G"]["netG"] == "stylegan3"
    assert cell.traffic == {"kind": "serve", "pool": 3}
    assert cell.cell == {"limits": {"rel_l2": 0.5}}
    assert [m["name"] for m in cell.per_layer] == ["new_share"]
    assert spec.read_metrics(cell.per_layer, {"window": {"x": 21}}, root) == {
        "new_share": {"value": 42.0, "unit": "%"}}
    after = digests(os.path.join(root, "portbench"))
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    metrics = [{"name": "k1_roofline.serve", "unit": "%"}, {"name": "device_idle.serve", "unit": "%"}]
    assert spec.read_metrics(metrics, {"trace": None, "config": {}}) == {}


def test_every_metric_and_cell_of_the_benchmark_has_its_file():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.cell["limits"] and cell.traffic["kind"] in ("serve", "train")
