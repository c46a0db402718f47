"""A benchmark root in a temporary directory with the repository's
``BENCHMARK.json`` and ``portbench/`` data, plus a CPU-sized cell of each
kind over ``configs/demo/cmsr_tiny.yml`` (64^2 slices, batch 2) whose
limits suit float32 on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from portbench.harness.spec import ROOT

TINY_LIMITS = {"serve": {"rel_l2": 1e-3},
               "train": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3,
                         "change_gap_median": 1e-3, "ema_gap_median": 1e-3}}


def tiny_config(net_g: str = "stylegan3", dtype: str = "float32") -> dict:
    from afcm_tpu_torch.config import default_argument_parser
    opts = ["--config-file", os.path.join(ROOT, "configs/demo/cmsr_tiny.yml"),
            "tpu.compute_dtype", dtype, "tpu.transfer_dtype", "uint8",
            "loaders.raw_internal_path_out", "['t1_hr4sr']"]
    if net_g == "comodgan":
        opts += ["model.name", "comodgan", "model.G.netG", "comodgan"]
    cfg = default_argument_parser(opts).to_dict()
    for k in ("print_freq", "display_freq", "update_html_freq", "save_latest_freq",
              "save_epoch_freq"):
        cfg["trainer"][k] = 10 ** 12
    cfg["scheduler"]["n_epochs"] = 1000
    return cfg


def make_root(tmp: str, net_g: str = "stylegan3", dtype: str = "float32") -> str:
    """Copy the benchmark's data under ``tmp`` and add the cells
    ``tiny-serve`` and ``tiny-train`` (files of their own, as a later
    change adds cells)."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), os.path.join(tmp, "BENCHMARK.json"))
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(tmp, "portbench", sub))
    base = os.path.join(tmp, "portbench")
    json.dump({"config": tiny_config(net_g, dtype)}, open(os.path.join(base, "configs/tiny.json"), "w"))
    for kind in ("volumes", "steps"):
        t = json.load(open(os.path.join(ROOT, "portbench/traffic", kind + ".json")))
        t.update(pool=2, depth_min=6, depth_max=9, size=64, check_block=4)
        if kind == "steps":
            t.update(warmup_steps=4, trace_steps=2)
        json.dump(t, open(os.path.join(base, f"traffic/tiny_{kind}.json"), "w"))
    bench["configs"].append({"name": "tiny", "source": "configs/demo/cmsr_tiny.yml",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "CPU-sized"})
    bench["workloads"] += [
        {"name": "tiny-serve", "config": "tiny", "traffic": "tiny_volumes", "chips": 1, "why": "CPU"},
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny_steps", "chips": 1, "why": "CPU"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve = any(w.endswith("-serve") for w in m["workloads"])
            m["workloads"].append("tiny-serve" if serve else "tiny-train")
    json.dump(bench, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    for kind in ("serve", "train"):
        json.dump({"limits": TINY_LIMITS[kind]},
                  open(os.path.join(base, f"cells/tiny-{kind}.json"), "w"))
    return tmp


def run_tiny(root: str, cell_name: str, seed: int = 7, seconds: float = 1.5,
             trace: bool = False, overrides=None):
    """One run of a tiny cell on the CPU; returns its line and readings."""
    import time

    import torch

    from portbench import run as bench
    from portbench.harness import spec
    cell = spec.find_cell(cell_name, root)
    readings = {}
    line = bench.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                          started=time.perf_counter(), overrides=overrides,
                          out_dir=os.path.join(root, "out"), readings_out=readings)
    return line, readings
