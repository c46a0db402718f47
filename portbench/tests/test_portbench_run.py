"""The run's result line, its refusals and the JAX guard."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import guard
from portbench.harness.spec import ROOT
from portbench.tests.tiny import make_root, run_tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def test_guard_compares_top_level_names_whole():
    names = ["afcm_tpu_torch", "afcm_tpu_torch.ops", "jaxtyping", "flaxen", "numpy",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax", "afcm_tpu",
             "afcm_tpu.nn"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax", "afcm_tpu",
         "afcm_tpu.nn"])


def test_guard_exits_when_jax_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as exc:
        guard.check_no_jax()
    assert exc.value.code != 0


def test_untraced_line_holds_the_keys_and_end_to_end_metrics(tmp_path):
    line, readings = run_tiny(make_root(str(tmp_path)), "tiny-serve")
    assert set(line) == KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"slices_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["check"]) == {"rel_l2"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    json.dumps(line)


def test_traced_line_holds_per_layer_metrics_and_a_breakdown(tmp_path):
    line, _ = run_tiny(make_root(str(tmp_path)), "tiny-train", trace=True)
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "check"
    assert {"loader_ms_per_step", "mfu.train", "device_idle.train"} <= set(line["metrics"])
    assert "k1_roofline.train" not in line["metrics"]       # no device kernels on the CPU
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def run_main(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "cmsr-serve",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_and_prints_no_result():
    proc = run_main(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    proc = run_main(str(tmp_path), {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
