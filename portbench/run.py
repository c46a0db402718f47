#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cell's configuration
and traffic mix; their files, the cell's limits and the per-layer metric
readers are found by name under ``portbench/``. The run makes its inputs
and weights from ``--seed``, warms up every shape it will use, measures for
``--seconds`` seconds, checks the timed path's output against the plain
reference, and prints one JSON line last: the end-to-end metrics with
``--trace 0``, the per-layer metrics (read from a traced tail after the
window) with ``--trace 1``. It exits non-zero and prints no result when
there is no card, when the checkout holds no port, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import guard, spec  # noqa: E402


def note(what: str) -> None:
    """Seconds since the process started, on standard error."""
    print(f"portbench: {what} at {time.perf_counter() - STARTED:.3f} s",
          file=sys.stderr, flush=True)

OUT_DIR = os.path.join(ROOT, "portbench", "_out")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cfg_node(tree: dict, overrides: dict):
    """The port's config object of a configuration file's tree, with
    ``overrides`` ({"a.b": value}) applied."""
    from afcm_tpu_torch.config.config import CfgNode
    cfg = CfgNode(json.loads(json.dumps(tree)))
    for key, value in (overrides or {}).items():
        node = cfg
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        node[last] = value
    return cfg


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             started: float = STARTED, overrides: dict = None, out_dir: str = OUT_DIR,
             readings_out: dict = None):
    """One run of ``cell`` on ``device``: returns the result line (a dict),
    with the check's readings beside their limits under ``check``; every
    reading goes to ``readings_out`` when given. The caller has made sure
    the device is the one the run asks for. ``overrides`` ({"a.b": value})
    change the configuration, and ``{"conv_impl": "int8_all"}`` routes
    every eligible conv through the program's int8 kernel (the controls of
    ``calibrate.py``)."""
    import numpy as np
    import torch
    from portbench.harness import check, serve, train, yardstick
    from portbench.harness.weights import make_weights

    overrides = dict(overrides or {})
    conv_impl = overrides.pop("conv_impl", None)
    cfg = cfg_node(cell.config["config"], overrides)
    cfg.checkpoints_dir = os.path.join(out_dir, "checkpoints")
    tree = cfg.to_dict()
    traffic = cell.traffic
    kind = traffic["kind"]
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"trace_{cell.name}.json.gz") if trace else None
    weights = make_weights(tree, seed, device, with_d=(kind == "train"))
    print(f"portbench: set-up to weights {time.perf_counter() - started:.3f} s",
          file=sys.stderr, flush=True)
    if kind == "serve":
        result = serve.run(cfg, traffic, weights, device, seed, seconds,
                           out_dir=os.path.join(out_dir, "predictions"), trace_path=trace_path,
                           conv_impl=conv_impl)
        items = result["slices"]
        rate = {"slices_per_s": result["slices"] / result["window_s"]}
        setup_s = result["t0"] - started
        attempted = len(result["subjects"])
        failed = sum(not bool(np.isfinite(s["volume"]).all()) for s in result["subjects"])
        print(f"portbench: {attempted} subjects, {items} slices in {result['window_s']:.3f} s; "
              f"{result['written_bytes']} bytes of NIfTI not written", file=sys.stderr)
    elif kind == "train":
        result = train.run(cfg, traffic, weights, device, seed, seconds, trace_path=trace_path,
                           conv_impl=conv_impl)
        rate = {"img_per_s": result["images"] / result["window_s"]}
        if result["step_ms"]:
            rate["step_p90_ms"] = percentile(result["step_ms"], 90)
        setup_s = result["t0"] - started
        attempted, failed = result["steps"], 0
        print(f"portbench: {result['steps']} steps in {result['window_s']:.3f} s, "
              f"{len(result['step_ms'])} step times", file=sys.stderr)
    else:
        raise ValueError(f"traffic kind {kind!r}")
    peak = int(result["memory_peak_bytes"])
    e2e = dict(rate, peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}

    # the program's state is gone with its frames; the check runs after
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if kind == "serve":
        readings = check.check_serve(tree, traffic, weights, result, device, seed)
    else:
        readings = check.check_train(tree, traffic, weights, result, device, result["pool"])
    print(f"portbench: check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    if readings_out is not None:
        readings_out.update(readings)
    limits = cell.cell["limits"]
    compared = {name: {"value": readings[name], "limit": limit}
                for name, limit in limits.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())   # NaN fails

    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if trace:
        ctx = {"cell": cell.name, "kind": kind, "config": tree, "traffic": traffic,
               "window": {k: v for k, v in result.items()
                          if k not in ("subjects", "pool", "log", "trace")},
               "rate": rate, "trace": result.get("trace"), "yardstick": yardstick}
        line["metrics"] = spec.read_metrics(cell.per_layer, ctx, cell.root)
    else:
        line["metrics"] = {name: {"value": float(e2e[name]), "unit": units[name]}
                           for name in units if e2e.get(name) is not None}
    line["device"] = device_record(device, cell.chips, peak, result.get("trace"))
    if trace and result.get("trace"):
        line["breakdown"] = {"device_ops": result["trace"]["device_ops"],
                             "idle_gaps": result["trace"]["idle_gaps"]}
    others = {k: v for k, v in readings.items()
              if k not in compared and not isinstance(v, list)}
    print(f"portbench: readings {json.dumps(others)}", file=sys.stderr)
    line["check"] = compared
    return line


def device_record(device, chips: int, peak: int, trace=None) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(chips), "memory_peak_bytes": peak}
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if trace:
        record.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return record


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        cell = spec.find_cell(args.workload)
    except (OSError, KeyError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch
    note("torch imported")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import afcm_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is not in this checkout ({exc})", file=sys.stderr)
        return 2
    note("port imported")
    torch.zeros((), device="cuda")
    note("card ready")
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    guard.check_no_jax()
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
