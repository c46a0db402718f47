#!/usr/bin/env python3
"""Readings of a cell's correctness check over many seeds in one process,
for setting the cell's limits (``cells/<cell>.json``): the program as the
configuration states it, or a control with configuration overrides (the
program's int8 conv path, ``--set tpu.conv_int8 True``).

    python3 portbench/calibrate.py --workload cmsr-serve --seconds 3 \\
        --seeds 11 12 13 [--set tpu.conv_int8 True] [--out portbench/_out/calib.jsonl]

Each seed's readings are one JSON line of ``--out``. It needs the card, as
``run.py`` does."""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as bench  # noqa: E402
from portbench.harness import guard, spec  # noqa: E402


def plant_half_batch() -> None:
    """Every train step of the program takes the first half of its batch,
    its losses the mean over that half."""
    from afcm_tpu_torch.models.gan_model import GANModel
    step = GANModel.train_step

    def half(self, batch, cur_nimg, **kwargs):
        n = batch["A"].shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, cur_nimg, **kwargs)
    GANModel.train_step = half


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--set", nargs=2, action="append", default=[], metavar=("KEY", "VALUE"))
    p.add_argument("--fault", choices=("half_batch",), default=None,
                   help="plant a fault in the timed path: a train step on half of the batch")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.fault == "half_batch":
        plant_half_batch()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    overrides = {k: ast.literal_eval(v) if v not in ("float32", "bfloat16", "int8_all", "int8")
                 else v for k, v in args.set}
    cell = spec.find_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        readings = {}
        started = time.perf_counter()
        line = bench.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                              started=started, overrides=overrides, readings_out=readings)
        record = {"workload": args.workload, "seed": seed, "overrides": overrides,
                  "fault": args.fault,
                  "readings": readings, "correct": line["correct"],
                  "metrics": line["metrics"], "seconds": time.perf_counter() - started}
        print(json.dumps(record), flush=True)
        if out:
            out.write(json.dumps(record) + "\n")
            out.flush()
    guard.check_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
