#!/usr/bin/env python3
"""One full-size CMSR train step of the port against afcm_tpu's, with its
misses beside float32's rounding floor, on the CPU (ROADMAP C14).

    JAX_PLATFORMS=cpu python scripts/torch_full_step_parity.py [--nudges 2]

Runs tests/test_torch_train.py's full-size step (the shipped CMSR training
config at its published widths, batch 2, float32, one G forward for both
phases, R1 on, z and the dropout mask injected) in afcm_tpu and in the port
from one GANTrainState, and prints one JSON line per comparison, each
against _compare_step's bounds (``step_misses``): per net the gradients'
max |a - b| over max|g| of the tensor (bound 1e-3), and where |g| > 1e-6
the parameters' updates that are more than 1e-5 apart (the bound on the
parameters after steps from one state), the largest distance and the
largest |g| / max|g| among them.

``port vs afcm_tpu`` is the check of the slow test. ``floor`` runs the
port's step again ``--nudges`` times with every weight, buffer and input
multiplied by 1 + 2^-24 N(0, 1) (chip_smoke.py's card_against_cpu nudge:
half an ulp) and holds each against the un-nudged port step: how far
float32 rounding alone moves the same quantities. About 25 minutes and
20 GiB of host memory.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_train import (LOSSES, _jax_arrays, _port_arrays,  # noqa: E402
                                    full_size_jax_step, full_size_port_step, step_misses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nudges", type=int, default=2)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    case = full_size_jax_step()
    jax_s = time.perf_counter() - t0
    port, metrics, start = full_size_port_step(case)
    reference = _port_arrays(port, start)
    del port
    print(json.dumps({"compare": "port vs afcm_tpu", "jax_seconds": jax_s,
                      "loss_rel_err": {k: abs(metrics[k] - case.metrics[k])
                                       / max(abs(case.metrics[k]), 1e-30) for k in LOSSES},
                      **step_misses(reference, _jax_arrays(case.new_state, case.state))}),
          flush=True)
    for i in range(args.nudges):
        nudged, nudged_metrics, start = full_size_port_step(case, nudge=2.0 ** -24, seed=i)
        print(json.dumps({"compare": f"floor: nudged port {i} vs port",
                          "loss_rel_err": {k: abs(nudged_metrics[k] - metrics[k])
                                           / max(abs(metrics[k]), 1e-30) for k in LOSSES},
                          **step_misses(_port_arrays(nudged, start), reference)}), flush=True)
        del nudged
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
