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
largest |g| / max|g| among them. ``exp_avg_sq`` compares the second
moments at the entries whose gradient the gradient check vouches for
(|g| > 1e-3·max|g| of the tensor, g the reference side's): the largest
relative gap and its tensor, the entry of G's ``synthesis.e_16x16.bias``
that misses the slow test's rtol 2e-3 / atol 1e-5 check against afcm_tpu
by the most, and, beside each gap, the bound on v that the gradient check
implies: at step 1 from v = 0, v = (1 - beta2)·g², so a gradient held to
delta = 1e-3·|g| + 1e-3·max|g| holds v to (1 - beta2)·delta·(2|g| + delta).

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

import numpy as np  # noqa: E402

from tests.test_torch_train import (LOSSES, _adam_mu_nu, _jax_arrays,  # noqa: E402
                                    _port_arrays, full_size_jax_step,
                                    full_size_port_step, step_misses, v_bound)

ENTRY_TENSOR = "synthesis.e_16x16.bias"     # ROADMAP C14's one miss


def _port_v(port):
    """Per net, Adam's second moment of each parameter, as numpy by name."""
    return {name: {k: opt.state[p]["exp_avg_sq"].numpy().copy()
                   for k, p in net.named_parameters()}
            for name, net, opt in (("G", port.generator, port.opt_G),
                                   ("D", port.discriminator, port.opt_D))}


def worst_entry(got_v, want_v, grads):
    """The flat index of G's ENTRY_TENSOR entry, among those the gradient
    check vouches for, that misses rtol 2e-3 / atol 1e-5 by the most."""
    g = grads["G"][ENTRY_TENSOR]
    vouched = np.abs(g) > 1e-3 * np.abs(g).max()
    a, b = got_v["G"][ENTRY_TENSOR], want_v["G"][ENTRY_TENSOR]
    excess = np.where(vouched, np.abs(a - b) - (1e-5 + 2e-3 * np.abs(b)), -np.inf)
    return int(excess.argmax())


def v_gaps(got_v, want_v, grads, beta2, entry):
    """Per net, the second moments' gaps at the vouched entries (|g| >
    1e-3·max|g| of ``grads``' tensor): the largest |got - want| / want and
    its tensor, the largest gap over the bound the gradient check implies
    (``v_bound``), how many entries the slow test's rtol 2e-3 / atol 1e-5
    check misses; and the gap at G's ``entry`` of ENTRY_TENSOR."""
    out = {}
    for net, vs in want_v.items():
        row = dict(v_max_rel_gap=0.0, v_max_rel_tensor=None, v_max_gap_over_bound=0.0,
                   v_check_misses=0)
        for key, want in vs.items():
            g = grads[net][key]
            vouched = np.abs(g) > 1e-3 * np.abs(g).max()
            if not vouched.any():
                continue
            gap = np.abs(got_v[net][key] - want)[vouched].astype(np.float64)
            rel = float((gap / np.maximum(np.abs(want[vouched]), 1e-38)).max())
            if rel > row["v_max_rel_gap"]:
                row["v_max_rel_gap"], row["v_max_rel_tensor"] = rel, key
            bound = v_bound(g, beta2)[vouched]
            row["v_max_gap_over_bound"] = max(row["v_max_gap_over_bound"],
                                              float((gap / bound).max()))
            row["v_check_misses"] += int((gap > 1e-5 + 2e-3 * np.abs(want[vouched])).sum())
        out[net] = row
    g = grads["G"][ENTRY_TENSOR].reshape(-1)
    got, want = got_v["G"][ENTRY_TENSOR].reshape(-1), want_v["G"][ENTRY_TENSOR].reshape(-1)
    out["entry"] = dict(tensor=ENTRY_TENSOR, index=entry, g=float(g[entry]),
                        max_abs_g=float(np.abs(g).max()), v=float(want[entry]),
                        v_got=float(got[entry]), gap=float(abs(got[entry] - want[entry])),
                        rel_gap=float(abs(got[entry] - want[entry]) / abs(want[entry])),
                        v_bound=float(v_bound(g, beta2)[entry]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nudges", type=int, default=2)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    case = full_size_jax_step()
    jax_s = time.perf_counter() - t0
    port, metrics, start = full_size_port_step(case)
    reference, reference_v = _port_arrays(port, start), _port_v(port)
    (beta2,) = {g["betas"][1] for g in port.opt_G.param_groups}
    del port
    jax_arrays = _jax_arrays(case.new_state, case.state)
    jax_v = {name: _adam_mu_nu(getattr(case.new_state, f"opt_state_{name}"))[1]
             for name in ("G", "D")}
    jax_grads = {net: grads for net, (_, grads) in jax_arrays.items()}
    entry = worst_entry(reference_v, jax_v, jax_grads)
    print(json.dumps({"compare": "port vs afcm_tpu", "jax_seconds": jax_s,
                      "loss_rel_err": {k: abs(metrics[k] - case.metrics[k])
                                       / max(abs(case.metrics[k]), 1e-30) for k in LOSSES},
                      **step_misses(reference, jax_arrays),
                      "exp_avg_sq": v_gaps(reference_v, jax_v, jax_grads, beta2, entry)}),
          flush=True)
    port_grads = {net: grads for net, (_, grads) in reference.items()}
    for i in range(args.nudges):
        nudged, nudged_metrics, start = full_size_port_step(case, nudge=2.0 ** -24, seed=i)
        print(json.dumps({"compare": f"floor: nudged port {i} vs port",
                          "loss_rel_err": {k: abs(nudged_metrics[k] - metrics[k])
                                           / max(abs(metrics[k]), 1e-30) for k in LOSSES},
                          **step_misses(_port_arrays(nudged, start), reference),
                          "exp_avg_sq": v_gaps(_port_v(nudged), reference_v, port_grads,
                                               beta2, entry)}), flush=True)
        del nudged
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
