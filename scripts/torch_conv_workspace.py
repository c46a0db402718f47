#!/usr/bin/env python3
"""ms/step and peak memory of the train CLI's loop per cuDNN workspace
policy, each (config, dtype, remat, policy) in a fresh process; optionally
the workspace each conv of a step takes.

    python scripts/torch_conv_workspace.py [--configs cmsr ccsr pix2pix]
        [--dtype float32] [--remat off] [--policy default train ...]
        [--steps 12] [--per-conv] [--out ws.json]

A fresh Python process runs ``python -m afcm_tpu_torch.train``'s entry
(``train.main``) on the card for ``--steps`` steps of the config at its
published batch (cmsr: configs/adni/stylegan3/cmsr.yml b16; ccsr:
configs/adni/comodgan/ccsr.yml b16; pix2pix: configs/adni/base.yml b32 with
chip_smoke.py's channel overrides), random weights from seed 0, over a
256^2 phantom in place of the h5 data. The peak is read over the steps
after the first two (``torch.cuda.reset_peak_memory_stats`` after step 2)
but the last, ms/step per window of three steps (the median printed).
``train`` is the entry's own policy (``train.bound_conv_workspace``);
every other policy replaces it by nothing and sets the process's
environment: ``default`` is PyTorch's
default planning, ``wscap`` sets ``CUDNN_CONV_WSCAP_DBG`` (MiB; 256 and 4096
with the suffix), ``v7`` sets ``TORCH_CUDNN_V8_API_DISABLED``, ``benchmark``
turns on ``torch.backends.cudnn.benchmark``. With ``--per-conv`` the last
step wraps every conv of ``ops/conv2d_gradfix`` to read its workspace: the
peak over the call less the memory allocated before it and its output.
Prints the card's name and power limit, then one JSON line per setting.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = "CUDNN_CONV_WSCAP_DBG"
POLICIES = {
    "default": {},
    "train": {},
    "wscap": {CAP: "1024"},
    "v7": {"TORCH_CUDNN_V8_API_DISABLED": "1"},
    "v7+wscap": {"TORCH_CUDNN_V8_API_DISABLED": "1", CAP: "1024"},
    "v7+wscap256": {"TORCH_CUDNN_V8_API_DISABLED": "1", CAP: "256"},
    "v7+wscap4096": {"TORCH_CUDNN_V8_API_DISABLED": "1", CAP: "4096"},
    "benchmark": {},
}
WARM, WINDOW = 2, 3

CHILD = r"""
import json, os, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke
from afcm_tpu_torch import train as train_cli
from afcm_tpu_torch.data.demo import phantom_train_loaders
from afcm_tpu_torch.ops import conv2d_gradfix

config, dtype, remat, policy, steps, per_conv, warm, window = sys.argv[2:10]
steps, per_conv, warm, window = int(steps), per_conv == "1", int(warm), int(window)
path, opts = {"cmsr": (chip_smoke.TRAIN_CONFIG, []),
              "ccsr": (chip_smoke.CCSR_CONFIG, []),
              "pix2pix": (chip_smoke.PIX2PIX_CONFIG, list(chip_smoke.PIX2PIX_CHANNELS))}[config]
torch.backends.cudnn.benchmark = policy == "benchmark"
if policy != "train":
    train_cli.bound_conv_workspace = lambda device, compute_dtype: False
train_cli.get_train_loaders = lambda cfg, seed=0: phantom_train_loaders(
    depth=(steps + 1) * cfg.loaders.batch_size, size=256,
    batch_size=cfg.loaders.batch_size, seed=seed)
seen, times, row = {}, {}, dict(config=config, dtype=dtype, remat=remat, policy=policy)


def measured(kind, fn):
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ws = torch.cuda.max_memory_allocated() - before - out.numel() * out.element_size()
        x = args[0]
        key = f"{kind} {tuple(x.shape) if hasattr(x, 'shape') else tuple(x)} {str(out.dtype)[6:]}"
        seen[key] = max(seen.get(key, 0), ws)
        return out
    return wrapped


def on_step(step, metrics):
    torch.cuda.synchronize()
    times[step] = time.perf_counter()
    if step == warm:
        torch.cuda.reset_peak_memory_stats()
    if step == steps - 1:
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        row["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        row["losses_finite"] = all(bool(torch.isfinite(v).all()) for v in metrics.values())
        if per_conv:
            conv2d_gradfix.F.conv2d = measured("fwd", conv2d_gradfix.F.conv2d)
            conv2d_gradfix.conv2d_input = measured("dgrad", conv2d_gradfix.conv2d_input)
            conv2d_gradfix.conv2d_weight = measured("wgrad", conv2d_gradfix.conv2d_weight)


train = train_cli.train
train_cli.train = lambda cfg, **kw: train(cfg, max_iters=steps * cfg.loaders.batch_size,
                                          on_step=on_step, **kw)
never = str(10 ** 9)
remat_opts = [] if remat == "off" else ["tpu.remat", "True", "tpu.remat_min_size", remat]
started = time.perf_counter()
with tempfile.TemporaryDirectory() as out_dir:
    train_cli.main(["--config-file", path, "--device", "cuda", *opts, *remat_opts,
                    "tpu.compute_dtype", dtype, "checkpoints_dir", out_dir, "name", "ws",
                    "trainer.display_freq", never, "trainer.print_freq", never,
                    "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never])
ends = list(range(warm, steps, window))
ms = [1e3 * (times[b] - times[a]) / (b - a) for a, b in zip(ends, ends[1:])]
row.update(first_step_s=times[1] - started, ms_per_step=float(np.median(ms)), window_ms=ms,
           workspace_cap_mib=os.environ.get("CUDNN_CONV_WSCAP_DBG"))
if per_conv:
    top = sorted(seen.items(), key=lambda kv: -kv[1])
    row["workspace_gib_top"] = [[k, v / 2 ** 30] for k, v in top[:12]]
    row["workspace_gib_sum_of_max"] = sum(v for _, v in top) / 2 ** 30
print(json.dumps(row))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=["cmsr", "ccsr", "pix2pix"])
    ap.add_argument("--dtype", nargs="+", default=["float32"])
    ap.add_argument("--remat", nargs="+", default=["off"])
    ap.add_argument("--policy", nargs="+", default=["default", "train"], choices=POLICIES)
    ap.add_argument("--steps", type=int, default=WARM + 3 * WINDOW + 1)
    ap.add_argument("--per-conv", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(card, flush=True)
    rows = []
    for config in args.configs:
        for dtype in args.dtype:
            for remat in args.remat:
                for policy in args.policy:
                    env = dict(os.environ, **POLICIES[policy])
                    proc = subprocess.run(
                        [sys.executable, "-c", CHILD, REPO, config, dtype, remat, policy,
                         str(args.steps), str(int(args.per_conv)), str(WARM), str(WINDOW)],
                        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
                        check=False)
                    if proc.returncode != 0:
                        row = dict(config=config, dtype=dtype, remat=remat, policy=policy,
                                   error=proc.stderr[-1500:])
                    else:
                        row = json.loads(proc.stdout.strip().splitlines()[-1])
                    row["card"] = card
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return int(any("error" in row for row in rows))


if __name__ == "__main__":
    sys.exit(main())
