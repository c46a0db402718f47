#!/usr/bin/env python3
"""Generator forward slices/s (or train step ms) of the PyTorch port, one
leg, many windows.

For telling a change of the code from the host's noise on a leg that is bound
by the host's launches (float32 with TF32 off makes ~33,000 launches a
forward): run it from alternating source trees in one job on one
card, several times each, and compare the windows.

    python scripts/torch_forward_legs.py --tree . --dtype float32 --batch 16
    python scripts/torch_forward_legs.py --tree ../parent --conv-impl int8
    python scripts/torch_forward_legs.py --tree . --dtype bfloat16 --train

``--tree`` is the checkout whose ``afcm_tpu_torch`` is imported (default: the
one this script lies in). The model is the shipped ADNI CMSR generator with
random weights from seed 0, as ``chip_smoke.py`` phase 6 builds it; a window
is ``--iters`` forwards between two ``torch.cuda.synchronize()``. With
``--train`` a window is ``--iters`` steps of ``GANModel.train_step`` of the
shipped training config (configs/adni/stylegan3/cmsr.yml, G and D from seed
0, R1 every step) on one seeded batch, and the rate is ms/step. Prints one
JSON line: the card's name and power limit, every window's rate, their
median, minimum and maximum.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--conv-impl", default="xla", choices=["xla", "int8"])
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--label", default=None)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from afcm_tpu_torch.evaluate import set_matmul_precision
    from afcm_tpu_torch.models import CMSR_ADNI_G, build_eval_model
    from afcm_tpu_torch.ops import set_conv_impl
    import afcm_tpu_torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    set_matmul_precision(args.dtype)
    set_conv_impl(args.conv_impl)
    gen = torch.Generator(device="cuda").manual_seed(2)
    if args.train:
        return train_windows(args, tree, card, gen)
    model = build_eval_model(CMSR_ADNI_G, compute_dtype=args.dtype,
                             generator=torch.Generator().manual_seed(0))
    model.generator_ema.to("cuda")
    z = torch.randn((args.batch, 512), generator=gen, device="cuda")
    c = torch.rand((args.batch, 1), generator=gen, device="cuda")
    cond = torch.randn((args.batch, 4, 256, 256), generator=gen, device="cuda").clamp(-1, 1)
    for _ in range(2):
        model.eval_step(cond, c, z=z)
    torch.cuda.synchronize()
    rates = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            model.eval_step(cond, c, z=z)
        torch.cuda.synchronize()
        rates.append(args.batch * args.iters / (time.perf_counter() - t0))
    print(json.dumps({
        "label": args.label or tree, "package": os.path.dirname(afcm_tpu_torch.__file__),
        "card": card, "leg": f"{args.dtype}_b{args.batch}_{args.conv_impl}",
        "windows": args.windows, "iters": args.iters, "slices_per_s": rates,
        "median": float(np.median(rates)), "min": min(rates), "max": max(rates)}))
    return 0


def train_windows(args, tree, card, gen):
    import numpy as np
    import torch
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_gan_model
    cfg = default_argument_parser([
        "--config-file", os.path.join(tree, "configs/adni/stylegan3/cmsr.yml"),
        "tpu.compute_dtype", args.dtype, "loaders.batch_size", str(args.batch)])
    model = build_gan_model(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
    batch = {"A": torch.rand((args.batch, 4, 256, 256), generator=gen, device="cuda") * 2 - 1,
             "B": torch.rand((args.batch, 1, 256, 256), generator=gen, device="cuda") * 2 - 1,
             "slice_idx": torch.rand((args.batch, 1), generator=gen, device="cuda")}
    nimg = [0.0]

    def step():
        nimg[0] += args.batch
        model.train_step(batch, nimg[0], with_r1=True, generator=gen)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / args.iters)
    print(json.dumps({
        "label": args.label or tree, "card": card,
        "leg": f"train_{args.dtype}_b{args.batch}", "windows": args.windows,
        "iters": args.iters, "ms_per_step": ms, "median": float(np.median(ms)),
        "min": min(ms), "max": max(ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
