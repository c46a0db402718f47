#!/usr/bin/env python3
"""Generator forward slices/s of the PyTorch port, one leg, many windows.

For telling a change of the code from the host's noise on a leg that is bound
by the host's launches (float32 with TF32 off makes ~33,000 launches a
forward): run it from alternating source trees in one job on one
card, several times each, and compare the windows.

    python scripts/torch_forward_legs.py --tree . --dtype float32 --batch 16
    python scripts/torch_forward_legs.py --tree ../parent --conv-impl int8

``--tree`` is the checkout whose ``afcm_tpu_torch`` is imported (default: the
one this script lies in). The model is the shipped ADNI CMSR generator with
random weights from seed 0, as ``chip_smoke.py`` phase 6 builds it; a window
is ``--iters`` forwards between two ``torch.cuda.synchronize()``. Prints one
JSON line: the card's name and power limit, every window's slices/s, their
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
    model = build_eval_model(CMSR_ADNI_G, compute_dtype=args.dtype,
                             generator=torch.Generator().manual_seed(0))
    model.generator_ema.to("cuda")
    set_matmul_precision(args.dtype)
    set_conv_impl(args.conv_impl)
    gen = torch.Generator(device="cuda").manual_seed(2)
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


if __name__ == "__main__":
    sys.exit(main())
