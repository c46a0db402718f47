#!/usr/bin/env python3
"""Plant a wrong straight-through backward in K4 and run chip_smoke.py's
phase 18 (the shipped config's int8 train step at bf16 b16) on the card:
the phase must pass with K4 as it is and fail with each planted backward.

    python scripts/torch_ste_mutation.py [--mutants none dx_quantized_weight dw_dropped]

The mutants replace ``_Conv3x3Int8STE.backward`` of
``afcm_tpu_torch/ops/cuda/conv_int8.py`` in this process only:
``dx_quantized_weight`` takes dx through the int8-rounded weight (per-tensor
absmax / 127) in place of the float one, ``dw_dropped`` returns a zero
weight gradient. Phase 18 prints its readings (the per-call relative L2 of
dx and dw from the fp32 conv adjoint, G's and D's gradients from the float
step's in dB and relative L2); then one JSON line per mutant says whether
the phase failed and why. Exits 1 unless the phase passes unmutated and
fails under every mutant.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from afcm_tpu_torch.ops import conv2d_gradfix  # noqa: E402
from afcm_tpu_torch.ops.cuda import _build  # noqa: E402
from afcm_tpu_torch.ops.cuda import conv_int8 as k3  # noqa: E402

STE = k3._Conv3x3Int8STE
ORIGINAL = STE.backward


def dx_quantized_weight(ctx, dy):
    x, w = ctx.saved_tensors
    _, dw, rest = ORIGINAL(ctx, dy)
    wf = w.float()
    scale = wf.abs().amax() / 127
    wq = (wf / scale).round().clamp(-127, 127) * scale
    conf = ((1, 1), (ctx.padding, ctx.padding), 1)
    dx = None
    if ctx.needs_input_grad[0]:
        dx = conv2d_gradfix._InputGrad.apply(dy.float(), wq, x.shape, *conf).to(x.dtype)
    return dx, dw, rest


def dw_dropped(ctx, dy):
    dx, dw, rest = ORIGINAL(ctx, dy)
    return dx, None if dw is None else torch.zeros_like(dw), rest


MUTANTS = {"none": ORIGINAL, "dx_quantized_weight": dx_quantized_weight,
           "dw_dropped": dw_dropped}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mutants", nargs="+", default=list(MUTANTS), choices=MUTANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: phase 18 runs on the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip(), flush=True)
    device = torch.device("cuda")
    _build.load_libraries(["filtered_lrelu", "filtered_lrelu_bwd", "conv_int8",
                           "quantize_int8"])
    sound = True
    for name in args.mutants:
        STE.backward = staticmethod(MUTANTS[name])
        try:
            chip_smoke.check_int8_train(device)
            failed, why = False, None
        except AssertionError as exc:
            failed, why = True, str(exc)
        finally:
            STE.backward = staticmethod(ORIGINAL)
        sound &= failed == (name != "none")
        print(json.dumps({"mutant": name, "phase_18_failed": failed, "error": why}),
              flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
