"""The share (%) of its roofline that kernel K1 or K2 reaches in a traced
tail: the sum of its launches' bounds (the reference's frozen StyleGAN3
layout, the launches' batch and dtype) over its device time."""

from __future__ import annotations

from typing import Optional

import torch

from ..reference.gan import build_generator
from . import trace as tracing
from . import yardstick


def roofline(ctx, pattern: str, backward: bool) -> Optional[float]:
    """``pattern`` names the kernel in the trace; the launches must come in
    whole passes over the generator's K1 layers."""
    seconds, launches = tracing.kernel_seconds(ctx["trace"], pattern)
    if not launches or seconds <= 0:
        return None
    cfg = ctx["config"]
    g_cfg = cfg["model"]["G"]
    if g_cfg["netG"] != "stylegan3":
        return None
    with torch.device("meta"):
        g = build_generator(g_cfg, compute_dtype=cfg["tpu"]["compute_dtype"])
    layers = yardstick.k1_layers(g.synthesis)
    if launches % len(layers):
        raise AssertionError(f"{launches} launches of {pattern} are not whole passes "
                             f"over {len(layers)} layers")
    element = 2 if cfg["tpu"]["compute_dtype"] == "bfloat16" else 4
    batch = cfg["loaders"]["batch_size"]
    bound = yardstick.forward_k1_bound_s(g.synthesis, batch, element, backward)
    return 100.0 * bound * (launches // len(layers)) / seconds
