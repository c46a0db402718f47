# Frozen copy of filtered_lrelu_plain in afcm_tpu_torch/ops/cuda/filtered_lrelu.py
# at commit 9498692: the plain composition that kernel K1 fuses.
"""filtered_lrelu: bias, up-FIR, leaky ReLU, down-FIR."""

from __future__ import annotations

import numpy as np
import torch

from .bias_act import bias_act
from .upfirdn2d import parse_padding, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=np.sqrt(2), slope=0.2, clamp=None, flip_filter=False):
    """bias -> upfirdn(fu, up, pad, gain=up²) -> lrelu(slope)·gain, clamp ->
    upfirdn(fd, down). A reduced-precision input is filtered in float32 and
    the result rounded to its dtype, as the port's kernels K1 and K2 keep
    their arithmetic in float32 between bf16 loads and stores."""
    if x.dtype != torch.float32:
        b = None if b is None else b.float()
        return filtered_lrelu(x.float(), fu, fd, b, up, down, padding, gain, slope, clamp,
                              flip_filter).to(x.dtype)
    px0, px1, py0, py1 = parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=float(gain), clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
