"""filtered_lrelu — bias, up-FIR, leaky ReLU, down-FIR
(``afcm_tpu/ops/filtered_lrelu.py:105-162``).

Dispatch is by device, not by a routing table: a CPU tensor takes the plain
composition (and autograd's backward of it), a CUDA tensor takes the
autograd Function of ``ops/cuda/filtered_lrelu.py`` (kernel K1 forward,
kernel K2 backward) whether or not grad is enabled; it raises on anything
the kernels cannot run rather than falling back.
"""

from __future__ import annotations

import numpy as np

from .cuda.filtered_lrelu import filtered_lrelu_cuda, filtered_lrelu_plain
from .upfirdn2d import parse_padding


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=np.sqrt(2), slope=0.2, clamp=None, flip_filter=False):
    """Filtered leaky ReLU for a batch of NCHW images.

    Args:
      x: [N, C, H, W] input.
      fu / fd: up/down FIR filters (1-D separable numpy taps, or None).
      b: optional per-channel bias [C].
      up / down: integer resampling factors.
      padding: int / [x,y] / [x0,x1,y0,y1] w.r.t. the upsampled image.
      gain, slope, clamp: leaky ReLU parameters (clamp None disables).
    """
    assert x.ndim == 4
    assert isinstance(up, (int, np.integer)) and up >= 1
    assert isinstance(down, (int, np.integer)) and down >= 1
    kwargs = dict(fu=fu, fd=fd, b=b, up=up, down=down,
                  padding=parse_padding(padding), gain=float(gain),
                  slope=float(slope), clamp=clamp, flip_filter=flip_filter)
    # The pure elementwise case (toRGB: no filters, up = down = 1) stays on
    # plain torch ops on every device: the TPU kernel declines it too
    # (afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:428-429).
    if fu is None and fd is None and up == 1 and down == 1:
        return filtered_lrelu_plain(x, **kwargs)
    if x.device.type == "cpu":
        return filtered_lrelu_plain(x, **kwargs)
    return filtered_lrelu_cuda(x, **kwargs)

