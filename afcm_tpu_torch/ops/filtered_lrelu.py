"""filtered_lrelu — bias, up-FIR, leaky ReLU, down-FIR
(``afcm_tpu/ops/filtered_lrelu.py:105-162``).

Every call with filters goes through the custom operator
``afcm_tpu_torch::filtered_lrelu`` of ``ops/cuda/filtered_lrelu.py``, on
every device: a CUDA tensor takes kernel K1 (and kernel K2 in the
backward), whether or not grad is enabled, and raises on anything the
kernels cannot run rather than falling back; a CPU tensor takes the plain
composition. Radial (2-D) filters, which no shipped config uses and the
operator's schema does not hold, take the plain composition on the CPU and
raise on the card.
"""

from __future__ import annotations

import numpy as np

from .cuda.filtered_lrelu import (filtered_lrelu_call, filtered_lrelu_cuda,
                                  filtered_lrelu_plain)
from .filter_design import filter_size
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
    kwargs = dict(fu=fu, fd=fd, b=b, up=up, down=down, padding=padding,
                  gain=float(gain), slope=float(slope), clamp=clamp,
                  flip_filter=flip_filter)
    # The pure elementwise case (toRGB: no filters, up = down = 1) stays on
    # plain torch ops on every device: the TPU kernel declines it too
    # (afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:428-429).
    if fu is None and fd is None and up == 1 and down == 1:
        return filtered_lrelu_plain(x, **kwargs)
    radial = any(f is not None and np.ndim(f) != 1 for f in (fu, fd))
    if radial and x.device.type == "cpu":
        return filtered_lrelu_plain(x, **kwargs)
    if x.device.type == "cuda":
        return filtered_lrelu_cuda(x, **kwargs)
    return filtered_lrelu_call(x, **kwargs)


def filtered_lrelu_output_size(in_size, fu, fd, up, down, padding):
    """Static output (h, w) of ``filtered_lrelu`` for an input of
    ``in_size`` (h, w) (``afcm_tpu/ops/filtered_lrelu.py:154-163``)."""
    px0, px1, py0, py1 = parse_padding(padding)
    fu_w, fu_h = filter_size(fu)
    fd_w, fd_h = filter_size(fd)
    in_h, in_w = in_size
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down
    return out_h, out_w
