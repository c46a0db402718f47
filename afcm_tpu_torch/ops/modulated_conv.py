"""Plain and style-modulated convolutions (``afcm_tpu/ops/modulated_conv.py``).

The 3x3 convs stay on cuDNN (``F.conv2d`` through ``conv2d_gradfix``, whose
derivatives are convs too), as the JAX package leaves them to ``lax.conv``
outside any Pallas kernel. ``modulated_conv2d`` keeps the JAX
package's scale-activations factorization (reference: the
``fused_modconv=False`` path), with demodulation computed without
materializing per-sample weights:

    conv(x, w * s[n,i] * d[n,o])  ==  d[n,o] * conv(x * s[n,i], w)
    d[n,o] = rsqrt( (s^2)[n,:] @ (sum_k w^2)[:, o] + 1e-8 )

Not ported: the lane channel-pad (``:104-118``, TPU layout) and the int8
route (``:99-102``, ``:122-143``; ROADMAP items B3/B4).
"""

from __future__ import annotations

import numpy as np
import torch

from . import conv2d_gradfix


def conv2d(x, w, padding=0, groups: int = 1, flip_weight: bool = True):
    """NCHW conv2d (correlation when flip_weight, like torch.conv2d);
    padding is an int or (padH, padW), symmetric."""
    if isinstance(padding, (int, np.integer)):
        padding = (int(padding), int(padding))
    else:
        padding = (int(padding[0]), int(padding[1]))
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    return conv2d_gradfix.conv2d(x, w.to(x.dtype), padding=padding, groups=groups)


def modulated_conv2d(x, w, s, demodulate: bool = True, padding=0,
                     input_gain=None):
    """StyleGAN3-style modulated conv (reference: networks_stylegan3.py:24-64).

    Args:
      x: [N, I, H, W] input.
      w: [O, I, kh, kw] weight.
      s: [N, I] styles.
      demodulate: apply weight pre-normalization + demodulation.
      padding: int or (padH, padW).
      input_gain: optional extra scale on input channels: scalar, [I], or [N, I].
    """
    batch = x.shape[0]
    in_channels = w.shape[1]
    assert s.shape == (batch, in_channels)

    w = w.float()
    s = s.float()
    if demodulate:
        w = w * torch.rsqrt(torch.mean(torch.square(w), dim=(1, 2, 3), keepdim=True))
        s = s * torch.rsqrt(torch.mean(torch.square(s)))

    dcoefs = None
    if demodulate:
        w_sq = torch.sum(torch.square(w), dim=(2, 3))             # [O, I]
        dcoefs = torch.rsqrt(torch.square(s) @ w_sq.T + 1e-8)     # [N, O]

    styles = s
    if input_gain is not None:
        input_gain = torch.as_tensor(input_gain, dtype=torch.float32,
                                     device=s.device)
        styles = styles * input_gain.expand(batch, in_channels)

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d(x, w, padding=padding)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    return x
