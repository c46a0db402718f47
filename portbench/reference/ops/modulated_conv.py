# Frozen copy of afcm_tpu_torch/ops/modulated_conv.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Plain and style-modulated convolutions: the scale-activations
factorization of the modulated conv, with the demodulation coefficients from
one [N, I] x [I, O] product."""

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


def modulated_conv2d(x, w, s, demodulate: bool = True, padding=0, input_gain=None):
    """StyleGAN3-style modulated conv (reference: networks_stylegan3.py:24-64)."""
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


def modulated_conv2d_resample(x, weight, styles, noise=None, up: int = 1,
                              down: int = 1, padding: int = 0,
                              resample_filter=None, demodulate: bool = True,
                              flip_weight: bool = True):
    """StyleGAN2-style modulated conv with fused resampling (reference:
    CoModGAN/layers.py:19-77); the noise is added after the demodulation."""
    from .conv2d_resample import conv2d_resample

    batch, in_channels = x.shape[0], weight.shape[1]
    assert styles.shape == (batch, in_channels)
    weight = weight.float()
    styles = styles.float()

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        w_sq = torch.sum(torch.square(weight), dim=(2, 3))          # [O, I]
        dcoefs = torch.rsqrt(torch.square(styles) @ w_sq.T + 1e-8)  # [N, O]
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
