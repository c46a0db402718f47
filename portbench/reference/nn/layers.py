# Frozen copy of afcm_tpu_torch/nn/layers.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Equalized-LR building blocks (``afcm_tpu/nn/layers.py``).

Weights are stored at ``randn * weight_init / lr_multiplier`` scale and
multiplied by the equalized gain at call time, as in the JAX package and the
reference, so ported state_dicts load unchanged. Random initialization draws
from an explicit ``torch.Generator``. ``MinibatchStdLayer`` serves the
discriminator; ``CALayer`` comes with the CoModGAN slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bias_act, conv2d_resample, setup_filter
from ..ops.bias_act import activation_funcs


def normal_parameter(shape, stddev: float,
                     generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * stddev)


class FullyConnected(nn.Module):
    """Equalized-LR dense layer with fused bias+activation."""

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "linear", use_bias: bool = True,
                 lr_multiplier: float = 1.0, weight_init: float = 1.0,
                 bias_init: Union[float, Sequence[float]] = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.weight = normal_parameter((out_features, in_features),
                                       weight_init / lr_multiplier, generator)
        self.bias = None
        if use_bias:
            init = np.broadcast_to(np.asarray(bias_init, np.float32) / lr_multiplier,
                                   (out_features,))
            self.bias = nn.Parameter(torch.tensor(np.array(init)))

    def forward(self, x):
        w = self.weight.to(x.dtype) * self.weight_gain
        b = None
        if self.bias is not None:
            b = self.bias.to(x.dtype)
            if self.lr_multiplier != 1:
                b = b * self.lr_multiplier
        x = x @ w.T
        if self.activation == "linear":
            x = x if b is None else x + b
        else:
            x = bias_act(x, b, act=self.activation)
        return x


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with optional fused FIR up/downsampling."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 use_bias: bool = True, activation: str = "linear",
                 up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1 / np.sqrt(in_channels * kernel_size ** 2)
        self.resample_filter = setup_filter(list(resample_filter))
        self.weight = normal_parameter(
            (out_channels, in_channels, kernel_size, kernel_size), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x, gain: float = 1.0):
        x = conv2d_resample(x, self.weight.to(x.dtype) * self.weight_gain,
                            f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        b = self.bias
        return bias_act(x, None if b is None else b.to(x.dtype),
                        act=self.activation, gain=act_gain, clamp=act_clamp)


class MinibatchStdLayer(nn.Module):
    """Cross-sample stddev feature channel for the discriminator epilogue
    (``afcm_tpu/nn/layers.py:102-121``). Sample n is grouped with n + N/G
    of the batch."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x):
        local = x
        n, c, h, w = x.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        f = self.num_channels
        y = x.reshape(g, -1, f, c // f, h, w)
        y = y - y.mean(dim=0)
        y = torch.sqrt(torch.square(y).mean(dim=0) + 1e-8)
        y = y.mean(dim=(2, 3, 4)).reshape(-1, f, 1, 1)
        y = y.repeat(g, 1, h, w)
        return torch.cat([local, y.to(x.dtype)], dim=1)


def dropout(x, rate: float, train: bool, generator: Optional[torch.Generator],
            keep_mask: Optional[torch.Tensor] = None):
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate). The mask is ``keep_mask`` when given (the
    tests pass flax's), else drawn from an explicit generator, never the
    global RNG, so a train step is reproducible from its seed."""
    if not train or rate == 0:
        return x
    if rate >= 1:
        return torch.zeros_like(x)
    if keep_mask is None:
        if generator is None and x.device.type != "meta":   # meta: counting work
            raise ValueError("train-mode dropout needs a generator or a keep_mask")
        keep_mask = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep_mask, x / (1 - rate), torch.zeros_like(x))


def uniform_parameter(shape, fan_in: int,
                      generator: Optional[torch.Generator]) -> nn.Parameter:
    """torch's default init of nn.Conv2d and nn.Linear (kaiming_uniform with
    a = sqrt(5) for the weight, and the bias): U[-b, b], b = 1/sqrt(fan_in)."""
    bound = 1 / np.sqrt(fan_in)
    return nn.Parameter((torch.rand(shape, generator=generator) * 2 - 1) * bound)


class Conv1x1(nn.Module):
    """A torch-default 1x1 conv, applied to a pooled [N, C] vector."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = uniform_parameter((out_channels, in_channels, 1, 1),
                                        in_channels, generator)
        self.bias = uniform_parameter((out_channels,), in_channels, generator)

    def forward(self, y):
        return F.linear(y, self.weight[:, :, 0, 0].to(y.dtype), self.bias.to(y.dtype))


class CALayer(nn.Module):
    """Squeeze-excite channel attention, RCAB-style
    (``afcm_tpu/nn/layers.py:135-160``; reference: CoModGAN/layers.py:795-811):
    mean over space, 1x1 conv down by ``reduction``, ReLU, 1x1 conv up,
    sigmoid, and the input scaled per channel. The reference builds
    ``conv_du`` from plain nn.Conv2d layers, so both convs take torch's
    default init; the names are the reference's, which the JAX package's
    Dense layers are translated to (``utils/port.py``). Returns the scaled
    input and the [N, C, 1, 1] attention."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = channels // reduction
        self.conv_du = nn.Sequential(Conv1x1(channels, mid, generator), nn.ReLU(),
                                     Conv1x1(mid, channels, generator), nn.Sigmoid())

    def forward(self, x):
        y = self.conv_du(x.mean(dim=(2, 3)))[:, :, None, None]
        return x * y, y


def adaptive_avg_pool2d(x, output_size):
    """NCHW adaptive average pooling. torch's bin edges floor(i*H/oh) ..
    ceil((i+1)*H/oh) are those of the JAX function's general case, and give
    its reshape-mean for divisible sizes."""
    return F.adaptive_avg_pool2d(x, output_size)


def normalize_2nd_moment(x, dim: int = 1, eps: float = 1e-8):
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)
