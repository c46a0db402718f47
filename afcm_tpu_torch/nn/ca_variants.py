"""Channel-attention and pixel-shuffle synthesis variants of the CoModGAN
family (``afcm_tpu/nn/ca_variants.py``; reference: CoModGAN/generator.py:300-541,
layers.py:455-526, 742-856).

The CAIN-style alternatives that ``synthesis_kwargs.name`` selects
(``CASynthesisNetwork``, ``CAINSynthesisNetwork``). No published config
uses them; they are part of the selectable surface. The plain convs take
torch's default init and go through ``ops.modulated_conv.conv2d``, as the
JAX package's ``_PlainConv`` goes through its ``conv2d``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv2d_gradfix
from ..ops.modulated_conv import conv2d
from .comodgan import EBlock, SynthesisBlock, skip_connects
from .layers import (CALayer, Conv2dLayer, FullyConnected, dropout,
                     uniform_parameter)


def pixel_shuffle(x, scale_factor):
    """Pixel (un)shuffle by a power-of-2 factor (reference: layers.py:742-757)."""
    n, c, h, w = x.shape
    if scale_factor >= 1:
        s = int(scale_factor)
        oc = c // (s * s)
        x = x.reshape(n, oc, s, s, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, oc, h * s, w * s)
    s = int(round(1 / scale_factor))
    oh, ow = h // s, w // s
    x = x.reshape(n, c, oh, s, ow, s).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * s * s, oh, ow)


class PlainConv(nn.Module):
    """torch-default Conv2d (k3, padding 1) with bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = in_channels * kernel_size * kernel_size
        self.padding = kernel_size // 2
        self.weight = uniform_parameter(
            (out_channels, in_channels, kernel_size, kernel_size), fan_in, generator)
        self.bias = uniform_parameter((out_channels,), fan_in, generator)

    def forward(self, x):
        return conv2d(x, self.weight, padding=self.padding) + \
            self.bias[None, :, None, None].to(x.dtype)


class ConvNorm(nn.Module):
    """Reflection-padded conv with optional instance norm
    (reference: layers.py:772-791)."""

    def __init__(self, in_feat: int, out_feat: int, kernel_size: int,
                 stride: int = 1, norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = in_feat * kernel_size * kernel_size
        self.pad, self.stride, self.norm = kernel_size // 2, stride, norm
        self.weight = uniform_parameter((out_feat, in_feat, kernel_size, kernel_size),
                                        fan_in, generator)
        self.bias = uniform_parameter((out_feat,), fan_in, generator)

    def forward(self, x):
        p = self.pad
        x = F.pad(x, (p, p, p, p), mode="reflect")
        x = conv2d_gradfix.conv2d(x, self.weight.to(x.dtype), stride=self.stride)
        x = x + self.bias[None, :, None, None].to(x.dtype)
        if self.norm:
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
        return x


class RCAB(nn.Module):
    """Residual channel-attention block (reference: layers.py:814-840)."""

    def __init__(self, in_feat: int, out_feat: int, kernel_size: int,
                 reduction: int = 16, norm: bool = False, downscale: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = ConvNorm(in_feat, out_feat, kernel_size,
                              stride=2 if downscale else 1, norm=norm,
                              generator=generator)
        self.conv1 = ConvNorm(out_feat, out_feat, kernel_size, stride=1, norm=norm,
                              generator=generator)
        self.ca = CALayer(out_feat, reduction, generator)
        self.down = ConvNorm(in_feat, out_feat, 3, stride=2,
                             generator=generator) if downscale else None

    def forward(self, x):
        h = self.ca(self.conv1(torch.relu(self.conv0(x))))[0]
        res = x if self.down is None else self.down(x)
        return res + h


class ResidualGroup(nn.Module):
    """RCABs with a trailing conv and the group's skip
    (reference: layers.py:844-856)."""

    def __init__(self, n_resblocks: int, n_feat: int, kernel_size: int,
                 reduction: int = 16, norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_resblocks = n_resblocks
        for i in range(n_resblocks):
            self.add_module(f"rcab{i}", RCAB(n_feat, n_feat, kernel_size, reduction,
                                             norm=norm, generator=generator))
        self.tail = ConvNorm(n_feat, n_feat, kernel_size, norm=norm, generator=generator)

    def forward(self, x):
        res = x
        for i in range(self.n_resblocks):
            res = getattr(self, f"rcab{i}")(res)
        return x + self.tail(res)


class PixShuffleEarlyBlock(nn.Module):
    """Per-channel pixel unshuffle, then a plain conv
    (reference: generator.py:300-315)."""

    def __init__(self, in_channels: int, out_channels: int, depth: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.depth = in_channels, depth
        self.headConv = PlainConv(in_channels * 4 ** depth, out_channels,
                                  generator=generator)

    def forward(self, x):
        parts = [pixel_shuffle(x[:, i:i + 1], 1 / 2 ** self.depth)
                 for i in range(self.in_channels)]
        return self.headConv(torch.cat(parts, dim=1))


class PixShuffleTailBlock(nn.Module):
    """A plain conv, then pixel shuffle (reference: generator.py:321-332)."""

    def __init__(self, in_channels: int, out_channels: int, depth: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.tailConv = PlainConv(in_channels, out_channels * 4 ** depth,
                                  generator=generator)

    def forward(self, x):
        return pixel_shuffle(self.tailConv(x), 2 ** self.depth)


class CASynthesisNetwork(nn.Module):
    """Pixel-shuffle encoder, channel-attention E-blocks and SynthesisBlocks
    (reference: generator.py:338-443).

    As in the JAX package, synthesis runs to img_resolution/2 and the
    pixel-shuffle tail restores the full resolution, and the encoder runs
    from img_resolution/2 (the reference's full-length pyramid ends at 2x2
    against a 4x4 fc_in, ``afcm_tpu/nn/ca_variants.py:245-250``). The
    config's ``resample_filter`` reaches the encoder blocks only."""

    inter_channels_out = 16   # 4 ** 2

    def __init__(self, w_dim: int, img_resolution: int, img_channels_in: int,
                 img_channels_out: int, channel_base: int = 32768,
                 channel_max: int = 512, dropout_rate: float = 0.5,
                 skip_resolution: int = 256,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 architecture: str = "skip", conv_clamp: Optional[float] = None,
                 cond_mod: bool = False, channel_attention: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_dim, self.channel_base, self.channel_max = w_dim, channel_base, channel_max
        self.dropout_rate = dropout_rate
        synth_resolution = img_resolution // 2
        log2res = int(np.log2(img_resolution))
        log2synth = int(np.log2(synth_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2synth + 1)]
        self.skip_connects = skip_connects(log2synth, skip_resolution, clamp=True)
        self.num_ws = 1 + sum(2 + (res == synth_resolution)
                              for res in self.block_resolutions[1:])
        ch4 = self.channels(4)
        global_w_dim = ch4 * 2

        self.e_fromrgb = PixShuffleEarlyBlock(img_channels_in,
                                              self.channels(img_resolution // 2),
                                              depth=1, generator=generator)
        self.encoder_resolutions = [2 ** res for res in range(log2res - 1, 2, -1)]
        for res in self.encoder_resolutions:
            self.add_module(f"e_b{int(np.log2(res))}", EBlock(
                self.channels(res), self.channels(res // 2),
                resample_filter=resample_filter, channel_attention=True,
                generator=generator))
        self.e_4x4 = Conv2dLayer(ch4, ch4, kernel_size=3, activation="lrelu",
                                 generator=generator)
        self.fc_in = FullyConnected(ch4 * 16, global_w_dim, activation="lrelu",
                                    generator=generator)
        self.fc_out = FullyConnected(global_w_dim, ch4 * 16, activation="lrelu",
                                     generator=generator)
        block_kwargs = dict(w_dim=w_dim, global_w_dim=global_w_dim,
                            img_channels=self.inter_channels_out,
                            architecture=architecture, conv_clamp=conv_clamp,
                            cond_mod=cond_mod, channel_attention=channel_attention,
                            generator=generator)
        self.block_early = SynthesisBlock(0, ch4, resolution=4, is_last=False,
                                          **block_kwargs)
        for res in self.block_resolutions[1:]:
            self.add_module(f"b{res}", SynthesisBlock(
                self.channels(res // 2), self.channels(res), resolution=res,
                is_last=(res == synth_resolution), **block_kwargs))
        self.d_torgb = PixShuffleTailBlock(self.inter_channels_out, img_channels_out,
                                           depth=1, generator=generator)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def forward(self, ws, img_in, train: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        ws = ws.float()
        img = self.e_fromrgb(img_in)
        e_features: Dict[int, torch.Tensor] = {}
        for res in self.encoder_resolutions:
            img, e_features[res] = getattr(self, f"e_b{int(np.log2(res))}")(img)
        img = self.e_4x4(img)
        e_features[4] = img
        pooled = self.fc_in(img.reshape(img.shape[0], -1))
        img_global = dropout(pooled, self.dropout_rate, train, generator)
        seed = self.fc_out(img_global).reshape(-1, self.channels(4), 4, 4)
        if self.skip_connects[0]:
            seed = seed + e_features[4]

        noise = dict(noise_mode=noise_mode, generator=generator)
        x, img = self.block_early(seed, None, ws[:, :1], img_global, **noise)
        w_idx = self.block_early.num_conv
        for res, skip in zip(self.block_resolutions[1:], self.skip_connects[1:]):
            block = getattr(self, f"b{res}")
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + block.num_torgb],
                           img_global, x_skip=e_features.get(res), include_skip=skip,
                           **noise)
            w_idx += block.num_conv
        return self.d_torgb(img)


class CAINSynthesisNetwork(nn.Module):
    """CAIN-style residual-group SR network (reference: generator.py:448-541)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels_in: int,
                 img_channels_out: int, depth: int = 3, n_resgroups: int = 5,
                 n_resblocks: int = 12, reduction: int = 16,
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_channels_in, self.depth = img_channels_in, depth
        self.n_resgroups, self.n_resblocks = n_resgroups, n_resblocks
        self.num_ws = 2 * n_resgroups * n_resblocks
        n_feats = 4 ** depth
        resolution = int(img_resolution / 2 ** depth)
        self.headConv = PlainConv(img_channels_in * n_feats, n_feats, generator=generator)
        for g in range(n_resgroups):
            for b in range(n_resblocks):
                self.add_module(f"b{g}_{b}", SynthesisBlock(
                    n_feats, n_feats, w_dim=w_dim, global_w_dim=0,
                    resolution=resolution, img_channels=img_channels_out,
                    is_last=False, up=1, to_rgb=False, architecture="resnet",
                    conv_clamp=conv_clamp, cond_mod=False, channel_attention=True,
                    ca_reduction=reduction, generator=generator))
        self.tailConv = PlainConv(n_feats, n_feats, generator=generator)

    def forward(self, ws, img_in, train: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        parts = [pixel_shuffle(img_in[:, i:i + 1], 1 / 2 ** self.depth)
                 for i in range(self.img_channels_in)]
        x = self.headConv(torch.cat(parts, dim=1))
        ws = ws.float()
        ws_idx = 0
        global_res = x
        for g in range(self.n_resgroups):
            res_x = x
            for b in range(self.n_resblocks):
                block = getattr(self, f"b{g}_{b}")
                x = block(x, None, ws[:, ws_idx:ws_idx + block.num_conv], None,
                          include_skip=False, noise_mode=noise_mode,
                          generator=generator)[0]
                ws_idx += block.num_conv
            x = x + res_x
        x = self.tailConv(x + global_res)
        return pixel_shuffle(torch.tanh(x), 2 ** self.depth)
