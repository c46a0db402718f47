# Frozen copy of afcm_tpu_torch/nn/comodgan.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Co-modulated StyleGAN2 generator, the paper's CoModGAN baseline, as
``nn.Module``s (``afcm_tpu/nn/comodgan.py``; reference: models/networks/CoModGAN).

An encoder pyramid of the conditioning image feeds a 1024-d global
co-modulation vector and per-resolution skip features to skip-architecture
synthesis blocks whose modulation vector is ``concat(w, global)``. All
resampling runs through ``conv2d_resample`` and ``upfirdn2d``, and every 3x3
conv through ``ops.modulated_conv.conv2d``. Module and buffer names are the JAX package's, which are
the reference state_dict's.

Randomness is explicit: the train-mode noise of every synthesis layer and
the co-modulation dropout draw from the ``torch.Generator`` the caller
hands over (the train step's own), and eval uses the ``noise_const``
buffers (``noise_mode="const"``). The CoModGAN generator computes in
float32 whatever ``tpu.compute_dtype`` says, as in the JAX package, whose
synthesis keys for this family take no compute dtype
(``afcm_tpu/models/__init__.py:30-34``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import modulated_conv2d_resample, setup_filter, upsample2d
from ..ops.bias_act import activation_funcs, bias_act
from .layers import (CALayer, Conv2dLayer, FullyConnected, dropout,
                     normal_parameter)
from .mapping import MappingNetwork

_DEFAULT_FILTER = (1, 3, 3, 1)


class EFromRGB(nn.Module):
    """fromRGB 1x1 conv (reference: CoModGAN/layers.py:214-223)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.con_layer = Conv2dLayer(in_channels, out_channels, kernel_size=1,
                                     activation="lrelu", generator=generator)

    def forward(self, x, y):
        t = self.con_layer(y)
        return t if x is None else x + t


class EBlock(nn.Module):
    """Two convs, the second with down=2; returns the pre-downsample
    feature for the skips too (reference: CoModGAN/layers.py:228-248)."""

    def __init__(self, tmp_channels: int, out_channels: int,
                 resample_filter: Sequence[int] = _DEFAULT_FILTER,
                 channel_attention: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_layer0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                       activation="lrelu", generator=generator)
        self.conv_layer1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                       activation="lrelu", down=2,
                                       resample_filter=resample_filter,
                                       generator=generator)
        # E_block hardcodes reduction=16 (layers.py:239)
        self.ca = CALayer(out_channels, 16, generator) if channel_attention else None

    def forward(self, x):
        x = self.conv_layer0(x)
        feature = x
        x = self.conv_layer1(x)
        if self.ca is not None:
            x = self.ca(x)[0]
        return x, feature


def layer_noise(noise_mode: str, shape, noise_const, strength, device,
                generator: Optional[torch.Generator]):
    """The noise a synthesis layer adds: drawn from ``generator`` in
    ``random`` mode (never from the global RNG), the ``noise_const`` buffer
    in ``const`` mode, none in ``none`` mode; times the layer's strength."""
    if noise_mode == "none":
        return None
    if noise_mode == "const":
        return noise_const * strength
    if generator is None and device.type != "meta":     # meta: counting work
        raise ValueError("random noise needs a generator (noise_mode 'random')")
    return torch.randn(shape, generator=generator, device=device) * strength


class SynthesisLayerSG2(nn.Module):
    """Modulated conv + noise + lrelu (reference: CoModGAN/layers.py:253-305)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: int = 1,
                 use_noise: bool = True, activation: str = "lrelu",
                 resample_filter: Sequence[int] = _DEFAULT_FILTER,
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolution, self.up = resolution, up
        self.padding = kernel_size // 2
        self.activation, self.conv_clamp = activation, conv_clamp
        self.resample_filter = setup_filter(list(resample_filter))
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0,
                                     generator=generator)
        self.weight = normal_parameter(
            (out_channels, in_channels, kernel_size, kernel_size), 1.0, generator)
        self.use_noise = use_noise
        if use_noise:
            self.register_buffer("noise_const", torch.randn(
                (resolution, resolution), generator=generator))
            self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, w, noise_mode: str = "random", gain: float = 1.0,
                generator: Optional[torch.Generator] = None):
        assert noise_mode in ("random", "const", "none")
        styles = self.affine(w)
        noise = None
        if self.use_noise:
            noise = layer_noise(noise_mode, (x.shape[0], 1, self.resolution,
                                             self.resolution),
                                self.noise_const, self.noise_strength, x.device,
                                generator)
        x = modulated_conv2d_resample(x, self.weight, styles,
                                      noise=noise, up=self.up, padding=self.padding,
                                      resample_filter=self.resample_filter,
                                      flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv without demodulation (reference: layers.py:310-325)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1 / np.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0,
                                     generator=generator)
        self.weight = normal_parameter(
            (out_channels, in_channels, kernel_size, kernel_size), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d_resample(x, self.weight, styles, demodulate=False,
                                      padding=self.padding)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """Skip-architecture block with co-modulation
    (reference: CoModGAN/layers.py:330-450).

    Reference quirk kept: one w (the block's first) modulates conv0, conv1
    and torgb (layers.py:414-417 calls ``next(w_iter)`` once). ``ca_reduction``
    is the CALayer's squeeze ratio (16 in the plain block, layers.py:393;
    CASynthesisBlock's ``reduction``, layers.py:472)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 global_w_dim: int, resolution: int, img_channels: int,
                 is_last: bool, up: int = 2, to_rgb: bool = True,
                 architecture: str = "skip",
                 resample_filter: Sequence[int] = _DEFAULT_FILTER,
                 conv_clamp: Optional[float] = None, cond_mod: bool = False,
                 early_channels: int = 0, channel_attention: bool = False,
                 ca_reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.is_last = in_channels, is_last
        self.architecture, self.cond_mod = architecture, cond_mod
        self.num_conv = (1 if in_channels != 0 else 0) + 1
        self.num_torgb = 1 if to_rgb and (is_last or architecture == "skip") else 0
        self.resample_filter = setup_filter(list(resample_filter))
        mod_dim = w_dim + (global_w_dim if cond_mod else 0)
        layer_kwargs = dict(w_dim=mod_dim, resolution=resolution,
                            resample_filter=resample_filter, conv_clamp=conv_clamp,
                            generator=generator)
        if in_channels == 0:
            conv1_in = early_channels if early_channels > 0 else out_channels
            self.conv1 = SynthesisLayerSG2(conv1_in, out_channels, **layer_kwargs)
        else:
            if architecture == "resnet":
                self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1,
                                        use_bias=False, up=up,
                                        resample_filter=resample_filter,
                                        generator=generator)
            self.conv0 = SynthesisLayerSG2(in_channels, out_channels, up=up,
                                           **layer_kwargs)
            self.conv1 = SynthesisLayerSG2(out_channels, out_channels, **layer_kwargs)
            self.ca = (CALayer(out_channels, ca_reduction, generator)
                       if channel_attention else None)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=mod_dim,
                                    conv_clamp=conv_clamp, generator=generator)

    def forward(self, x, img, ws, global_w, x_skip=None, include_skip: bool = True,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        mod = torch.cat([ws[:, 0], global_w], dim=1) if self.cond_mod else ws[:, 0]
        noise = dict(noise_mode=noise_mode, generator=generator)
        if self.in_channels == 0:
            x = self.conv1(x, mod, **noise)
        else:
            y = self.skip(x, gain=np.sqrt(0.5)) if self.architecture == "resnet" else None
            x = self.conv0(x, mod, **noise)
            if include_skip and x_skip is not None:
                x = x + x_skip.to(x.dtype)
            x = self.conv1(x, mod, gain=np.sqrt(0.5) if y is not None else 1.0, **noise)
            if self.ca is not None:
                x = self.ca(x)[0]
            if y is not None:
                x = y + x
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.is_last or self.architecture == "skip":
            y = self.torgb(x, mod).float()
            img = img + y if img is not None else y
        return x, img


def skip_connects(log2res: int, skip_resolution: int,
                  clamp: bool = False) -> List[bool]:
    """Which resolutions (4, 8, ...) take the encoder's skip feature; with
    ``clamp`` a skip resolution above the output's counts as the output's
    (the CA variant, ``afcm_tpu/nn/ca_variants.py:229-235``)."""
    if skip_resolution >= 4:
        final_skip = int(np.log2(skip_resolution))
        if clamp:
            final_skip = min(final_skip, log2res)
        return [True] * (final_skip - 1) + [False] * (log2res - final_skip)
    return [False] * log2res


class CoModSynthesisNetwork(nn.Module):
    """Encoder pyramid + global vector + synthesis blocks
    (reference: CoModGAN/generator.py:29-125).

    The config's ``resample_filter`` reaches the encoder blocks only: in the
    reference it is a named argument of the network consumed by the E_blocks
    (generator.py:61), so the synthesis blocks always run the default
    [1, 3, 3, 1] (quirk kept, ``afcm_tpu/nn/comodgan.py:313-319``)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels_in: int,
                 img_channels_out: int, channel_base: int = 32768,
                 channel_max: int = 512, dropout_rate: float = 0.5,
                 skip_resolution: int = 256, channel_attention: bool = False,
                 resample_filter: Sequence[int] = _DEFAULT_FILTER,
                 architecture: str = "skip", conv_clamp: Optional[float] = None,
                 cond_mod: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_dim, self.img_resolution = w_dim, img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.dropout_rate = dropout_rate
        log2res = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2res + 1)]
        self.skip_connects = skip_connects(log2res, skip_resolution)
        self.num_ws = 1 + sum(2 + (res == img_resolution)
                              for res in self.block_resolutions[1:])
        ch4 = self.channels(4)
        global_w_dim = ch4 * 2

        self.e_fromrgb = EFromRGB(img_channels_in, self.channels(img_resolution),
                                  generator)
        self.encoder_resolutions = [2 ** res for res in range(log2res, 2, -1)]
        for res in self.encoder_resolutions:
            # channel_attention is for the synthesis blocks: the reference
            # builds these E_blocks without it (generator.py:61)
            self.add_module(f"e_b{int(np.log2(res))}", EBlock(
                self.channels(res), self.channels(res // 2),
                resample_filter=resample_filter, generator=generator))
        self.e_4x4 = Conv2dLayer(ch4, ch4, kernel_size=3, activation="lrelu",
                                 generator=generator)
        self.fc_in = FullyConnected(ch4 * 16, global_w_dim, activation="lrelu",
                                    generator=generator)
        self.fc_out = FullyConnected(global_w_dim, ch4 * 16, activation="lrelu",
                                     generator=generator)
        block_kwargs = dict(w_dim=w_dim, global_w_dim=global_w_dim,
                            img_channels=img_channels_out, architecture=architecture,
                            conv_clamp=conv_clamp, cond_mod=cond_mod,
                            channel_attention=channel_attention, generator=generator)
        self.block_early = SynthesisBlock(0, ch4, resolution=4, is_last=False,
                                          **block_kwargs)
        for res in self.block_resolutions[1:]:
            self.add_module(f"b{res}", SynthesisBlock(
                self.channels(res // 2), self.channels(res), resolution=res,
                is_last=(res == img_resolution), **block_kwargs))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def forward(self, ws, img_in, train: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        """``train`` turns on the co-modulation dropout; it and the
        ``random`` noise draw from ``generator``."""
        assert ws.shape[1:] == (self.num_ws, self.w_dim)
        ws = ws.float()
        e_features: Dict[int, torch.Tensor] = {}
        img = self.e_fromrgb(None, img_in)
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
        return img


class CoModGenerator(nn.Module):
    """mapping + co-modulated synthesis (reference: generator.py:545-572)."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels_in: int, img_channels_out: int,
                 mapping_kwargs=None, synthesis_kwargs=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        synthesis_kwargs = dict(synthesis_kwargs or {})
        if synthesis_kwargs.pop("name", "SynthesisNetwork") != "SynthesisNetwork":
            raise NotImplementedError("the reference holds the plain synthesizer only")
        self.synthesis = CoModSynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels_in=img_channels_in, img_channels_out=img_channels_out,
            generator=generator, **synthesis_kwargs)
        mapping_kwargs = dict(mapping_kwargs or {})
        if mapping_kwargs.pop("name", "MappingNetwork") != "MappingNetwork":
            raise NotImplementedError("the reference holds the plain mapper only")
        mapping_kwargs = {k: v for k, v in mapping_kwargs.items()
                          if k in ("num_layers", "lr_multiplier", "w_avg_beta")}
        mapping_kwargs.setdefault("num_layers", 8)
        mapping_kwargs.setdefault("w_avg_beta", 0.995)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws,
                                      generator=generator, **mapping_kwargs)

    def forward(self, z, c, cond_img, ref_img=None, truncation_psi: float = 1.0,
                truncation_cutoff=None, train: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        """A train-mode forward updates the mapper's ``w_avg``, as the JAX
        generator does (``update_w_avg=train``)."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_w_avg=train)
        return self.synthesis(ws, cond_img, train=train, noise_mode=noise_mode,
                              generator=generator)
