# Frozen copy of afcm_tpu_torch/nn/stylegan3.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""AFCM alias-free generator (StyleGAN3 branch) as ``nn.Module``s
(``afcm_tpu/nn/stylegan3.py``).

A U-shaped network of 14 alias-free EncoderLayers feeding per-resolution
skip features and a 1024-d global co-modulation vector, followed by 15
alias-free SynthesisLayers whose affine styles condition on
``concat(w, global)``. All geometry (cutoffs, sampling rates, paddings,
filter taps, skip wiring) is numpy at construction; the taps are plain numpy
constants, never state. Every layer but toRGB ends in ``filtered_lrelu``,
here the plain composition of bias, up-FIR, leaky ReLU and down-FIR.

Training never updates ``magnitude_ema``: the JAX train step calls the
generator without ``update_emas`` (``afcm_tpu/models/gan_model.py:153-156``),
so the buffer keeps its initial value of 1, as it does here.

The layout below is a copy of ``afcm_tpu/nn/stylegan3.py:41-202``, which
cannot be imported without flax; ``tests/test_torch_ops.py`` holds the two
equal. The TPU-only ``channel_align`` is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv2d, design_lowpass_filter, filtered_lrelu, modulated_conv2d
from .layers import (Conv2dLayer, FullyConnected, adaptive_avg_pool2d, dropout,
                     normal_parameter)
from .mapping import MappingNetwork

# ---------------------------------------------------------------------------
# Static layout


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    is_torgb: bool = False
    is_critically_sampled: bool = False


@dataclasses.dataclass(frozen=True)
class SynthesisLayout:
    """Static wiring of the AFCM U-net (reference: networks_stylegan3.py:555-705)."""

    encoder_specs: Tuple[LayerSpec, ...]
    decoder_specs: Tuple[LayerSpec, ...]
    # encoder index -> skip key (output size) recorded after that layer
    encoder_records: Tuple[Tuple[int, int], ...]
    # decoder index -> skip key, or None
    decoder_skips: Tuple[Optional[int], ...]
    bottleneck_channels: int
    num_ws: int
    margin_size: int
    output_scale: float


def compute_synthesis_layout(img_resolution: int, img_channels_in: int,
                             img_channels_out: int, channel_base: int,
                             channel_max: int, num_layers: int,
                             num_critical: int, first_cutoff: float,
                             first_stopband: float, last_stopband_rel: float,
                             margin_size: int, output_scale: float,
                             skip_resolution: int) -> SynthesisLayout:
    # Geometric progression of cutoffs / stopbands
    # (reference: networks_stylegan3.py:595-611).
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + margin_size * 2
    sizes_enc = sizes.copy()
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels_out

    log2res = int(np.log2(img_resolution))
    if skip_resolution >= 4:
        final_skip = int(np.log2(skip_resolution))
        skip_connects = [True] * (final_skip - 1) + [False] * (log2res - final_skip)
    else:
        skip_connects = [False] * log2res

    # Encoder: reversed schedule (reference: networks_stylegan3.py:613-633).
    encoder_specs: List[LayerSpec] = []
    encoder_records: List[Tuple[int, int]] = []
    for idx in range(num_layers):
        rev_idx = num_layers - idx - 1
        prev = max(idx - 1, 0)
        rev_prev = num_layers - prev - 1
        encoder_specs.append(LayerSpec(
            in_channels=img_channels_in if idx == 0 else int(channels[rev_prev]),
            out_channels=int(channels[rev_idx]),
            in_size=int(sizes_enc[rev_prev]), out_size=int(sizes_enc[rev_idx]),
            in_sampling_rate=int(sampling_rates[rev_prev]),
            out_sampling_rate=int(sampling_rates[rev_idx]),
            in_cutoff=float(cutoffs[rev_prev]), out_cutoff=float(cutoffs[rev_idx]),
            in_half_width=float(half_widths[rev_prev]),
            out_half_width=float(half_widths[rev_idx]),
            is_critically_sampled=(idx < num_layers - num_critical)))
        # Skip-feature recording condition (reference: networks_stylegan3.py:679-680).
        if sizes[rev_idx] != sizes[rev_prev] and sizes[rev_prev] != sizes[0]:
            encoder_records.append((idx, int(sizes[rev_idx])))

    # Decoder (reference: networks_stylegan3.py:648-664, skip logic 689-698).
    decoder_specs: List[LayerSpec] = []
    decoder_skips: List[Optional[int]] = []
    res_idx = 1
    for idx in range(num_layers + 1):
        prev = max(idx - 1, 0)
        is_torgb = (idx == num_layers)
        decoder_specs.append(LayerSpec(
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=int(sizes[prev]), out_size=int(sizes[idx]),
            in_sampling_rate=int(sampling_rates[prev]),
            out_sampling_rate=int(sampling_rates[idx]),
            in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
            in_half_width=float(half_widths[prev]),
            out_half_width=float(half_widths[idx]),
            is_torgb=is_torgb,
            is_critically_sampled=(idx >= num_layers - num_critical)))
        nxt = min(idx + 1, num_layers)
        if sizes[idx] != sizes[nxt] and sizes[idx] != sizes[0]:
            include = skip_connects[res_idx]
            res_idx += 1
        else:
            include = False
        decoder_skips.append(int(sizes[idx]) if include else None)

    # Every decoder skip key must be produced by an encoder record with
    # matching channel count.
    recorded = {key: encoder_specs[i].out_channels for i, key in encoder_records}
    for spec, key in zip(decoder_specs, decoder_skips):
        if key is not None:
            assert key in recorded, f"skip key {key} never recorded by encoder"
            assert recorded[key] == spec.out_channels, (
                f"skip channel mismatch at {key}: {recorded[key]} vs {spec.out_channels}")

    return SynthesisLayout(
        encoder_specs=tuple(encoder_specs), decoder_specs=tuple(decoder_specs),
        encoder_records=tuple(encoder_records), decoder_skips=tuple(decoder_skips),
        bottleneck_channels=int(channels[0]), num_ws=num_layers + 2,
        margin_size=margin_size, output_scale=output_scale)


def _design_layer_filters(spec: LayerSpec, is_torgb: bool, filter_size: int,
                          lrelu_upsampling: int, use_radial_filters: bool):
    """Up/down filter taps + padding for one alias-free layer
    (reference: networks_stylegan3.py:313-334)."""
    tmp_rate = max(spec.in_sampling_rate, spec.out_sampling_rate) * \
        (1 if is_torgb else lrelu_upsampling)
    up_factor = int(np.rint(tmp_rate / spec.in_sampling_rate))
    assert spec.in_sampling_rate * up_factor == tmp_rate
    up_taps = filter_size * up_factor if up_factor > 1 and not is_torgb else 1
    up_filter = design_lowpass_filter(
        numtaps=up_taps, cutoff=spec.in_cutoff, width=spec.in_half_width * 2,
        fs=tmp_rate)

    down_factor = int(np.rint(tmp_rate / spec.out_sampling_rate))
    assert spec.out_sampling_rate * down_factor == tmp_rate
    down_taps = filter_size * down_factor if down_factor > 1 and not is_torgb else 1
    down_radial = use_radial_filters and not spec.is_critically_sampled
    down_filter = design_lowpass_filter(
        numtaps=down_taps, cutoff=spec.out_cutoff,
        width=spec.out_half_width * 2, fs=tmp_rate, radial=down_radial)

    conv_kernel = 1 if is_torgb else 3
    in_size = np.broadcast_to(np.asarray(spec.in_size), (2,))
    out_size = np.broadcast_to(np.asarray(spec.out_size), (2,))
    pad_total = (out_size - 1) * down_factor + 1
    pad_total -= (in_size + conv_kernel - 1) * up_factor
    pad_total += up_taps + down_taps - 2
    pad_lo = (pad_total + up_factor) // 2
    pad_hi = pad_total - pad_lo
    padding = (int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1]))
    return up_filter, down_filter, up_factor, down_factor, padding


# ---------------------------------------------------------------------------
# Layers


class EncoderLayer(nn.Module):
    """Alias-free encoder layer: conv3x3 -> filtered lrelu (+resampling).
    Reference: networks_stylegan3.py:416-549."""

    def __init__(self, spec: LayerSpec, conv_kernel: int = 3,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.conv_kernel = conv_kernel
        self.conv_clamp = conv_clamp
        (self.up_filter, self.down_filter, self.up, self.down,
         self.padding) = _design_layer_filters(
            spec, is_torgb=False, filter_size=filter_size,
            lrelu_upsampling=lrelu_upsampling,
            use_radial_filters=use_radial_filters)
        self.weight_gain = 1 / np.sqrt(spec.in_channels * conv_kernel ** 2)
        self.weight = normal_parameter(
            (spec.out_channels, spec.in_channels, conv_kernel, conv_kernel),
            1.0, generator)
        self.bias = nn.Parameter(torch.zeros(spec.out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))

    def forward(self, x):
        spec = self.spec
        assert x.shape[1:] == (spec.in_channels, spec.in_size, spec.in_size), \
            f"EncoderLayer: got {tuple(x.shape)}, want {spec}"
        x = conv2d(x, self.weight.to(x.dtype) * self.weight_gain,
                   padding=self.conv_kernel - 1)
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter,
                           b=self.bias.to(x.dtype), up=self.up,
                           down=self.down, padding=self.padding, gain=np.sqrt(2),
                           slope=0.2, clamp=self.conv_clamp)
        assert x.shape[1:] == (spec.out_channels, spec.out_size, spec.out_size)
        return x


class SynthesisLayer(nn.Module):
    """Alias-free modulated layer with global co-modulation
    (reference: networks_stylegan3.py:252-379). The affine input is
    ``concat(w, global_w)`` when ``cond_mod`` — the AFCM graft."""

    def __init__(self, spec: LayerSpec, w_dim: int, global_w_dim: int,
                 cond_mod: bool = True, conv_kernel: int = 3,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.cond_mod = cond_mod
        self.conv_clamp = conv_clamp
        self.kernel = 1 if spec.is_torgb else conv_kernel
        (self.up_filter, self.down_filter, self.up, self.down,
         self.padding) = _design_layer_filters(
            spec, is_torgb=spec.is_torgb, filter_size=filter_size,
            lrelu_upsampling=lrelu_upsampling,
            use_radial_filters=use_radial_filters)
        affine_in = w_dim + (global_w_dim if cond_mod else 0)
        self.affine = FullyConnected(affine_in, spec.in_channels, bias_init=1.0,
                                     generator=generator)
        self.weight = normal_parameter(
            (spec.out_channels, spec.in_channels, self.kernel, self.kernel),
            1.0, generator)
        self.bias = nn.Parameter(torch.zeros(spec.out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))

    def forward(self, w, x, global_w, x_skip=None):
        spec = self.spec
        assert x.shape[1:] == (spec.in_channels, spec.in_size, spec.in_size), \
            f"SynthesisLayer: got {tuple(x.shape)}, want {spec}"
        input_gain = torch.rsqrt(self.magnitude_ema)
        if self.cond_mod:
            w = torch.cat([w, global_w], dim=1)
        styles = self.affine(w)
        if spec.is_torgb:
            styles = styles * (1 / np.sqrt(spec.in_channels * self.kernel ** 2))

        x = modulated_conv2d(x, self.weight, styles, demodulate=not spec.is_torgb,
                             padding=self.kernel - 1, input_gain=input_gain)
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter,
                           b=self.bias.to(x.dtype), up=self.up,
                           down=self.down, padding=self.padding,
                           gain=1 if spec.is_torgb else np.sqrt(2),
                           slope=1 if spec.is_torgb else 0.2,
                           clamp=self.conv_clamp)
        assert x.shape[1:] == (spec.out_channels, spec.out_size, spec.out_size)
        if x_skip is not None:
            x = x + x_skip.to(x.dtype)
        return x


class SynthesisInput(nn.Module):
    """Fourier-feature input grid of upstream StyleGAN3 (reference:
    networks_stylegan3.py:168-248; ``afcm_tpu/nn/stylegan3.py:320-372``).
    The AFCM generator does not use it: its encoder takes the input's place.

    ``freqs`` and ``phases`` are persistent buffers drawn at construction
    from ``generator``. ``transform`` is the reference's persistent
    identity buffer, kept so that a reference state_dict loads strictly;
    as in ``afcm_tpu``, the forward does not read it (ROADMAP C16)."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        freqs = torch.randn((channels, 2), generator=generator)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", torch.rand((channels,), generator=generator) - 0.5)
        self.weight = normal_parameter((channels, channels), 1.0, generator)
        self.affine = FullyConnected(w_dim, 4, weight_init=0, bias_init=(1, 0, 0, 0),
                                     generator=generator)
        self.register_buffer("transform", torch.eye(3, 3))

    def forward(self, w):
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        # inverse rotation and translation applied to the frequencies
        r_c, r_s, t_x, t_y = t.unbind(dim=1)
        rot = torch.stack([torch.stack([r_c, -r_s], -1),
                           torch.stack([r_s, r_c], -1)], -2)          # [B, 2, 2]
        freqs = torch.einsum("cf,bfg->bcg", self.freqs, rot)
        phases = self.phases[None] + freqs[:, :, 0] * -t_x[:, None] \
            + freqs[:, :, 1] * -t_y[:, None]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        # the sampling grid of affine_grid with align_corners=False
        half = 0.5 * self.size / self.sampling_rate
        coords = (np.arange(self.size) * 2 + 1) / self.size - 1
        gy, gx = np.meshgrid(coords * half, coords * half, indexing="ij")
        grid = torch.tensor(np.stack([gx, gy], axis=-1), dtype=torch.float32,
                            device=w.device)                           # [H, W, 2]
        x = torch.einsum("hwf,bcf->bhwc", grid, freqs) + phases[:, None, None, :]
        x = torch.sin(x * (np.pi * 2)) * amplitudes[:, None, None, :]
        x = x @ (self.weight.T / np.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SynthesisNetwork(nn.Module):
    """AFCM U-shaped synthesis network (reference: networks_stylegan3.py:555-705).

    ``compute_dtype`` ("float32" | "bfloat16") is the dtype of the conv
    stack; styles, demodulation and the co-modulation FC stay fp32 and the
    output is fp32, as in the JAX package (``:409-413``).
    """

    def __init__(self, w_dim: int, img_resolution: int, img_channels_in: int,
                 img_channels_out: int, channel_base: int = 32768,
                 channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1,
                 last_stopband_rel: float = 2 ** 0.3, margin_size: int = 10,
                 output_scale: float = 0.25, dropout_rate: float = 0.5,
                 skip_resolution: int = 256, cond_mod: bool = True,
                 conv_kernel: int = 3, filter_size: int = 6,
                 lrelu_upsampling: Optional[int] = None,
                 use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256,
                 global_w_dim: int = 512 * 2, compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels_out = img_channels_out
        self.num_ws = num_layers + 2
        self.dropout_rate = dropout_rate
        self.compute_dtype = _DTYPES[compute_dtype]
        self.layout = layout = compute_synthesis_layout(
            img_resolution, img_channels_in, img_channels_out, channel_base,
            channel_max, num_layers, num_critical, first_cutoff,
            first_stopband, last_stopband_rel, margin_size, output_scale,
            skip_resolution)
        common = dict(conv_kernel=conv_kernel, filter_size=filter_size,
                      use_radial_filters=use_radial_filters,
                      conv_clamp=conv_clamp, generator=generator)
        # None reproduces the reference default construction (encoder lrelu
        # at 1x, decoder at 2x); the shipped configs pass 2 for both.
        enc_up = lrelu_upsampling or 1
        dec_up = lrelu_upsampling or 2

        self.encoders = []
        for idx, spec in enumerate(layout.encoder_specs):
            layer = EncoderLayer(spec, lrelu_upsampling=enc_up, **common)
            self.add_module(f"encoder_{idx}", layer)
            self.encoders.append(layer)
        c = layout.bottleneck_channels
        self.e_16x16 = Conv2dLayer(c, c, kernel_size=3, activation="lrelu",
                                   conv_clamp=None, generator=generator)
        self.fc_in = FullyConnected(c * 16, global_w_dim, activation="lrelu",
                                    generator=generator)
        self.decoders = []
        for idx, spec in enumerate(layout.decoder_specs):
            layer = SynthesisLayer(spec, w_dim=w_dim, global_w_dim=global_w_dim,
                                   cond_mod=cond_mod, lrelu_upsampling=dec_up,
                                   **common)
            self.add_module(f"L{idx}_{spec.out_size}_{spec.out_channels}", layer)
            self.decoders.append(layer)

    def forward(self, ws, img_in, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train`` turns on the co-modulation dropout, whose keep-mask is
        drawn from ``generator`` (a ``torch.Generator`` on the device of
        ``img_in``)."""
        layout = self.layout
        assert ws.shape[1:] == (self.num_ws, self.w_dim)
        ws = ws.float()
        m = layout.margin_size
        x = F.pad(img_in, (m, m, m, m)).to(self.compute_dtype)

        records = dict(layout.encoder_records)
        e_features: Dict[int, torch.Tensor] = {}
        for idx, layer in enumerate(self.encoders):
            x = self._layer(layer, x)
            if idx in records:
                e_features[records[idx]] = x

        # Global co-modulation head (reference: networks_stylegan3.py:635-638, 682-686).
        pooled = adaptive_avg_pool2d(self.e_16x16(x), (4, 4))
        pooled = self.fc_in(pooled.reshape(pooled.shape[0], -1).float())
        img_global = self.dropout(pooled, train, generator)

        for idx, (layer, skip_key) in enumerate(zip(self.decoders,
                                                    layout.decoder_skips)):
            x_skip = e_features[skip_key] if skip_key is not None else None
            x = self._layer(layer, ws[:, idx + 1], x, img_global, x_skip)

        if layout.output_scale != 1:
            x = x * layout.output_scale
        assert x.shape[1:] == (self.img_channels_out, self.img_resolution,
                               self.img_resolution)
        return x.float()

    recompute = False

    def _layer(self, layer, *args):
        """``recompute``: keep only each layer's inputs for the backward and
        run the layer again there (the layers draw nothing, so the second
        run repeats the first), which bounds the plain FIRs' memory."""
        if self.recompute and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def dropout(self, x, train: bool, generator: Optional[torch.Generator],
                keep_mask: Optional[torch.Tensor] = None):
        """The co-modulation dropout at this network's rate (``layers.dropout``,
        flax's ``nn.Dropout``, ``afcm_tpu/nn/stylegan3.py:487``)."""
        return dropout(x, self.dropout_rate, train, generator, keep_mask)


class Stylegan3Generator(nn.Module):
    """mapping + synthesis (reference: networks_stylegan3.py:716-740)."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels_in: int, img_channels_out: int,
                 mapping_kwargs=None, synthesis_kwargs=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels_in=img_channels_in, img_channels_out=img_channels_out,
            generator=generator, **dict(synthesis_kwargs or {}))
        mapping_kwargs = dict(mapping_kwargs or {})
        mapping_kwargs.setdefault("num_layers", 2)
        self.mapping = MappingNetwork(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
            num_ws=self.synthesis.num_ws, generator=generator, **mapping_kwargs)

    def forward(self, z, c, cond_img, ref_img=None, truncation_psi: float = 1.0,
                truncation_cutoff=None, train: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        """``ref_img`` and ``noise_mode`` are taken for the CoModGAN
        generator's call signature and unused, as in the JAX package
        (``afcm_tpu/nn/stylegan3.py:530-533``)."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, cond_img, train=train, generator=generator)
