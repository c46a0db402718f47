"""Temporal (StyleGAN-V) variants of the CoModGAN family
(``afcm_tpu/nn/motion.py``; reference: CoModGAN/motion.py,
generator.py:130-295, 577-609, 840-930, layers.py:669-739).

The reference ships them selectable through ``synthesis_kwargs.name`` and
``mapping_kwargs``, but no published config uses them, and in both packages
``CoModGenerator`` cannot build ``MotionSynthesisNetwork`` (it passes no
``motion_v_dim``); ``StyleGANVGenerator`` builds it. The trajectory length
is static (from ``max_num_frames``), as in the JAX package. The motion
mapping implements the 'conv' generation strategy; its non-Fourier branch
builds the ``MappingNetwork`` the reference fails to construct
(motion.py:46 passes no ``c_dim``), with ``c_dim`` 0 as the JAX package
does.

The synthesis and discriminator blocks are the CoModGAN family's
(``nn/comodgan.py``, ``nn/discriminator.py``). Module names are the JAX
package's, so its variables load with ``utils.port.load_jax_variables``;
the time encoders' Fourier coefficients and phase scales are buffers that
are not saved, as the JAX package recomputes them. Random draws (the
trajectory noise ``motion_z``, the synthesis noise and the co-modulation
dropout) come from the ``torch.Generator`` the caller hands over, unless
``motion_z`` is given.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .comodgan import EBlock, EFromRGB, SynthesisBlock, skip_connects
from .discriminator import DiscriminatorBlock, DiscriminatorEpilogue, block_kwargs_of
from .layers import Conv2dLayer, FullyConnected, dropout, normal_parameter
from .mapping import MappingNetwork

_DEFAULT_FILTER = (1, 3, 3, 1)


# -- time encoders (reference: layers.py:669-739) ---------------------------


def construct_log_spaced_freqs(max_num_frames: int,
                               skip_small_t_freqs: int = 0) -> np.ndarray:
    time_resolution = 2 ** np.ceil(np.log2(max_num_frames))
    num_fourier_feats = int(np.ceil(np.log2(time_resolution)))
    powers = 2 ** np.arange(num_fourier_feats)
    powers = powers[:len(powers) - skip_small_t_freqs]
    fourier_coefs = powers[None].astype(np.float32) * np.pi
    return fourier_coefs / time_resolution


class FixedTimeEncoder(nn.Module):
    """sin/cos of log-spaced frequencies times t: [N] -> [N, 2F]."""

    def __init__(self, max_num_frames: int, skip_small_t_freqs: int = 0):
        super().__init__()
        coefs = construct_log_spaced_freqs(max_num_frames, skip_small_t_freqs)
        self.register_buffer("fourier_coefs",
                             torch.from_numpy(np.asarray(coefs, np.float32)),
                             persistent=False)

    def get_dim(self) -> int:
        return self.fourier_coefs.shape[1] * 2

    def forward(self, t):
        raw = self.fourier_coefs * t.reshape(-1).float()[:, None]
        return torch.cat([torch.sin(raw), torch.cos(raw)], dim=1)


class _Embedding(nn.Module):
    """``torch.nn.Embedding``'s lookup with a N(0, 1) ``weight`` drawn from
    an explicit generator (``const_embed.weight``)."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, features), 1.0, generator)

    def forward(self, idx):
        return self.weight[idx]


class TemporalDifferenceEncoder(nn.Module):
    """A learned embedding of the rounded time difference beside its Fourier
    features: [N, 1] -> [N, d + 2F]."""

    def __init__(self, max_num_frames: int, num_frames_per_video: int = 1,
                 d: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d = d
        self.const_embed = _Embedding(max_num_frames, d, generator)
        self.time_encoder = FixedTimeEncoder(max_num_frames)

    def get_dim(self) -> int:
        return self.d + self.time_encoder.get_dim()

    def forward(self, delta_t):
        batch_size = delta_t.shape[0]
        t_diffs = delta_t.reshape(-1)
        const_embs = self.const_embed(torch.round(t_diffs.float()).long())
        fourier_embs = self.time_encoder(t_diffs[:, None])
        return torch.cat([const_embs, fourier_embs], dim=1).reshape(batch_size, -1)


# -- motion mapping (reference: motion.py) -----------------------------------


def construct_linspaced_frequencies(num_freqs: int, min_period_len: int,
                                    max_period_len: int) -> np.ndarray:
    freqs = 2 * np.pi / (2 ** np.linspace(np.log2(min_period_len),
                                          np.log2(max_period_len), num_freqs))
    return freqs[::-1].copy().astype(np.float32)[None]


class EqLRConv1d(nn.Module):
    """Equalized-LR 1-d conv over [N, C, L] (reference: layers.py:167-209)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 padding: int = 0, activation: str = "linear",
                 lr_multiplier: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding, self.activation = padding, activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / np.sqrt(in_features * kernel_size)
        self.weight = normal_parameter((out_features, in_features, kernel_size),
                                       1.0 / lr_multiplier, generator)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        y = F.conv1d(x, (self.weight * self.weight_gain).to(x.dtype),
                     padding=self.padding)
        y = y + (self.bias * self.lr_multiplier)[None, :, None].to(y.dtype)
        if self.activation == "lrelu":
            # strict > so d/dy at exactly 0 is the slope, as the JAX package
            y = torch.where(y > 0, y, 0.2 * y)
        return y


class AlignedTimeEncoder(nn.Module):
    """(reference: motion.py:176-238)"""

    def __init__(self, dim: int, min_period_len: int, max_period_len: int,
                 latent_dim: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        freqs = construct_linspaced_frequencies(dim, min_period_len, max_period_len)
        phase_scales = max_period_len / (2 * np.pi / freqs)
        self.register_buffer("freqs", torch.from_numpy(freqs), persistent=False)
        self.register_buffer("phase_scales",
                             torch.from_numpy(np.asarray(phase_scales, np.float32)),
                             persistent=False)
        fc = dict(use_bias=False, generator=generator)
        self.periods_predictor = FullyConnected(latent_dim, dim, **fc)
        self.phase_predictor = FullyConnected(latent_dim, dim, **fc)
        self.aligners_predictor = FullyConnected(latent_dim, dim * 2, **fc)

    def get_dim(self) -> int:
        return self.dim * 2

    def forward(self, t, motion_u_left, motion_u_right, interp_weights, t_left,
                t_right):
        bsz, nf, u_dim = motion_u_left.shape
        ul = motion_u_left.reshape(bsz * nf, u_dim)
        ur = motion_u_right.reshape(bsz * nf, u_dim)
        periods = torch.tanh(self.periods_predictor(ul)) + 1
        phases = self.phase_predictor(ul)
        aligners_left = self.aligners_predictor(ul)
        aligners_right = self.aligners_predictor(ur)

        def pos_emb(time):
            raw = self.freqs * periods * time.reshape(-1)[:, None] + \
                phases * self.phase_scales
            return torch.cat([torch.sin(raw), torch.cos(raw)], dim=1)

        pos_embs = pos_emb(t.float())
        pos_l = pos_emb(t_left.float())
        pos_r = pos_emb(t_right.float())
        w = interp_weights.reshape(-1, 1)
        aligners_remove = pos_l * (1 - w) + pos_r * w
        aligners_add = aligners_left * (1 - w) + aligners_right * w
        return pos_embs - aligners_remove + aligners_add


class MotionMappingNetwork(nn.Module):
    """Trajectory noise -> motion codes (reference: motion.py:19-170), the
    'conv' generation strategy: two lrelu ``EqLRConv1d`` at lr_multiplier
    0.01 (``conv.0``, ``conv.1``) over the trajectory, then the codes at
    each frame's two neighbouring knots, interpolated, through the aligned
    time encoder (``fourier``) or a 2-layer ``MappingNetwork``."""

    def __init__(self, max_num_frames: int, motion_v_dim: int, motion_z_dim: int,
                 motion_z_distance: int, motion_kernel_size: int,
                 fourier: bool = True, time_encoder_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_num_frames = max_num_frames
        self.motion_z_dim = motion_z_dim
        self.motion_z_distance = motion_z_distance
        self.motion_kernel_size = motion_kernel_size
        self.fourier = fourier
        conv = dict(activation="lrelu", lr_multiplier=0.01, generator=generator)
        self.conv = nn.Sequential(
            EqLRConv1d(motion_z_dim, motion_z_dim, motion_kernel_size, **conv),
            EqLRConv1d(motion_z_dim, motion_v_dim, motion_kernel_size, **conv))
        if fourier:
            self.time_encoder = AlignedTimeEncoder(
                latent_dim=motion_v_dim, generator=generator,
                **dict(time_encoder_kwargs or {}))
        else:
            self.mapping = MappingNetwork(z_dim=motion_z_dim, c_dim=0, w_dim=motion_v_dim,
                                          num_ws=None, num_layers=2, w_avg_beta=None,
                                          generator=generator)

    @property
    def num_additional_codes(self) -> int:
        return (self.motion_kernel_size - 1) * 2

    def max_traj_len(self) -> int:
        max_t = self.max_num_frames - 1
        return int(np.ceil(max_t / self.motion_z_distance)) + 2 + \
            self.num_additional_codes

    def forward(self, t, motion_z=None, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``t`` [N, F] frame times; ``motion_z`` [N, max_traj_len(),
        motion_z_dim] is drawn from ``generator`` unless given."""
        assert t.dim() == 2
        batch_size, num_frames = t.shape
        if motion_z is None:
            motion_z = torch.randn((batch_size, self.max_traj_len(), self.motion_z_dim),
                                   generator=generator, device=t.device)
        trajs = self.conv(motion_z.transpose(1, 2)).transpose(1, 2)

        dist = self.motion_z_distance
        left_idx = torch.floor(t / dist).long()
        batch_idx = torch.arange(batch_size, device=t.device)[:, None]
        u_left = trajs[batch_idx, left_idx]
        u_right = trajs[batch_idx, left_idx + 1]
        t_left = t - t % dist
        t_right = t_left + dist
        w = ((t % dist) / dist)[..., None].float()
        motion_u = (u_left * (1 - w) + u_right * w).reshape(batch_size * num_frames, -1)
        if self.fourier:
            motion_v = self.time_encoder(t, u_left, u_right, w, t_left, t_right)
        else:
            motion_v = self.mapping(motion_u)
        return {"motion_v": motion_v, "motion_z": motion_z}


# -- motion synthesis network (reference: generator.py:130-295) -------------


class MotionSynthesisNetwork(nn.Module):
    """The CoModGAN synthesis network with the motion code and the time
    difference tiled into its 4x4 seed (``coord_emb``) and, optionally,
    into the co-modulation vector (``comod_emb``)."""

    def __init__(self, w_dim: int, motion_v_dim: int, img_resolution: int,
                 img_channels_in: int, img_channels_out: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 dropout_rate: float = 0.5, skip_resolution: int = 256,
                 global_enc: bool = False, relative_enc: bool = False,
                 coord_emb: bool = True, comod_emb: bool = False,
                 max_num_frames: int = 128,
                 resample_filter: Sequence[int] = _DEFAULT_FILTER,
                 architecture: str = "skip", conv_clamp: Optional[float] = None,
                 cond_mod: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_dim, self.motion_v_dim = w_dim, motion_v_dim
        self.img_resolution = img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.dropout_rate = dropout_rate
        self.global_enc, self.relative_enc = global_enc, relative_enc
        self.coord_emb, self.comod_emb = coord_emb, comod_emb
        self.max_num_frames = max_num_frames
        log2res = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2res + 1)]
        self.skip_connects = skip_connects(log2res, skip_resolution)
        self.num_ws = 1 + sum(2 + (res == img_resolution)
                              for res in self.block_resolutions[1:])
        ch4 = self.channels(4)

        self.e_fromrgb = EFromRGB(img_channels_in, self.channels(img_resolution),
                                  generator)
        self.encoder_levels = list(range(log2res, 2, -1))
        for res in self.encoder_levels:
            self.add_module(f"e_b{res}", EBlock(
                self.channels(2 ** res), self.channels(2 ** res // 2),
                resample_filter=resample_filter, generator=generator))
        self.e_4x4 = Conv2dLayer(ch4, ch4, kernel_size=3, activation="lrelu",
                                 generator=generator)
        self.fc_in = FullyConnected(ch4 * 16, ch4 * 2, activation="lrelu",
                                    generator=generator)
        self.fc_out = FullyConnected(ch4 * 2, ch4 * 16, activation="lrelu",
                                     generator=generator)
        if relative_enc:
            self.time_encoder = TemporalDifferenceEncoder(max_num_frames,
                                                          generator=generator)
        block_kwargs = dict(w_dim=w_dim, global_w_dim=self.global_w_dim,
                            img_channels=img_channels_out, architecture=architecture,
                            resample_filter=resample_filter, conv_clamp=conv_clamp,
                            cond_mod=cond_mod, generator=generator)
        # early_channels is passed as the reference does (generator.py:204):
        # without coord_emb it equals ch4, conv1's in-width either way
        self.block_early = SynthesisBlock(0, ch4, resolution=4, is_last=False,
                                          early_channels=self.early_channels,
                                          **block_kwargs)
        for res in self.block_resolutions[1:]:
            self.add_module(f"b{res}", SynthesisBlock(
                self.channels(res // 2), self.channels(res), resolution=res,
                is_last=(res == img_resolution), **block_kwargs))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def early_channels(self) -> int:
        early = self.channels(4)
        if self.coord_emb:
            if self.global_enc:
                early += self.motion_v_dim
            if self.relative_enc:
                early += 256 + construct_log_spaced_freqs(
                    self.max_num_frames).shape[1] * 2
            else:
                early += 1
        return early

    @property
    def global_w_dim(self) -> int:
        # the reference's (generator.py:196-199), coord_emb=False with
        # comod_emb=True included
        if self.comod_emb:
            gw = self.channels(4) + self.early_channels
            if not self.coord_emb:
                gw += self.motion_v_dim
            return gw
        return self.channels(4) * 2

    def forward(self, ws, img_in, motion: Dict[str, torch.Tensor], delta_t,
                train: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        ws = ws.float()
        e_features: Dict[int, torch.Tensor] = {}
        img = self.e_fromrgb(None, img_in)
        for res in self.encoder_levels:
            img, e_features[2 ** res] = getattr(self, f"e_b{res}")(img)
        img = self.e_4x4(img)
        e_features[4] = img
        pooled = self.fc_in(img.reshape(img.shape[0], -1))
        img_global = dropout(pooled, self.dropout_rate, train, generator)
        seed = self.fc_out(img_global).reshape(-1, self.channels(4), 4, 4)
        if self.skip_connects[0]:
            seed = seed + e_features[4]

        position_emb = []
        t_embs = None
        if self.global_enc:
            position_emb.append(motion["motion_v"])
        if self.relative_enc:
            t_embs = self.time_encoder(delta_t)
            position_emb.append(t_embs)
        else:
            position_emb.append(delta_t)
        position_emb = torch.cat(position_emb, dim=-1)

        if self.coord_emb:
            def tile(v):
                return v[:, :, None, None].repeat(1, 1, seed.shape[2], seed.shape[3])
            if self.global_enc:
                seed = torch.cat([seed, tile(motion["motion_v"])], dim=1)
            seed = torch.cat([seed, tile(t_embs if self.relative_enc else delta_t)], dim=1)
        if self.comod_emb:
            img_global = torch.cat([img_global, position_emb], dim=-1)

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


class StyleGANVGenerator(nn.Module):
    """mapping + motion mapping + motion synthesis (reference: generator.py:577-609)."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, motion_v_dim: int,
                 img_resolution: int, img_channels_in: int, img_channels_out: int,
                 max_num_frames: int = 8, mapping_kwargs: Optional[Dict] = None,
                 synthesis_kwargs: Optional[Dict] = None,
                 motion_mapping_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        synthesis_kwargs = dict(synthesis_kwargs or {})
        synthesis_kwargs.pop("name", None)
        self.synthesis = MotionSynthesisNetwork(
            w_dim=w_dim, motion_v_dim=motion_v_dim, img_resolution=img_resolution,
            img_channels_in=img_channels_in, img_channels_out=img_channels_out,
            max_num_frames=max_num_frames, generator=generator, **synthesis_kwargs)
        mapping_kwargs = {k: v for k, v in dict(mapping_kwargs or {}).items()
                          if k in ("num_layers", "lr_multiplier", "w_avg_beta")}
        mapping_kwargs.setdefault("num_layers", 8)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws, generator=generator,
                                      **mapping_kwargs)
        motion_mapping_kwargs = dict(motion_mapping_kwargs or {})
        motion_mapping_kwargs.setdefault("motion_v_dim", motion_v_dim)
        self.motion_mapping = MotionMappingNetwork(
            max_num_frames=max_num_frames, generator=generator, **motion_mapping_kwargs)

    def forward(self, z, c, t, delta_t, cond_img, motion_z=None, ref_img=None,
                train: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        """A train-mode forward updates the mapper's ``w_avg``, as the JAX
        generator does (``update_w_avg=train``)."""
        del ref_img  # accepted as the JAX generator accepts it
        ws = self.mapping(z, c, update_w_avg=train)
        motion = self.motion_mapping(t, motion_z=motion_z, generator=generator)
        return self.synthesis(ws, cond_img, motion, delta_t, train=train,
                              noise_mode=noise_mode, generator=generator)


class StyleGANVDiscriminator(nn.Module):
    """Time-conditioned D: frames in the batch up to ``concat_res``, where
    they are concatenated along the channels, and the time difference's
    embedding beside the label in the projection conditioning (reference:
    generator.py:840-930). ``architecture`` ``resnet`` or ``orig`` reaches
    the blocks and the epilogue, ``block_kwargs`` the blocks, as in
    ``afcm_tpu/nn/motion.py:475-531``. ``skip`` is refused: ``afcm_tpu``'s D
    fails there too, adding the un-concatenated image's ``fromrgb`` to the
    frame-concatenated features at ``concat_res`` (ROADMAP C15)."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 num_frames: int = 3, architecture: str = "resnet",
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = None, cmap_dim: Optional[int] = None,
                 num_frames_div_factor: int = 4, max_num_frames: int = 128,
                 concat_res: int = 16, block_kwargs: Optional[Dict[str, Any]] = None,
                 mapping_kwargs: Optional[Dict[str, Any]] = None,
                 epilogue_kwargs: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if architecture == "skip":
            raise NotImplementedError(
                "StyleGAN-V discriminator architecture 'skip': the JAX package's fails at "
                "concat_res too (ROADMAP C15)")
        block_kwargs = block_kwargs_of(block_kwargs)
        self.c_dim, self.img_channels = c_dim, img_channels
        self.num_frames, self.concat_res = num_frames, concat_res
        self.channel_base, self.channel_max = channel_base, channel_max
        log2res = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2res, 2, -1)]
        cmap_dim = cmap_dim if cmap_dim is not None else self.channels(4)

        self.time_encoder = TemporalDifferenceEncoder(max_num_frames, generator=generator)
        for res in self.block_resolutions:
            in_channels = self.channels(res) if res < img_resolution else 0
            tmp_channels = self.channels(res)
            out_channels = self.channels(res // 2)
            if res // 2 == concat_res:
                out_channels //= num_frames_div_factor
            if res == concat_res:
                in_channels = tmp_channels = \
                    (in_channels // num_frames_div_factor) * num_frames
            self.add_module(f"b{res}", DiscriminatorBlock(
                in_channels, tmp_channels, out_channels, resolution=res,
                img_channels=img_channels, architecture=architecture,
                conv_clamp=conv_clamp, generator=generator, **block_kwargs))
        mapping_kwargs = dict(mapping_kwargs or {})
        mapping_kwargs.setdefault("num_layers", 8)
        self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim + self.time_encoder.get_dim(),
                                      w_dim=cmap_dim, num_ws=None, w_avg_beta=None,
                                      generator=generator, **mapping_kwargs)
        epilogue_kwargs = {k: v for k, v in dict(epilogue_kwargs or {}).items()
                           if k in ("mbstd_group_size", "mbstd_num_channels")}
        self.b4 = DiscriminatorEpilogue(self.channels(4), cmap_dim=cmap_dim, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        conv_clamp=conv_clamp, generator=generator,
                                        **epilogue_kwargs)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def forward(self, img, c, delta_t):
        """``img`` [N, num_frames·img_channels, R, R], ``c`` [N, c_dim] (or
        None when ``c_dim`` is 0), ``delta_t`` [N, 1] -> logits [N, 1]."""
        t_embs = self.time_encoder(delta_t)
        c = torch.cat([c, t_embs], dim=1) if c is not None else t_embs
        img = img.reshape(-1, self.img_channels, *img.shape[-2:])
        x = None
        for res in self.block_resolutions:
            if res == self.concat_res:
                x = x.reshape(-1, self.num_frames, *x.shape[1:])
                x = x.reshape(x.shape[0], -1, *x.shape[3:])
            x, img = getattr(self, f"b{res}")(x, img)
        return self.b4(x, img, self.mapping(None, c))
