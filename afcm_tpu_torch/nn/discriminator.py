"""StyleGAN2 discriminator (``afcm_tpu/nn/discriminator.py``).

The block pyramid (``b256`` ... ``b8``), the minibatch-stddev epilogue
``b4`` (``mbstd``, ``conv``, ``fc``, ``out``) and the projection
conditioning through a label-only ``mapping`` network when ``c_dim > 0``.
``architecture`` is that of StyleGAN2: ``resnet`` (``fromrgb`` on the first
block, ``skip`` at gain √0.5, ``conv0``, ``conv1`` at stride 2), ``skip``
(a ``fromrgb`` on every block and in the epilogue, the image carried down
by ``downsample2d``) or ``orig`` (``fromrgb`` on the first block, no
residual). ``build_discriminator`` in both packages selects ``resnet``
alone; the others are reached by constructing the network. Module names are
the JAX package's, so ``afcm_tpu.utils.port.variables_to_state_dict`` loads
its weights strictly. The blocks run in ``compute_dtype``; the epilogue
runs in float32 (``:85``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import downsample2d, setup_filter
from .layers import Conv2dLayer, FullyConnected, MinibatchStdLayer
from .mapping import MappingNetwork

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiscriminatorBlock(nn.Module):
    """``afcm_tpu/nn/discriminator.py:21-68``: ``forward(x, img)`` returns
    the features at half the resolution and the image the next block reads
    (the ``skip`` architecture's, downsampled; None otherwise)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, architecture: str = "resnet",
                 activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"discriminator architecture {architecture!r}")
        self.in_channels = in_channels
        self.resolution = resolution
        self.architecture = architecture
        # the resample filter of Conv2dLayer's down=2 convs, for the image too
        self.resample_filter = setup_filter(list(resample_filter))
        common = dict(generator=generator)
        down = dict(down=2, resample_filter=resample_filter)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp,
                                       **common)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1,
                                    use_bias=False, **down, **common)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp,
                                 **common)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp,
                                 **down, **common)

    def forward(self, x, img):
        if x is not None:
            assert x.shape[1:] == (self.in_channels, self.resolution,
                                   self.resolution)
        if self.in_channels == 0 or self.architecture == "skip":
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) \
                if self.architecture == "skip" else None
        if self.architecture == "resnet":
            y = self.skip(x, gain=np.sqrt(0.5))
            return y + self.conv1(self.conv0(x), gain=np.sqrt(0.5)), img
        return self.conv1(self.conv0(x)), img


# The keys a D's ``block_kwargs`` may set: the JAX package's
# ``DiscriminatorBlock`` fields that the D does not set itself
# (``afcm_tpu/nn/discriminator.py:21-30``); any other key is a TypeError
# there, as here.
BLOCK_KWARGS = ("activation", "resample_filter")


def block_kwargs_of(block_kwargs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``block_kwargs`` as a dict, refusing a key that ``afcm_tpu``'s
    discriminators refuse."""
    block_kwargs = dict(block_kwargs or {})
    unknown = sorted(set(block_kwargs) - set(BLOCK_KWARGS))
    if unknown:
        raise TypeError(f"DiscriminatorBlock takes {list(BLOCK_KWARGS)} from "
                        f"block_kwargs, not {unknown}")
    return block_kwargs


class DiscriminatorEpilogue(nn.Module):
    """4x4 head (``afcm_tpu/nn/discriminator.py:71-106``), in float32."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int,
                 img_channels: int, architecture: str = "resnet",
                 mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1,
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.cmap_dim = cmap_dim
        self.resolution = resolution
        self.architecture = architecture
        self.mbstd_num_channels = mbstd_num_channels
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation="lrelu", generator=generator)
        if mbstd_num_channels > 0:
            self.mbstd = MinibatchStdLayer(group_size=mbstd_group_size,
                                           num_channels=mbstd_num_channels)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels,
                                kernel_size=3, activation="lrelu",
                                conv_clamp=conv_clamp, generator=generator)
        self.fc = FullyConnected(in_channels * resolution ** 2, in_channels,
                                 activation="lrelu", generator=generator)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim,
                                  generator=generator)

    def forward(self, x, img, cmap):
        assert x.shape[1:] == (self.in_channels, self.resolution, self.resolution)
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd_num_channels > 0:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = torch.sum(x * cmap, dim=1, keepdim=True) * (1 / np.sqrt(self.cmap_dim))
        return x


class CoModDiscriminator(nn.Module):
    """``afcm_tpu/nn/discriminator.py:109-170``: image [N, img_channels, R, R]
    and label c [N, c_dim] -> logits [N, 1]. ``block_kwargs`` reaches every
    block (``activation``, ``resample_filter``); the model builder passes
    none, as ``afcm_tpu/models/__init__.py:61-76`` does not."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet",
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = None,
                 cmap_dim: Optional[int] = None,
                 block_kwargs: Optional[Dict[str, Any]] = None,
                 mapping_kwargs: Optional[Dict[str, Any]] = None,
                 epilogue_kwargs: Optional[Dict[str, Any]] = None,
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        block_kwargs = block_kwargs_of(block_kwargs)
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.compute_dtype = _DTYPES[compute_dtype]
        cmap_dim = cmap_dim if cmap_dim is not None else self.channels(4)
        if c_dim == 0:
            cmap_dim = 0
        for res in self.block_resolutions:
            in_channels = self.channels(res) if res < img_resolution else 0
            self.add_module(f"b{res}", DiscriminatorBlock(
                in_channels, self.channels(res), self.channels(res // 2),
                resolution=res, img_channels=img_channels, architecture=architecture,
                conv_clamp=conv_clamp, generator=generator, **block_kwargs))
        if c_dim > 0:
            mapping_kwargs = {k: v for k, v in dict(mapping_kwargs or {}).items()
                              if k in ("num_layers", "lr_multiplier")}
            mapping_kwargs.setdefault("num_layers", 8)
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim,
                                          num_ws=None, w_avg_beta=None,
                                          generator=generator, **mapping_kwargs)
        epilogue_kwargs = {k: v for k, v in dict(epilogue_kwargs or {}).items()
                           if k in ("mbstd_group_size", "mbstd_num_channels")}
        self.b4 = DiscriminatorEpilogue(self.channels(4), cmap_dim=cmap_dim,
                                        resolution=4, img_channels=img_channels,
                                        architecture=architecture,
                                        conv_clamp=conv_clamp,
                                        generator=generator, **epilogue_kwargs)

    @property
    def block_resolutions(self) -> List[int]:
        log2res = int(np.log2(self.img_resolution))
        return [2 ** i for i in range(log2res, 2, -1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def forward(self, img, c=None):
        x = None
        img = img.to(self.compute_dtype)
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)
