"""Template model: the minimal plugin contract
(``afcm_tpu/models/template_model.py``; reference: models/template_model.py,
an L1 regression example).

To add a model family:
  1. Build ``nn.Module``s in afcm_tpu_torch/nn/, drawing their random
     weights from an explicit ``torch.Generator``.
  2. Implement a model class with ``train_step(batch, ...)`` returning the
     losses as tensors, ``eval_step(a, ...)`` and ``with_lr``.
  3. Dispatch to its builder in ``afcm_tpu_torch/models/__init__.py:build_model``
     and (optionally) add a defaults subtree in
     afcm_tpu_torch/config/defaults.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .train_state import make_optimizer, with_lr


def _lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator]):
    """flax's default kernel init: a normal truncated at ±2 std, scaled to
    variance 1 / fan_in."""
    std = float(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class _Conv3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding="SAME")``: the kernel in
    flax's [3, 3, in, out] layout (so its variables load as they are) and a
    bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((3, 3, in_channels, out_channels),
                                                 9 * in_channels, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, padding=1)


class _TemplateNet(nn.Module):
    def __init__(self, channels: int, features: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = _Conv3x3(channels, features, generator)
        self.Conv_1 = _Conv3x3(features, channels, generator)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.Conv_0(x)))


@dataclasses.dataclass(frozen=True)
class TemplateConfig:
    lr: float = 1e-3


class TemplateModel:
    """Direct L1 regression from A to B. The JAX package sizes the net from
    the first batch; here ``channels`` is A's channel count."""

    def __init__(self, channels: int, config: TemplateConfig = TemplateConfig(),
                 generator: Optional[torch.Generator] = None):
        self.net = _TemplateNet(channels, generator=generator)
        self.config = config
        self.step = 0
        self.opt = make_optimizer(self.net.parameters(), config.lr, 0.9, 0.999)

    def to(self, device) -> "TemplateModel":
        self.net.to(device)
        return self

    def with_lr(self, lr: float) -> None:
        with_lr(self.opt, lr)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss = torch.mean(torch.abs(self.net(batch["A"]) - batch["B"]))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step += 1
        return {"loss_G": loss.detach()}

    def eval_step(self, a, slice_idx=None, generator=None, ref_img=None):
        del slice_idx, generator, ref_img  # the shared validate() call's arguments
        with torch.inference_mode():
            return self.net(a)
