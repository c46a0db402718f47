# Frozen copy of afcm_tpu_torch/nn/mapping.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Latent mapping network (``afcm_tpu/nn/mapping.py``): z-normalize, label
embed + normalize + concat, lrelu MLP at lr_multiplier 0.01, broadcast to
``num_ws`` and truncation toward the ``w_avg`` buffer.

The discriminator's label-only mapper is the same class with ``z_dim`` 0,
``num_ws`` None and ``w_avg_beta`` None (no ``w_avg`` buffer). The
``w_avg`` EMA update (``update_w_avg``, ``afcm_tpu/nn/mapping.py:60-63``)
runs where the CoModGAN generator asks for it, in every train-mode forward
(``afcm_tpu/nn/comodgan.py:440-442``). The StyleGAN3 train step never asks:
the JAX step calls that generator without ``update_emas``
(``afcm_tpu/models/gan_model.py:153-156``), so its ``w_avg`` stays put.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import FullyConnected, normalize_2nd_moment


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int, c_dim: int, w_dim: int,
                 num_ws: Optional[int], num_layers: int = 2,
                 lr_multiplier: float = 0.01,
                 w_avg_beta: Optional[float] = 0.998,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, w_dim, generator=generator)
        in_features = z_dim + (w_dim if c_dim > 0 else 0)
        for idx in range(num_layers):
            self.add_module(f"fc{idx}", FullyConnected(
                in_features if idx == 0 else w_dim, w_dim, activation="lrelu",
                lr_multiplier=lr_multiplier, generator=generator))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z, c=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False):
        x = None
        if self.z_dim > 0:
            assert z.shape[-1] == self.z_dim
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y

        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        if update_w_avg and self.w_avg_beta is not None and self.num_ws is not None:
            # in place: the buffer is state, not part of the graph
            with torch.no_grad():
                mean_w = x.detach().mean(dim=0)
                self.w_avg.copy_(mean_w + (self.w_avg - mean_w) * self.w_avg_beta)

        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)

        if truncation_psi != 1:
            assert self.w_avg_beta is not None
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg + (x - self.w_avg) * truncation_psi
            else:
                x = x.clone()
                x[:, :truncation_cutoff] = self.w_avg + (
                    x[:, :truncation_cutoff] - self.w_avg) * truncation_psi
        return x
