"""Optimizers and the generator EMA (``afcm_tpu/models/train_state.py``).

The JAX package carries params, Adam moments and the EMA copy in one
immutable ``GANTrainState``; here they are the ``nn.Module`` parameters,
two ``torch.optim.Adam`` instances and the EMA module, updated in place.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   beta1: float = 0.0, beta2: float = 0.99,
                   eps: float = 1e-8) -> torch.optim.Adam:
    """Adam as configured by the reference (comodgan_model.py:19-22), the
    semantics of ``optax.adam`` that ``tests/test_train_parity.py:248-280``
    pins against ``torch.optim.Adam``."""
    return torch.optim.Adam(params, lr=learning_rate,
                            betas=(float(beta1), float(beta2)), eps=eps)


def with_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group (the epoch schedule)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def ema_beta(batch_size: int, ema_kimgs: float, ramp: Optional[float],
             cur_nimg: float) -> float:
    """EMA decay (reference: train.py:67-73)."""
    ema_nimg = ema_kimgs * 1000.0
    if ramp is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ramp)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(module_ema: nn.Module, module: nn.Module, beta: float) -> None:
    """p_ema <- lerp(p, p_ema, beta) for every parameter; buffers are copied
    (reference: train.py:74-77; ``afcm_tpu/models/gan_model.py:298-304``)."""
    for p_ema, p in zip(module_ema.parameters(), module.parameters()):
        p_ema.copy_(p + (p_ema - p) * beta)
    for b_ema, b in zip(module_ema.buffers(), module.buffers()):
        b_ema.copy_(b)
