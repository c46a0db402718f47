# Frozen copy of afcm_tpu_torch/ops/bias_act.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Bias + activation + gain + clamp (``afcm_tpu/ops/bias_act.py``).

Plain elementwise torch; the JAX package leaves this chain to XLA's fusion
and the port leaves it to PyTorch's elementwise kernels. The activations
are the JAX package's nine (the reference's bias_act table): the networks
use ``linear`` and ``lrelu``, a discriminator's ``block_kwargs`` may name
any.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    fn: callable
    def_alpha: float = 0.0
    def_gain: float = 1.0


activation_funcs = {
    "linear": ActivationSpec(lambda x, alpha: x),
    # Strict x > 0, as afcm_tpu/ops/bias_act.py:36: F.leaky_relu keeps x at
    # exactly 0 the same way in the forward, but the JAX rule is the
    # contract, so it is written out.
    "lrelu": ActivationSpec(lambda x, alpha: torch.where(x > 0, x, x * alpha),
                            def_alpha=0.2, def_gain=float(np.sqrt(2.0))),
    "relu": ActivationSpec(lambda x, alpha: torch.relu(x), def_gain=float(np.sqrt(2.0))),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x)),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x)),
    "elu": ActivationSpec(lambda x, alpha: torch.nn.functional.elu(x)),
    "selu": ActivationSpec(lambda x, alpha: torch.nn.functional.selu(x)),
    "softplus": ActivationSpec(lambda x, alpha: torch.nn.functional.softplus(x)),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x,
                            def_gain=float(np.sqrt(2.0))),
}


def bias_act(x, b=None, dim: int = 1, act: str = "linear", alpha=None,
             gain=None, clamp=None):
    """Add per-channel bias ``b`` along ``dim``, apply ``act``, scale by
    ``gain`` (None = the activation's default) and clamp to ±``clamp``."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[dim]
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = spec.fn(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = torch.clamp(x, -clamp, clamp)
    return x
