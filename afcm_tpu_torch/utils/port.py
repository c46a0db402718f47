"""Load ``afcm_tpu`` variable trees and train states into the port.

Module and buffer names mirror the JAX package's, which mirror the
reference state_dict, so ``afcm_tpu.utils.port.variables_to_state_dict``
(framework-free, imported not copied) is the whole translation of weights;
``load_jax_train_state`` also carries optax's Adam state into
``torch.optim.Adam``, so that both packages can step from one state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from afcm_tpu.utils.port import variables_to_state_dict


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a ``{"params", "moments", "constants"}`` tree of numpy arrays
    into ``module`` with ``strict=True``; returns the module."""
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in variables_to_state_dict(variables).items()}
    module.load_state_dict(state, strict=True)
    return module


def _field(node, name):
    """A field of an optax state: a namedtuple as built, or the dict flax's
    msgpack_restore gives (tuples become {"0": ..., "1": ...})."""
    if isinstance(node, Mapping):
        return node[name]
    return node[int(name)] if name.isdigit() else getattr(node, name)


def _load_adam(optimizer: torch.optim.Adam, module: nn.Module, opt_state):
    """optax ``inject_hyperparams(adam)`` state -> ``torch.optim.Adam``:
    the learning rate, and per parameter the step count and both moments."""
    adam = _field(_field(opt_state, "inner_state"), "0")
    count = int(np.asarray(_field(adam, "count")))
    lr = float(np.asarray(_field(opt_state, "hyperparams")["learning_rate"]))
    mu = variables_to_state_dict({"params": _field(adam, "mu")})
    nu = variables_to_state_dict({"params": _field(adam, "nu")})
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.state.clear()
    if count == 0:
        return
    params = dict(module.named_parameters())
    assert mu.keys() == params.keys(), sorted(set(mu) ^ set(params))
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(np.array(mu[name], np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], np.float32)).to(p.device)}


def load_jax_train_state(model, state):
    """Load an ``afcm_tpu`` ``GANTrainState`` of numpy arrays (or the dict
    that flax's ``msgpack_restore`` makes of one) into a training
    ``GANModel``: G, G_ema and D with their moments, both Adam states
    (optax's ``count``, ``mu``, ``nu`` and learning rate) and the step.
    Returns the model."""
    def get(name):
        return state[name] if isinstance(state, Mapping) else getattr(state, name)

    constants = get("constants_G") or {}
    load_jax_variables(model.generator, {"params": get("params_G"),
                                         "moments": get("moments_G"),
                                         "constants": constants})
    load_jax_variables(model.generator_ema, {"params": get("params_G_ema"),
                                             "moments": get("moments_G_ema"),
                                             "constants": constants})
    load_jax_variables(model.discriminator, {"params": get("params_D")})
    _load_adam(model.opt_G, model.generator, get("opt_state_G"))
    _load_adam(model.opt_D, model.discriminator, get("opt_state_D"))
    model.step = int(np.asarray(get("step")))
    return model
