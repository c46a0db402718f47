"""Load reference checkpoints, ``afcm_tpu`` variable trees and train
states into the port.

Module and buffer names mirror the JAX package's, which mirror the
reference state_dict, so ``variables_to_state_dict`` (the port's own copy
of the JAX package's, numpy only) is the whole translation of weights.
``jax_state_dict`` applies it to each collection of a variable tree, the
pix2pix networks' ``batch_stats`` included, which the JAX package's
function does not walk; ``load_jax_train_state`` also carries optax's Adam
state into ``torch.optim.Adam``, so that both packages can step from one
state (a ``GANTrainState`` or a ``Pix2PixState``).

A reference AFCM checkpoint (``{epoch}_net_{G,D,G_ema}.pth``) becomes the
port's by ``reference_state_dict``, the routing of
``afcm_tpu/utils/port.py:state_dict_to_variables``:

    python -m afcm_tpu_torch.utils.port 50_net_G_ema.pth 50_net_G_ema.pth

writes the port's ``{tag}_net_G_ema.pth``, which ``evaluate`` and ``serve``
load strictly (``evaluate.load_generator_ema``).
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# CALayer Dense kernels of the JAX package -> the torch 1x1 convs they
# mirror, keyed on the flax path tail under the (always
# "ca"-named) CALayer module so the plain ConvNorm also named "down" in RCAB
# (leaves weight/bias, not kernel/bias under "ca") cannot collide.
_CA_UNRENAMES = {
    ("ca", "down", "kernel"): ("ca", "conv_du", "0", "weight"),
    ("ca", "down", "bias"): ("ca", "conv_du", "0", "bias"),
    ("ca", "up", "kernel"): ("ca", "conv_du", "2", "weight"),
    ("ca", "up", "bias"): ("ca", "conv_du", "2", "bias"),
}


# The reference's construction-time buffers, which the port computes when
# it builds a module and does not keep: the alias-free layers' FIR taps,
# the resample filters and the StyleGAN-V time encoders' tables
# (``afcm_tpu/utils/port.py:23-26``, ``_DROP_LEAVES``).
DROP_LEAVES = frozenset({"up_filter", "down_filter", "resample_filter",
                         "fourier_coefs", "phase_scales"})


def reference_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference state_dict as the port's: the keys whose last part is in
    ``DROP_LEAVES`` dropped, every other tensor kept under its own name
    (trainable tensors, ``w_avg``, ``magnitude_ema``, ``noise_const``,
    ``SynthesisInput``'s ``freqs``, ``phases`` and ``transform``, the CALayer
    ``conv_du.{0,2}`` convs, whose layout the port mirrors), on the CPU. A
    port checkpoint passes through unchanged. The load that follows stays
    strict: a key the port does not know still fails there, by name."""
    return {key: torch.as_tensor(value).detach().cpu()
            for key, value in state_dict.items()
            if key.rsplit(".", 1)[-1] not in DROP_LEAVES}


def variables_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flatten ``afcm_tpu`` variables (``params``, ``moments``, ``constants``)
    into a reference-style state_dict: dotted module paths, CALayer Dense
    kernels transposed back to [out,in,1,1] conv_du weights. The port's own
    copy of ``afcm_tpu/utils/port.py:variables_to_state_dict``."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            parts = prefix + [k]
            if isinstance(v, Mapping):
                walk(v, parts)
                continue
            v = np.asarray(v)
            tail = tuple(parts[-3:])
            if tail in _CA_UNRENAMES:
                if parts[-1] == "kernel":
                    v = v.T[:, :, None, None]  # [in,out] -> [out,in,1,1]
                parts = parts[:-3] + list(_CA_UNRENAMES[tail])
            out[".".join(parts)] = v

    walk(variables.get("params", {}), [])
    walk(variables.get("moments", {}), [])
    walk(variables.get("constants", {}), [])
    return out


# Every collection of the JAX package's variable trees: trainable
# parameters, the mapper's and layers' EMAs, the fixed noise and Fourier
# features, and the pix2pix batch norms' running statistics.
COLLECTIONS = ("params", "moments", "constants", "batch_stats")


def jax_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A torch state_dict (float32 tensors) of every collection of an
    ``afcm_tpu`` variable tree, each flattened by ``variables_to_state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for name in COLLECTIONS:
        flat = variables_to_state_dict({"params": variables.get(name) or {}})
        state.update({k: torch.from_numpy(np.array(v, np.float32))
                      for k, v in flat.items()})
    return state


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a variable tree of numpy arrays (any of ``COLLECTIONS``) into
    ``module`` with ``strict=True``; returns the module."""
    module.load_state_dict(jax_state_dict(variables), strict=True)
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


def _get(state, name, *default):
    if isinstance(state, Mapping):
        return state.get(name, *default) if default else state[name]
    return getattr(state, name, *default)


def is_pix2pix_state(state) -> bool:
    """Whether ``state`` is a pix2pix ``Pix2PixState`` (or its msgpack dict)."""
    return ("stats_G" in state) if isinstance(state, Mapping) else hasattr(state, "stats_G")


def train_state_networks(state) -> Dict[str, Mapping]:
    """The variable trees of the trained G and D of an ``afcm_tpu`` train
    state: with their batch-norm statistics in a ``Pix2PixState``, G with
    its moments and constants in a ``GANTrainState``."""
    if is_pix2pix_state(state):
        return {net: {"params": _get(state, f"params_{net}"),
                      "batch_stats": _get(state, f"stats_{net}")} for net in ("G", "D")}
    return {"G": {"params": _get(state, "params_G"), "moments": _get(state, "moments_G"),
                  "constants": _get(state, "constants_G", None) or {}},
            "D": {"params": _get(state, "params_D")}}


def load_jax_train_state(model, state):
    """Load an ``afcm_tpu`` train state of numpy arrays (or the dict that
    flax's ``msgpack_restore`` makes of one) into a training model: a
    ``GANTrainState`` into a ``GANModel`` (G, G_ema and D, G's with their
    moments), a ``Pix2PixState`` into a ``Pix2PixModel`` (G and D with
    their batch-norm statistics); both Adam states (optax's ``count``,
    ``mu``, ``nu`` and learning rate) and the step. Returns the model."""
    nets = train_state_networks(state)
    load_jax_variables(model.generator, nets["G"])
    load_jax_variables(model.discriminator, nets["D"])
    if not is_pix2pix_state(state):
        load_jax_variables(model.generator_ema, dict(
            nets["G"], params=_get(state, "params_G_ema"),
            moments=_get(state, "moments_G_ema")))
    _load_adam(model.opt_G, model.generator, _get(state, "opt_state_G"))
    _load_adam(model.opt_D, model.discriminator, _get(state, "opt_state_D"))
    model.step = int(np.asarray(_get(state, "step")))
    return model


def main(argv=None):
    """Convert a reference AFCM ``.pth`` state_dict into the port's
    ``{tag}_net_G_ema.pth`` format (the counterpart of ``python -m
    afcm_tpu.utils.port``). Host code: it reads with ``map_location="cpu"``
    (files trained on a card hold CUDA tensors) and moves no tensor to a
    device.

        python -m afcm_tpu_torch.utils.port SRC.pth DST.pth
    """
    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("src", help="reference torch .pth state_dict")
    parser.add_argument("dst", help="the port's .pth state_dict")
    args = parser.parse_args(argv)
    try:
        state_dict = torch.load(args.src, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise SystemExit(f"{args.src} holds a pickled object, not a state_dict of "
                         f"tensors; save the network's state_dict() instead ({exc})")
    if not isinstance(state_dict, Mapping):
        raise SystemExit(f"{args.src} holds a {type(state_dict).__name__}, not a "
                         "state_dict (a dict of tensors)")
    converted = reference_state_dict(state_dict)
    torch.save(converted, args.dst)
    print(f"wrote {args.dst} ({len(converted)} tensors; "
          f"{len(state_dict) - len(converted)} construction-time buffers dropped)")


if __name__ == "__main__":
    sys.exit(main())
