"""Checkpoints of the port's training state (``afcm_tpu/utils/checkpoint.py``).

Per tag, the reference's per-network files ``{tag}_net_G.pth``,
``{tag}_net_D.pth`` and, for the GAN families, ``{tag}_net_G_ema.pth``
(torch state_dicts under the reference's names, the pix2pix networks'
batch-norm statistics among their buffers; reference:
models/base_model.py:144-160), plus
``{tag}_optim.pth`` with both Adam states and the step count, which the
reference drops and the JAX package keeps, so a resume continues the
optimization exactly. ``afcm_tpu_torch.evaluate`` loads
``{tag}_net_G_ema.pth``. In data-parallel training every rank holds the
same state: rank 0 writes it while the others wait, and every rank loads
it to resume. Over a model axis (``model.model_group``) the ranks of the
first data row gather the sharded tensors, and rank 0 writes them whole,
in the one-process layout, so a file written over a mesh loads unchanged
into one process; ``load_state`` loads whole tensors and keeps each
rank's slices.
"""

from __future__ import annotations

import os

import torch

from .. import parallel

_NETS = {"G": "generator", "D": "discriminator", "G_ema": "generator_ema"}


def _save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(state):
    return {k: v.detach().cpu() for k, v in state.items()}


def _nets(model):
    """The networks ``model`` has: G and D, and G_ema but for pix2pix."""
    return {suffix: getattr(model, attr) for suffix, attr in _NETS.items()
            if getattr(model, attr, None) is not None}


def full_optimizer_state(opt, net, model_group):
    """``opt.state_dict()`` with the moments of ``net``'s sharded
    parameters whole (every rank of ``model_group`` takes part)."""
    state = opt.state_dict()
    if model_group is None:
        return state
    sharded = _sharded_indices(net)
    state["state"] = {i: {k: model_group.gather_dim0(v) if i in sharded and k != "step"
                          else v for k, v in entry.items()}
                      for i, entry in state["state"].items()}
    return state


def _sharded_indices(net):
    """The optimizer indices (``net.parameters()`` order) of the sharded
    parameters of ``net``, with their model group."""
    owners = {id(m.weight): m.tp for m in parallel.tensor.sharded_layers(net)}
    return {i: owners[id(p)] for i, p in enumerate(net.parameters()) if id(p) in owners}


def save_state(model, checkpoint_dir: str, tag: str, group=None) -> None:
    """Write the networks and the optimizer state of ``model``; with a
    ``parallel.DataGroup``, rank 0 writes and every rank waits until it has.
    Over a model axis the first data row gathers the sharded tensors."""
    lead = group is None or torch.distributed.get_rank() == 0
    model_group = getattr(model, "model_group", None)
    if model_group is not None and group.rank == 0:
        nets = {suffix: parallel.full_state_dict(net, model_group)
                for suffix, net in _nets(model).items()}
        optim = {"opt_G": full_optimizer_state(model.opt_G, model.generator, model_group),
                 "opt_D": full_optimizer_state(model.opt_D, model.discriminator, model_group)}
    elif lead:
        nets = {suffix: net.state_dict() for suffix, net in _nets(model).items()}
        optim = {"opt_G": model.opt_G.state_dict(), "opt_D": model.opt_D.state_dict()}
    if lead:
        os.makedirs(checkpoint_dir, exist_ok=True)
        for suffix, state in nets.items():
            _save(_cpu(state), os.path.join(checkpoint_dir, f"{tag}_net_{suffix}.pth"))
        _save(dict(optim, step=model.step), os.path.join(checkpoint_dir, f"{tag}_optim.pth"))
    if group is not None:
        group.barrier()


def load_state(model, checkpoint_dir: str, tag: str) -> None:
    """Load what ``save_state`` wrote into ``model``, strictly."""
    def load(name):
        return torch.load(os.path.join(checkpoint_dir, name), map_location="cpu",
                          weights_only=True)

    sharded = getattr(model, "model_group", None) is not None
    for suffix, net in _nets(model).items():
        state = load(f"{tag}_net_{suffix}.pth")
        if sharded:
            parallel.load_full_state_dict(net, state)
        else:
            net.load_state_dict(state, strict=True)
    optim = load(f"{tag}_optim.pth")
    for key, net in (("opt_G", model.generator), ("opt_D", model.discriminator)):
        state = optim[key]
        if sharded:
            groups = _sharded_indices(net)
            state["state"] = {i: {k: v[groups[i].channels(v.shape[0])]
                                  if i in groups and k != "step" else v
                                  for k, v in entry.items()}
                              for i, entry in state["state"].items()}
        getattr(model, key).load_state_dict(state)
    model.step = int(optim["step"])


def checkpoint_exists(checkpoint_dir: str, tag: str, model) -> bool:
    """Whether every file ``save_state`` writes for ``model`` is there."""
    names = [f"net_{suffix}" for suffix in _nets(model)] + ["optim"]
    return all(os.path.exists(os.path.join(checkpoint_dir, f"{tag}_{name}.pth"))
               for name in names)

