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
it to resume.
"""

from __future__ import annotations

import os

import torch

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


def save_state(model, checkpoint_dir: str, tag: str, group=None) -> None:
    """Write the networks and the optimizer state of ``model``; with a
    ``parallel.DataGroup``, rank 0 writes and every rank waits until it has."""
    if group is None or group.rank == 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        for suffix, net in _nets(model).items():
            _save(_cpu(net.state_dict()),
                  os.path.join(checkpoint_dir, f"{tag}_net_{suffix}.pth"))
        _save({"opt_G": model.opt_G.state_dict(), "opt_D": model.opt_D.state_dict(),
               "step": model.step}, os.path.join(checkpoint_dir, f"{tag}_optim.pth"))
    if group is not None:
        group.barrier()


def load_state(model, checkpoint_dir: str, tag: str) -> None:
    """Load what ``save_state`` wrote into ``model``, strictly."""
    def load(name):
        return torch.load(os.path.join(checkpoint_dir, name), map_location="cpu",
                          weights_only=True)

    for suffix, net in _nets(model).items():
        net.load_state_dict(load(f"{tag}_net_{suffix}.pth"), strict=True)
    optim = load(f"{tag}_optim.pth")
    model.opt_G.load_state_dict(optim["opt_G"])
    model.opt_D.load_state_dict(optim["opt_D"])
    model.step = int(optim["step"])


def checkpoint_exists(checkpoint_dir: str, tag: str, model) -> bool:
    """Whether every file ``save_state`` writes for ``model`` is there."""
    names = [f"net_{suffix}" for suffix in _nets(model)] + ["optim"]
    return all(os.path.exists(os.path.join(checkpoint_dir, f"{tag}_{name}.pth"))
               for name in names)

