"""The run's weights, made on the device from the seed by the reference
networks' own initialization (a ``torch.Generator`` on the device), and
handed alike to the port and to the reference."""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.gan import build_discriminator, build_generator
from .phantoms import sub_seed


def make_weights(cfg: dict, seed: int, device, with_d: bool) -> Dict[str, dict]:
    """``{"G": state_dict[, "D": state_dict]}`` of the configuration's
    networks, parameters and buffers, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 3))
    out = {}
    with torch.device(device):
        out["G"] = build_generator(cfg["model"]["G"], generator=gen).state_dict()
        if with_d:
            out["D"] = build_discriminator(cfg["model"]["D"], generator=gen).state_dict()
    return out
