"""Convert an afcm_tpu checkpoint into the PyTorch port's weights.

    python scripts/jax_ckpt_to_torch.py <checkpoint_dir> [tag]

Reads ``<checkpoint_dir>/<tag>_net_G_ema.msgpack`` (written by
``afcm_tpu.utils.checkpoint.save_generator_only``) and writes
``<checkpoint_dir>/<tag>_net_G_ema.pth``: a torch state_dict under the
reference's names (of either generator family, StyleGAN3 or CoModGAN, with
its ``moments`` and ``constants``: ``w_avg``, ``magnitude_ema``,
``noise_const``), which ``python -m afcm_tpu_torch.evaluate`` loads. When
the run dir also holds the full train state ``<tag>_state.msgpack``
(``afcm_tpu.utils.checkpoint.save_state``), it writes ``<tag>_net_G.pth``
and ``<tag>_net_D.pth`` from it as well. Needs JAX/flax (to read the
msgpack) and torch; ``tag`` defaults to "latest".
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from afcm_tpu.utils.checkpoint import (checkpoint_exists,  # noqa: E402
                                       load_generator_only)
from afcm_tpu_torch.utils.port import variables_to_state_dict  # noqa: E402


def _write(variables, path: str) -> str:
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in variables_to_state_dict(variables).items()}
    torch.save(state, path)
    return path


def convert(checkpoint_dir: str, tag: str = "latest") -> str:
    """Write ``<tag>_net_G_ema.pth`` beside the msgpack; returns its path."""
    return _write(load_generator_only(checkpoint_dir, tag),
                  os.path.join(checkpoint_dir, f"{tag}_net_G_ema.pth"))


def convert_train_state(checkpoint_dir: str, tag: str = "latest") -> list:
    """Write ``<tag>_net_G.pth`` and ``<tag>_net_D.pth`` from the full train
    state ``<tag>_state.msgpack``; returns their paths ([] without it)."""
    if not checkpoint_exists(checkpoint_dir, tag):
        return []
    from flax import serialization
    with open(os.path.join(checkpoint_dir, f"{tag}_state.msgpack"), "rb") as f:
        state = serialization.msgpack_restore(f.read())
    nets = {"G": {"params": state["params_G"], "moments": state["moments_G"],
                  "constants": state.get("constants_G") or {}},
            "D": {"params": state["params_D"]}}
    return [_write(variables, os.path.join(checkpoint_dir, f"{tag}_net_{name}.pth"))
            for name, variables in nets.items()]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    for path in [convert(*argv), *convert_train_state(*argv)]:
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
