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
and ``<tag>_net_D.pth`` from it as well: for a pix2pix run, which has no
EMA generator, these two only, with the batch norms' running statistics
(``batch_stats``) as the ``mean`` and ``var`` buffers. Needs JAX/flax (to
read the msgpack) and torch; ``tag`` defaults to "latest".
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from afcm_tpu.utils.checkpoint import (checkpoint_exists,  # noqa: E402
                                       load_generator_only)
from afcm_tpu_torch.utils.port import (jax_state_dict,  # noqa: E402
                                       train_state_networks)


def _write(variables, path: str) -> str:
    torch.save(jax_state_dict(variables), path)
    return path


def convert(checkpoint_dir: str, tag: str = "latest") -> str:
    """Write ``<tag>_net_G_ema.pth`` beside the msgpack; returns its path."""
    return _write(load_generator_only(checkpoint_dir, tag),
                  os.path.join(checkpoint_dir, f"{tag}_net_G_ema.pth"))


def has_generator_only(checkpoint_dir: str, tag: str = "latest") -> bool:
    return os.path.exists(os.path.join(checkpoint_dir, f"{tag}_net_G_ema.msgpack"))


def convert_train_state(checkpoint_dir: str, tag: str = "latest") -> list:
    """Write ``<tag>_net_G.pth`` and ``<tag>_net_D.pth`` from the full train
    state ``<tag>_state.msgpack``; returns their paths ([] without it)."""
    if not checkpoint_exists(checkpoint_dir, tag):
        return []
    from flax import serialization
    with open(os.path.join(checkpoint_dir, f"{tag}_state.msgpack"), "rb") as f:
        state = serialization.msgpack_restore(f.read())
    return [_write(variables, os.path.join(checkpoint_dir, f"{tag}_net_{name}.pth"))
            for name, variables in train_state_networks(state).items()]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    ema = [convert(*argv)] if has_generator_only(*argv) else []
    paths = ema + convert_train_state(*argv)
    if not paths:
        raise SystemExit(f"no checkpoint of tag {argv[1:] or ['latest']} in {argv[0]}")
    for path in paths:
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
