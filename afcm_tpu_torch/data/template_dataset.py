"""Dataset plugin template (reference: data/template_dataset.py).

This module documents the dataset contract of the framework so custom
datasets can be added by example.  Select it with ``loaders.dataset_mode:
template``.  A dataset is any object with:

    __len__() -> int
        Number of samples.

    get_item(index, rng=None) -> Dict[str, np.ndarray]
        One sample.  Training batches are assembled by stacking the dict
        values, so every sample must return the same keys with the same
        shapes.  The GAN models consume ``A`` ([C, H, W] float32 in [-1, 1]),
        ``B`` (target, same layout) and — for the slice-conditioned CMSR
        models — ``slice_idx`` ([1] float32 fractional position).

    (optional) get_batch(indices, rng=None) -> Dict[str, np.ndarray] | None
        Vectorized fast path: assemble a whole batch at once (see
        h5_dataset.CmsrDataset.get_batch for the native-accelerated
        example).  Return None to fall back to per-item assembly.

Unlike the reference — which discovers ``<mode>_dataset.py`` modules by
import reflection (reference: data/__init__.py:18-37) — the factories here
are a closed registry in :mod:`afcm_tpu_torch.data.loader`; add a branch in
``create_dataset`` for new modes.

The port's own copy of ``afcm_tpu/data/template_dataset.py`` (host code,
numpy only): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class TemplateDataset:
    """A template dataset class for implementing custom datasets.

    Produces deterministic synthetic A/B pairs so the full train loop runs
    against it out of the box (handy as a wiring smoke test).
    """

    def __init__(self, loaders_config, phase: str = "train"):
        # 1. Save the options you need from the ``loaders`` config subtree.
        #    Shapes follow the experiment config so the synthetic samples
        #    plug straight into whichever model the config selects: patch
        #    H/W from the slice builder (falling back to crop_size), input
        #    channels from the CMSR window size (slice_num).
        sb = loaders_config.get(phase if phase in ("train", "test") else
                                "train", {}) or {}
        patch = (sb.get("slice_builder", {}) or {}).get("patch_shape")
        self.crop_size = int(patch[-1]) if patch else \
            int(loaders_config.get("crop_size", 256) or 256)
        self.in_channels = int(loaders_config.get("slice_num", 1) or 1)
        self.phase = phase
        # 2. Gather your sample index (file paths, h5 keys, ...).
        self.num_samples = 16 if phase == "train" else 4

    def __len__(self) -> int:
        return self.num_samples

    def get_item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        # 3. Load + transform one sample; use ``rng`` (random.Random) for any
        #    train-time stochastic augmentation so epochs are reproducible.
        h = w = self.crop_size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        a = np.stack([np.sin(2 * np.pi * (index + c + 1) * xx / w)
                      for c in range(self.in_channels)])
        b = np.sin(2 * np.pi * (index + 1) * yy / h)[None]
        return {"A": a.astype(np.float32), "B": b.astype(np.float32)}
