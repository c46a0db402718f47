"""Synthetic phantom subjects (``afcm_tpu/data/demo.py``).

``make_phantom`` and ``write_demo_tree`` are the port's own copies of the JAX
package's: smooth multi-modal volumes whose modalities are nonlinear
transforms of shared anatomy. ``PhantomSubject`` holds one in memory, windowed
by the port's dataset, ``TestLoader`` and ``TrainLoader`` with the ADNI CMSR
modalities (``flair`` in, ``t1_hr4sr`` out): the serving and training paths'
input without an h5 file or h5py.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .h5_dataset import AbstractVolumeDataset
from .loader import TestLoader, TrainLoader


def make_phantom(depth: int = 48, size: int = 256, seed: int = 0):
    """Returns dict of modality -> uint8 [depth, size, size] volumes."""
    rng = np.random.RandomState(seed)
    z, y, x = np.meshgrid(np.linspace(-1, 1, depth), np.linspace(-1, 1, size),
                          np.linspace(-1, 1, size), indexing="ij")
    r = np.sqrt((x / 0.8) ** 2 + (y / 0.9) ** 2 + (z / 0.95) ** 2)
    skull = (r < 1.0).astype(np.float64)

    # Smooth random "anatomy" field.
    from scipy.ndimage import gaussian_filter
    field = gaussian_filter(rng.randn(depth, size, size), sigma=(2, 8, 8))
    field = (field - field.min()) / (field.max() - field.min())
    ventricles = gaussian_filter(rng.randn(depth, size, size), sigma=(3, 12, 12))
    ventricles = (ventricles > 1.0 * ventricles.std()).astype(np.float64)

    t1 = skull * (60 + 150 * field + 40 * ventricles)
    t2 = skull * (40 + 120 * (1 - field) + 90 * ventricles)
    flair = skull * (50 + 100 * field ** 2 + 70 * ventricles)

    out = {}
    for name, vol in [("t1", t1), ("t2", t2), ("flair", flair)]:
        out[name] = np.clip(vol, 0, 255).astype(np.uint8)
    # Low-res (thick-slice) t1 companion for SR configs: replicate every
    # k-th slice to simulate thick acquisition.
    k = 4
    lr = out["t1"].copy()
    for i in range(depth):
        lr[i] = out["t1"][(i // k) * k]
    out["t1_lr4sr"] = lr
    out["t1_hr4sr"] = out["t1"]
    return out


def write_demo_tree(root: str, n_train: int = 2, n_val: int = 1,
                    n_test: int = 1, depth: int = 48, size: int = 256):
    """Write a train/val/test h5 directory tree of synthetic subjects."""
    import h5py
    counters = [("train", n_train), ("val", n_val), ("test", n_test)]
    seed = 0
    for split, count in counters:
        split_dir = os.path.join(root, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            vols = make_phantom(depth=depth, size=size, seed=seed)
            seed += 1
            path = os.path.join(split_dir, f"subject_{split}_{i}.h5")
            with h5py.File(path, "w") as f:
                for name, vol in vols.items():
                    f[name] = vol
    return root


class PhantomSubject(AbstractVolumeDataset):
    """One synthetic subject held in memory, for the ``test``, ``train`` or
    ``val`` phase."""

    def __init__(self, depth: int, size: int, seed: int = 0,
                 phase: str = "test"):
        self._volume_args = dict(depth=depth, size=size, seed=seed)
        transformer = {"raw": {
            "Normalize": {"enabled": True, "min_value": 0.0, "max_value": 255.0},
            "ToTensor": {"enabled": True, "expand_dims": False}}}
        super().__init__(
            "phantom.h5", phase,
            {"name": "SliceBuilder", "patch_shape": [1, size, size],
             "stride_shape": [1, size, size]},
            transformer, raw_internal_path_in=["flair"],
            raw_internal_path_out=["t1_hr4sr"], thickness=[5], slice_num=4,
            global_normalization=None)

    def load_volumes(self, file_path):
        return make_phantom(**self._volume_args)


def phantom_test_loader(depth: int, size: int, batch_size: int,
                        transfer_dtype: str = "uint8", seed: int = 0):
    """``TestLoader`` over one ``depth`` x ``size``^2 phantom subject, one
    full-slice window per slice."""
    return TestLoader(PhantomSubject(depth, size, seed=seed),
                      batch_size=batch_size, transfer_dtype=transfer_dtype)


def phantom_train_loaders(depth: int, size: int, batch_size: int,
                          seed: int = 0) -> Dict[str, TrainLoader]:
    """``{"train", "val"}`` loaders as ``data.get_train_loaders``
    returns them, each over one ``depth`` x ``size``^2 phantom subject
    (train from ``seed``, val from ``seed + 1``), one full-slice window per
    slice."""
    train = TrainLoader(PhantomSubject(depth, size, seed=seed, phase="train"),
                        batch_size=batch_size, shuffle=True, seed=seed)
    val = TrainLoader(PhantomSubject(depth, size, seed=seed + 1, phase="val"),
                      batch_size=batch_size, shuffle=False, seed=seed,
                      drop_last=False)
    return {"train": train, "val": val}
