"""In-memory phantom subjects (``afcm_tpu/data/demo.py``).

``afcm_tpu.data.demo.make_phantom`` volumes, windowed by ``afcm_tpu``'s own
dataset, ``TestLoader`` and ``TrainLoader`` with the ADNI CMSR modalities
(``flair`` in, ``t1_hr4sr`` out): the serving and training paths' input
without an h5 file or h5py.
"""

from __future__ import annotations

from typing import Dict

from afcm_tpu.data.demo import make_phantom
from afcm_tpu.data.h5_dataset import AbstractVolumeDataset
from afcm_tpu.data.loader import TestLoader, TrainLoader


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
    """``{"train", "val"}`` loaders as ``afcm_tpu.data.get_train_loaders``
    returns them, each over one ``depth`` x ``size``^2 phantom subject
    (train from ``seed``, val from ``seed + 1``), one full-slice window per
    slice."""
    train = TrainLoader(PhantomSubject(depth, size, seed=seed, phase="train"),
                        batch_size=batch_size, shuffle=True, seed=seed)
    val = TrainLoader(PhantomSubject(depth, size, seed=seed + 1, phase="val"),
                      batch_size=batch_size, shuffle=False, seed=seed,
                      drop_last=False)
    return {"train": train, "val": val}
