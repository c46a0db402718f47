"""NIfTI-directory dataset for cascaded evaluation
(reference: data/cmsrnii_dataset.py).

Loads per-subject NIfTI volumes (typically prior predictions named
``<subject>*<modality>.nii*`` with prefix ``_predictions0``), percentile-clips
them to uint8 [0, 255], and exposes the same slice-window contract as the h5
dataset.

The port's own copy of ``afcm_tpu/data/nii_dataset.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ..utils.nifti import read_nifti
from .h5_dataset import AbstractVolumeDataset


def percentile_clip(volume: np.ndarray, p_min: float = 0.5,
                    p_max: float = 99.5, strictly_positive: bool = True):
    """Clip to percentiles and normalize to [0, 1]
    (reference: cmsrnii_dataset.py:79-113)."""
    v_min, v_max = np.percentile(volume, [p_min, p_max])
    if v_min < 0 and strictly_positive:
        v_min = 0
    out = np.clip(volume, v_min, v_max)
    return (out - v_min) / (v_max - v_min)


class StandardNIIDataset(AbstractVolumeDataset):
    def load_volumes(self, file_path: str) -> Dict[str, np.ndarray]:
        out = {}
        subject = os.path.basename(os.path.normpath(file_path))
        for raw_name in self.raw_internal_path:
            pattern = os.path.join(file_path, f"{subject}*{raw_name}.nii*")
            matches = glob.glob(pattern)
            if not matches:
                raise FileNotFoundError(pattern)
            vol, _ = read_nifti(matches[0])
            vol = percentile_clip(np.asarray(vol, np.float64))
            out[raw_name] = (vol * 255).astype(np.uint8)
        return out

    @classmethod
    def traverse_paths(cls, file_paths: List[str], loaders_config) -> List[str]:
        results = []
        for file_path in file_paths:
            if os.path.isdir(file_path):
                results.extend(sorted(
                    os.path.join(file_path, x) for x in os.listdir(file_path)))
        return results
