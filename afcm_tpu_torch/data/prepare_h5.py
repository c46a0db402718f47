"""Offline NIfTI -> h5 subject conversion (``afcm_tpu/data/prepare_h5.py``;
reference: data/prepare_h5.py), a copy over the port's ``utils/nifti.py``.
Host code only: numpy, and h5py where a subject is written.

Usage:
    python -m afcm_tpu_torch.data.prepare_h5 --data-path DIR --out-path DIR \
        --modalities T1_HR T2_FLAIR_linear [--size 256]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.nifti import read_nifti


def rescale_intensity(volume: np.ndarray, percentils=(0.5, 99.5),
                      bins_num: int = 256, norm: bool = False) -> np.ndarray:
    """Percentile binning of foreground voxels to [1, bins-1]
    (reference: prepare_h5.py:9-26)."""
    obj_volume = volume[np.where(volume > 0)]
    min_value = np.percentile(obj_volume, percentils[0])
    max_value = np.percentile(obj_volume, percentils[1])
    if bins_num == 0:
        obj_volume = (obj_volume - min_value) / (max_value - min_value)
        obj_volume = obj_volume.astype(np.float32)
    else:
        obj_volume = np.round((obj_volume - min_value) /
                              (max_value - min_value) * (bins_num - 1))
        obj_volume[np.where(obj_volume < 1)] = 1
        obj_volume[np.where(obj_volume > (bins_num - 1))] = bins_num - 1
    volume = volume.astype(obj_volume.dtype)
    volume[np.where(volume > 0)] = obj_volume
    if norm:
        volume = volume.astype(float) / (bins_num - 1)
    return volume


def convert_subject(subject: str, data_path: str, out_path: str,
                    modalities, expect_size: int = 256):
    import h5py
    h5_path = os.path.join(out_path, subject + ".h5")
    with h5py.File(h5_path, "w") as h5_file:
        for modality in modalities:
            img = os.path.join(data_path, subject,
                               f"{subject}_{modality}.nii.gz")
            if not os.path.exists(img):
                continue
            img_data, _ = read_nifti(img)
            if expect_size:
                assert img_data.shape[1] == expect_size and \
                    img_data.shape[2] == expect_size, \
                    f"{img}: expected {expect_size}^2 slices, got {img_data.shape}"
            img_data = rescale_intensity(np.asarray(img_data, np.float64))
            img_data = np.clip(np.around(img_data), 0, 255).astype(np.uint8)
            h5_file[modality] = img_data
    return h5_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--out-path", required=True)
    parser.add_argument("--modalities", nargs="+",
                        default=["T1_HR", "T2_FLAIR_linear"])
    parser.add_argument("--size", type=int, default=256)
    args = parser.parse_args(argv)

    os.makedirs(args.out_path, exist_ok=True)
    for subject in sorted(os.listdir(args.data_path)):
        if not os.path.isdir(os.path.join(args.data_path, subject)):
            continue
        path = convert_subject(subject, args.data_path, args.out_path,
                               args.modalities, args.size)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
