"""Legacy pix2pix image-folder datasets
(reference: data/{aligned,unaligned,single}_dataset.py, image_folder.py,
base_dataset.py).

These serve the pix2pix baseline on 2-D image pairs: `AlignedDataset` reads
A|B side-by-side images, `UnalignedDataset` two independent folders,
`SingleDataset` inference inputs.  Transforms follow base_dataset.get_transform
(resize / crop / flip / normalize to [-1, 1]), implemented with PIL + numpy.

The port's own copy of ``afcm_tpu/data/image_datasets.py`` (host code, numpy
only): the port imports nothing of the JAX package. PIL is imported where an
image is read or transformed, never at import.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
                  ".webp")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str, max_dataset_size: float = float("inf")) -> List[str]:
    """(reference: data/image_folder.py)"""
    images = []
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[:min(int(max_dataset_size) if max_dataset_size != float("inf")
                       else len(images), len(images))]


def _load_image(path: str, grayscale: bool):
    from PIL import Image
    img = Image.open(path)
    return img.convert("L" if grayscale else "RGB")


def get_params(preprocess: str, load_size: int, crop_size: int, size,
               rng=None, deterministic: bool = False):
    """rng: optional random.Random; TrainLoader passes its seeded instance
    so epochs are reproducible (and prefetch threads do not race the
    process-global random state).

    ``deterministic`` (val/test phases) center-crops and never flips — the
    reference's test protocol hard-sets no_flip + serial_batches (upstream
    pix2pix test.py), so scoring is augmentation-free."""
    r = rng if rng is not None else random
    w, h = size
    new_w, new_h = w, h
    if preprocess == "resize_and_crop":
        new_w = new_h = load_size
    elif preprocess == "scale_width_and_crop":
        new_w = load_size
        new_h = load_size * h // w
    if deterministic:
        return {"crop_pos": (max(0, new_w - crop_size) // 2,
                             max(0, new_h - crop_size) // 2), "flip": False}
    x = r.randint(0, max(0, new_w - crop_size))
    y = r.randint(0, max(0, new_h - crop_size))
    flip = r.random() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def apply_transform(img, preprocess: str = "resize_and_crop",
                    load_size: int = 286, crop_size: int = 256,
                    params: Optional[Dict] = None, flip: bool = True,
                    convert: bool = True, rng=None) -> np.ndarray:
    """PIL image -> [C, H, W] float32 in [-1, 1]
    (reference: base_dataset.py get_transform)."""
    from PIL import Image
    if "resize" in preprocess:
        img = img.resize((load_size, load_size), Image.BICUBIC)
    elif "scale_width" in preprocess:
        w, h = img.size
        if w != load_size:
            img = img.resize((load_size, max(load_size * h // w, crop_size)),
                             Image.BICUBIC)
    r = rng if rng is not None else random
    if "crop" in preprocess:
        if params is None:
            w, h = img.size
            x = r.randint(0, max(0, w - crop_size))
            y = r.randint(0, max(0, h - crop_size))
        else:
            x, y = params["crop_pos"]
        img = img.crop((x, y, x + crop_size, y + crop_size))
    if flip:
        do_flip = params["flip"] if params is not None else r.random() > 0.5
        if do_flip:
            img = img.transpose(0)  # PIL.Image.FLIP_LEFT_RIGHT == 0
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = np.transpose(arr, (2, 0, 1))
    if convert:
        arr = arr * 2.0 - 1.0
    return np.ascontiguousarray(arr)


class AlignedDataset:
    """A|B side-by-side paired images (reference: data/aligned_dataset.py)."""

    def __init__(self, dataroot: str, phase: str = "train",
                 preprocess: str = "resize_and_crop", load_size: int = 286,
                 crop_size: int = 256, input_nc: int = 1, output_nc: int = 1,
                 direction: str = "AtoB", max_dataset_size=float("inf")):
        self.dir_ab = os.path.join(dataroot, phase)
        self.ab_paths = make_dataset(self.dir_ab, max_dataset_size)
        self.phase = phase
        self.preprocess = preprocess
        self.load_size = load_size
        self.crop_size = crop_size
        self.direction = direction
        self.input_nc = input_nc if direction == "AtoB" else output_nc
        self.output_nc = output_nc if direction == "AtoB" else input_nc

    def __len__(self) -> int:
        return len(self.ab_paths)

    def get_item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        path = self.ab_paths[index]
        ab = _load_image(path, grayscale=False)
        w, h = ab.size
        w2 = w // 2
        a = ab.crop((0, 0, w2, h))
        b = ab.crop((w2, 0, w, h))
        if self.input_nc == 1:
            a = a.convert("L")
        if self.output_nc == 1:
            b = b.convert("L")
        params = get_params(self.preprocess, self.load_size, self.crop_size,
                            a.size, rng=rng,
                            deterministic=self.phase != "train")
        a_t = apply_transform(a, self.preprocess, self.load_size,
                              self.crop_size, params)
        b_t = apply_transform(b, self.preprocess, self.load_size,
                              self.crop_size, params)
        if self.direction == "AtoB":
            return {"A": a_t, "B": b_t, "A_paths": path, "B_paths": path}
        return {"A": b_t, "B": a_t, "A_paths": path, "B_paths": path}


class UnalignedDataset:
    """Two independent folders trainA / trainB (reference:
    unaligned_dataset.py). BtoA swaps the domain folders and channel
    counts exactly like the reference (unaligned_dataset.py:33-37)."""

    def __init__(self, dataroot: str, phase: str = "train",
                 preprocess: str = "resize_and_crop", load_size: int = 286,
                 crop_size: int = 256, serial_batches: bool = False,
                 direction: str = "AtoB", input_nc: int = 1,
                 output_nc: int = 1, max_dataset_size=float("inf")):
        btoa = direction == "BtoA"
        self.dir_a = os.path.join(dataroot, phase + ("B" if btoa else "A"))
        self.dir_b = os.path.join(dataroot, phase + ("A" if btoa else "B"))
        self.a_paths = make_dataset(self.dir_a, max_dataset_size)
        self.b_paths = make_dataset(self.dir_b, max_dataset_size)
        self.input_nc = output_nc if btoa else input_nc
        self.output_nc = input_nc if btoa else output_nc
        self.phase = phase
        # the reference's test protocol forces serial pairing + no flip
        # (upstream pix2pix test.py); training keeps the configured policy
        self.serial_batches = serial_batches or phase != "train"
        self.preprocess = preprocess
        self.load_size = load_size
        self.crop_size = crop_size

    def __len__(self) -> int:
        return max(len(self.a_paths), len(self.b_paths))

    def get_item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        r = rng if rng is not None else random
        a_path = self.a_paths[index % len(self.a_paths)]
        if self.serial_batches:
            b_path = self.b_paths[index % len(self.b_paths)]
        else:
            b_path = self.b_paths[r.randint(0, len(self.b_paths) - 1)]
        det = self.phase != "train"
        a_img = _load_image(a_path, self.input_nc == 1)
        b_img = _load_image(b_path, self.output_nc == 1)
        pa = get_params(self.preprocess, self.load_size, self.crop_size,
                        a_img.size, deterministic=True) if det else None
        pb = get_params(self.preprocess, self.load_size, self.crop_size,
                        b_img.size, deterministic=True) if det else None
        a = apply_transform(a_img, self.preprocess, self.load_size,
                            self.crop_size, params=pa, rng=rng)
        b = apply_transform(b_img, self.preprocess, self.load_size,
                            self.crop_size, params=pb, rng=rng)
        return {"A": a, "B": b, "A_paths": a_path, "B_paths": b_path}


class SingleDataset:
    """Single-folder inference inputs (reference: single_dataset.py)."""

    def __init__(self, dataroot: str, preprocess: str = "resize_and_crop",
                 load_size: int = 256, crop_size: int = 256, input_nc: int = 1,
                 max_dataset_size=float("inf")):
        self.a_paths = make_dataset(dataroot, max_dataset_size)
        self.preprocess = preprocess
        self.load_size = load_size
        self.crop_size = crop_size
        self.input_nc = input_nc

    def __len__(self) -> int:
        return len(self.a_paths)

    def get_item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        path = self.a_paths[index]
        img = _load_image(path, grayscale=self.input_nc == 1)
        return {"A": apply_transform(img, self.preprocess, self.load_size,
                                     self.crop_size, rng=rng),
                "A_paths": path}
