"""Image conversion helpers + discriminator history pool
(reference: util/util.py:9-27 tensor2im, util/image_pool.py ImagePool).

The port's own copy of ``afcm_tpu/utils/image.py`` (host code, numpy only):
the port imports nothing of the JAX package. ``save_image`` imports
matplotlib when it is called.
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np


def tensor2im(array, imtype=np.uint8) -> np.ndarray:
    """[-1,1] NCHW array -> HxWx3 uint8 image (first sample)."""
    array = np.asarray(array)
    if array.ndim == 4:
        array = array[0]
    if array.shape[0] == 1:
        array = np.tile(array, (3, 1, 1))
    img = (np.transpose(array, (1, 2, 0)) + 1) / 2.0 * 255.0
    return np.clip(img, 0, 255).astype(imtype)


def save_image(image_numpy: np.ndarray, image_path: str,
               aspect_ratio: float = 1.0):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    matplotlib.image.imsave(image_path, image_numpy)


def mkdirs(paths):
    if isinstance(paths, (list, tuple)):
        for p in paths:
            os.makedirs(p, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


class ImagePool:
    """History buffer of generated images for D updates
    (reference: util/image_pool.py:5-54; CycleGAN legacy, kept for parity)."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images: List[np.ndarray] = []
        self._rng = random.Random(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return images
        out = []
        for image in np.asarray(images):
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image)
                out.append(image)
            elif self._rng.random() > 0.5:
                idx = self._rng.randint(0, self.pool_size - 1)
                out.append(self.images[idx].copy())
                self.images[idx] = image
            else:
                out.append(image)
        return np.stack(out, axis=0)
