"""The plain reference of the port's data layer: the 4-slice input window
with its fractional slice position, the uint8 normalization and the stitch
of a served volume, written from the reference's description
(reference: data/cmsr_dataset.py:98-155) and not from the port's code."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def window(volume: np.ndarray, idx: int, thickness: int) -> Tuple[np.ndarray, float]:
    """The four thick slices around output slice ``idx``,
    ``[a - t, a, a + t, a + 2t]`` with ``a = (idx // t) * t``, zero where
    out of range, and the fractional position ``(idx - a) / t``."""
    depth = volume.shape[0]
    a = (idx // thickness) * thickness
    out = np.zeros((4,) + volume.shape[1:], volume.dtype)
    for k, z in enumerate((a - thickness, a, a + thickness, a + 2 * thickness)):
        if 0 <= z < depth:
            out[k] = volume[z]
    return out, (idx - a) / thickness


def normalize(raw: np.ndarray, lo: float = 0.0, hi: float = 255.0) -> np.ndarray:
    """uint8 -> [-1, 1] float32."""
    return np.clip(2 * ((raw.astype(np.float32) - lo) / (hi - lo)) - 1, -1, 1)


def subject_windows(volume: np.ndarray, thickness: int):
    """Every output slice's raw window and position, in slice order."""
    items = [window(volume, i, thickness) for i in range(volume.shape[0])]
    return (np.stack([w for w, _ in items]),
            np.array([[s] for _, s in items], np.float32))


def train_batches(volumes: List[dict], modality_in: str, modality_out: str,
                  thickness: int, batch_size: int, order_seed: int, steps: int):
    """The first ``steps`` batches of a shuffled epoch over the slices of
    ``volumes`` (one window per slice, subjects concatenated in order):
    ``np.random.RandomState(order_seed)`` permutes the slice indices."""
    index = [(v, i) for v, vol in enumerate(volumes)
             for i in range(vol[modality_out].shape[0])]
    order = np.arange(len(index))
    np.random.RandomState(order_seed).shuffle(order)
    batches = []
    for s in range(steps):
        rows = [index[k] for k in order[s * batch_size:(s + 1) * batch_size]]
        a, pos, b = [], [], []
        for v, i in rows:
            w, p = window(volumes[v][modality_in], i, thickness)
            a.append(normalize(w))
            pos.append([p])
            b.append(normalize(volumes[v][modality_out][i:i + 1]))
        batches.append({"A": np.stack(a), "B": np.stack(b),
                        "slice_idx": np.array(pos, np.float32)})
    return batches
