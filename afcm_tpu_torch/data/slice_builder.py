"""Patch-slice index builders (reference: data/utils.py:38-199).

Pure numpy index math: given a volume shape, a patch shape and a stride,
produce the list of 3-D slice tuples that tile the volume (with a final
tail-aligned window per axis when the stride does not divide evenly).

The port's own copy of ``afcm_tpu/data/slice_builder.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

SliceTuple = Tuple[slice, ...]


def gen_indices(i: int, k: int, s: int):
    assert i >= k, "Sample size has to be bigger than the patch size"
    j = 0
    for j in range(0, i - k + 1, s):
        yield j
    if j + k < i:
        yield i - k


class SliceBuilder:
    def __init__(self, raw_dataset, label_dataset=None, weight_dataset=None,
                 patch_shape: Sequence[int] = (1, 256, 256),
                 stride_shape: Sequence[int] = (1, 32, 32), **kwargs):
        patch_shape = tuple(patch_shape)
        stride_shape = tuple(stride_shape)
        if not kwargs.get("skip_shape_check", False):
            assert len(patch_shape) == 3, "patch_shape must be a 3D tuple"
            assert patch_shape[1] >= 64 and patch_shape[2] >= 64, \
                "Height and Width must be greater or equal 64"

        self._raw_slices = self._build_slices(raw_dataset, patch_shape, stride_shape)
        self._label_slices = None
        if label_dataset is not None:
            self._label_slices = self._build_slices(label_dataset, patch_shape,
                                                    stride_shape)
            assert len(self._raw_slices) == len(self._label_slices)

    @property
    def raw_slices(self) -> List[SliceTuple]:
        return self._raw_slices

    @property
    def label_slices(self):
        return self._label_slices

    @staticmethod
    def _build_slices(dataset, patch_shape, stride_shape) -> List[SliceTuple]:
        slices = []
        if dataset.ndim == 4:
            in_channels, i_z, i_y, i_x = dataset.shape
        else:
            i_z, i_y, i_x = dataset.shape
        k_z, k_y, k_x = patch_shape
        s_z, s_y, s_x = stride_shape
        for z in gen_indices(i_z, k_z, s_z):
            for y in gen_indices(i_y, k_y, s_y):
                for x in gen_indices(i_x, k_x, s_x):
                    idx = (slice(z, z + k_z), slice(y, y + k_y),
                           slice(x, x + k_x))
                    if dataset.ndim == 4:
                        idx = (slice(0, in_channels),) + idx
                    slices.append(idx)
        return slices


class FilterGraySliceBuilder(SliceBuilder):
    """Drop patches with insufficient gray-matter content
    (reference: data/utils.py:132-156)."""

    def __init__(self, raw_dataset, label_dataset=None, weight_dataset=None,
                 patch_shape=(1, 256, 256), stride_shape=(1, 32, 32),
                 gray_threshold: float = 100, gray_percentile: float = 0.2,
                 **kwargs):
        super().__init__(raw_dataset, label_dataset, weight_dataset,
                         patch_shape, stride_shape, **kwargs)

        def accept(idx):
            if gray_percentile == 0:
                return True
            raw = np.copy(raw_dataset[idx])
            frac = np.count_nonzero(raw > gray_threshold) / raw.size
            return frac >= gray_percentile

        self._raw_slices = [s for s in self._raw_slices if accept(s)]


class FilterSliceBuilder(SliceBuilder):
    """Filter by label coverage and gray content
    (reference: data/utils.py:159-199)."""

    def __init__(self, raw_dataset, label_dataset=None, weight_dataset=None,
                 patch_shape=(1, 256, 256), stride_shape=(1, 32, 32),
                 ignore_index=(0,), threshold: float = 0.6,
                 slack_acceptance: float = 0.01, gray_threshold: float = 200,
                 gray_percentile: float = 0.2, **kwargs):
        super().__init__(raw_dataset, label_dataset, weight_dataset,
                         patch_shape, stride_shape, **kwargs)
        if label_dataset is None:
            return

        rand_state = np.random.RandomState(47)

        def accept(pair):
            raw_idx, label_idx = pair
            if gray_percentile != 0:
                raw = np.copy(raw_dataset[label_idx])
                frac = np.count_nonzero(raw > gray_threshold) / raw.size
                accept_gray = frac >= gray_percentile
            else:
                accept_gray = True
            if threshold != 0:
                patch = np.copy(label_dataset[label_idx])
                if tuple(ignore_index) != (0,):
                    for ii in ignore_index:
                        patch[patch == ii] = 0
                frac = np.count_nonzero(patch != 0) / patch.size
                accept_label = frac >= threshold
            else:
                accept_label = True
            return (accept_label and accept_gray) or \
                rand_state.rand() < slack_acceptance

        pairs = [p for p in zip(self._raw_slices, self._label_slices) if accept(p)]
        self._raw_slices = [p[0] for p in pairs]
        self._label_slices = [p[1] for p in pairs]


_BUILDERS = {
    "SliceBuilder": SliceBuilder,
    "FilterSliceBuilder": FilterSliceBuilder,
    "FilterGraySliceBuilder": FilterGraySliceBuilder,
}


def get_slice_builder(raws, labels, weight_maps, config) -> SliceBuilder:
    assert "name" in config
    return _BUILDERS[config["name"]](raws, labels, weight_maps, **{
        k: v for k, v in config.items() if k != "name"})
