"""Config-driven host-side augmentation pipeline
(reference: data/augment/transforms.py).

All transforms operate on numpy arrays of shape (D, H, W) or (C, D, H, W) and
return numpy; `ToArray` replaces the reference's `ToTensor` as the terminal
stage (device placement happens in the loader).  Per-call shared-seed
semantics are preserved: `Transformer.raw_transform()` returns a fresh
Compose whose random transforms share one RNG seed, so the same spatial
augmentation applies across the slices of a window.

The port's own copy of ``afcm_tpu/data/transforms.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates, rotate

GLOBAL_RANDOM_STATE = np.random.RandomState(47)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, m):
        for t in self.transforms:
            m = t(m)
        return m


class RandomFlip:
    def __init__(self, random_state, axes=None, axis_prob: float = 0.5, **kw):
        assert random_state is not None
        self.random_state = random_state
        self.axes = (0, 1, 2) if axes is None else axes
        self.axis_prob = axis_prob

    def __call__(self, m):
        assert m.ndim in (3, 4)
        for axis in self.axes:
            if self.random_state.uniform() > self.axis_prob:
                if m.ndim == 3:
                    m = np.flip(m, axis)
                else:
                    m = np.stack([np.flip(m[c], axis) for c in range(m.shape[0])])
        return m


class RandomRotate90:
    def __init__(self, random_state, **kw):
        self.random_state = random_state
        self.axis = (1, 2)

    def __call__(self, m):
        assert m.ndim in (3, 4)
        k = self.random_state.randint(0, 4)
        if m.ndim == 3:
            return np.rot90(m, k, self.axis)
        return np.stack([np.rot90(m[c], k, self.axis) for c in range(m.shape[0])])


class RandomRotate:
    def __init__(self, random_state, angle_spectrum: int = 30, axes=None,
                 mode: str = "reflect", order: int = 0, **kw):
        self.random_state = random_state
        self.angle_spectrum = angle_spectrum
        self.axes = [(1, 0), (2, 1), (2, 0)] if axes is None else \
            [tuple(a) for a in axes]
        self.mode = mode
        self.order = order

    def __call__(self, m):
        axis = self.axes[self.random_state.randint(len(self.axes))]
        angle = self.random_state.randint(-self.angle_spectrum, self.angle_spectrum)
        if m.ndim == 3:
            return rotate(m, angle, axes=axis, reshape=False, order=self.order,
                          mode=self.mode, cval=-1)
        return np.stack([rotate(m[c], angle, axes=axis, reshape=False,
                                order=self.order, mode=self.mode, cval=-1)
                         for c in range(m.shape[0])])


class RandomContrast:
    def __init__(self, random_state, alpha=(0.5, 1.5), mean: float = 0.0,
                 execution_probability: float = 0.1, **kw):
        self.random_state = random_state
        self.alpha = alpha
        self.mean = mean
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            alpha = self.random_state.uniform(self.alpha[0], self.alpha[1])
            return np.clip(self.mean + alpha * (m - self.mean), -1, 1)
        return m


class ElasticDeformation:
    """Per-voxel elastic mesh deformation (reference: transforms.py:138-191)."""

    def __init__(self, random_state, spline_order: int, alpha: float = 2000,
                 sigma: float = 50, execution_probability: float = 0.1,
                 apply_3d: bool = True, **kw):
        self.random_state = random_state
        self.spline_order = spline_order
        self.alpha = alpha
        self.sigma = sigma
        self.execution_probability = execution_probability
        self.apply_3d = apply_3d

    def __call__(self, m):
        if self.random_state.uniform() >= self.execution_probability:
            return m
        assert m.ndim in (3, 4)
        volume_shape = m.shape if m.ndim == 3 else m[0].shape
        if self.apply_3d:
            dz = gaussian_filter(self.random_state.randn(*volume_shape),
                                 self.sigma, mode="reflect") * self.alpha
        else:
            dz = np.zeros(volume_shape)
        dy, dx = (gaussian_filter(self.random_state.randn(*volume_shape),
                                  self.sigma, mode="reflect") * self.alpha
                  for _ in range(2))
        z, y, x = np.meshgrid(*(np.arange(s) for s in volume_shape), indexing="ij")
        indices = z + dz, y + dy, x + dx
        if m.ndim == 3:
            return map_coordinates(m, indices, order=self.spline_order,
                                   mode="reflect")
        return np.stack([map_coordinates(c, indices, order=self.spline_order,
                                         mode="reflect") for c in m])


class ResizeCrop:
    def __init__(self, random_state=None, inter_size=(286, 286),
                 target_size=(256, 256), is_label: bool = False, **kw):
        import cv2
        self._cv2 = cv2
        self.random_state = random_state
        self.inter_size = tuple(inter_size)
        self.target_size = tuple(target_size)
        self.interpolation = cv2.INTER_CUBIC if is_label else cv2.INTER_NEAREST

    def __call__(self, m):
        assert m.ndim in (3, 4)
        # Offsets mirror the reference exactly (transforms.py:201-202): drawn
        # from inter_size - original(!) - 1, not inter - target.  The
        # reference then writes the crop back in place, so it only
        # type-checks when original == target_size; we return a new array
        # with the same values.
        y, x = m.shape[-2], m.shape[-1]
        w_offset = self.random_state.randint(
            0, max(0, self.inter_size[1] - y - 1))
        h_offset = self.random_state.randint(
            0, max(0, self.inter_size[0] - x - 1))

        def resize_stack(stack):
            out = []
            for sl in stack:
                sl = self._cv2.resize(sl, self.inter_size,
                                      interpolation=self.interpolation)
                out.append(sl[w_offset:w_offset + self.target_size[1],
                              h_offset:h_offset + self.target_size[0]])
            return np.stack(out)

        if m.ndim == 3:
            return resize_stack(m)
        return np.stack([resize_stack(c) for c in m])


class CropToFixed:
    """Crop or pad H, W to a fixed size (reference: transforms.py:227-281)."""

    def __init__(self, random_state=None, size=(256, 256),
                 centered: bool = False, mode: str = "reflect", **kw):
        self.random_state = random_state
        self.crop_y, self.crop_x = size
        self.centered = centered
        self.mode = mode

    def __call__(self, m):
        def _padding(pad_total):
            half = pad_total // 2
            return (half, pad_total - half)

        def _rand_range_and_pad(crop, maxsize):
            if crop < maxsize:
                return maxsize - crop, (0, 0)
            return 1, _padding(crop - maxsize)

        def _start_and_pad(crop, maxsize):
            if crop < maxsize:
                return (maxsize - crop) // 2, (0, 0)
            return 0, _padding(crop - maxsize)

        assert m.ndim in (3, 4)
        y, x = m.shape[-2], m.shape[-1]
        if not self.centered:
            y_range, y_pad = _rand_range_and_pad(self.crop_y, y)
            x_range, x_pad = _rand_range_and_pad(self.crop_x, x)
            y_start = self.random_state.randint(y_range)
            x_start = self.random_state.randint(x_range)
        else:
            y_start, y_pad = _start_and_pad(self.crop_y, y)
            x_start, x_pad = _start_and_pad(self.crop_x, x)

        def crop3(v):
            out = v[:, y_start:y_start + self.crop_y,
                    x_start:x_start + self.crop_x]
            return np.pad(out, ((0, 0), y_pad, x_pad), mode=self.mode)

        if m.ndim == 3:
            return crop3(m)
        return np.stack([crop3(m[c]) for c in range(m.shape[0])])


class Standardize:
    def __init__(self, eps: float = 1e-10, mean=None, std=None,
                 channelwise: bool = False, **kw):
        if mean is not None or std is not None:
            assert mean is not None and std is not None
        self.mean, self.std, self.eps, self.channelwise = mean, std, eps, channelwise

    def __call__(self, m):
        if self.mean is not None:
            mean, std = self.mean, self.std
        elif self.channelwise:
            axes = tuple(range(1, m.ndim))
            mean = np.mean(m, axis=axes, keepdims=True)
            std = np.std(m, axis=axes, keepdims=True)
        else:
            mean, std = np.mean(m), np.std(m)
        return (m - mean) / np.clip(std, a_min=self.eps, a_max=None)


class PercentileNormalizer:
    def __init__(self, pmin: float = 1, pmax: float = 99.6,
                 channelwise: bool = False, eps: float = 1e-10, **kw):
        self.pmin, self.pmax, self.channelwise, self.eps = pmin, pmax, channelwise, eps

    def __call__(self, m):
        if self.channelwise:
            axes = tuple(range(1, m.ndim))
            lo = np.percentile(m, self.pmin, axis=axes, keepdims=True)
            hi = np.percentile(m, self.pmax, axis=axes, keepdims=True)
        else:
            lo = np.percentile(m, self.pmin)
            hi = np.percentile(m, self.pmax)
        return (m - lo) / (hi - lo + self.eps)


class Normalize:
    """Min-max scale to [-1, 1] (reference: transforms.py:604-616)."""

    def __init__(self, min_value: float, max_value: float, **kw):
        assert max_value > min_value
        self.min_value = min_value
        self.value_range = max_value - min_value

    def __call__(self, m):
        norm_0_1 = (m - self.min_value) / self.value_range
        return np.clip(2 * norm_0_1 - 1, -1, 1)


class AdditiveGaussianNoise:
    def __init__(self, random_state, scale=(0.0, 1.0),
                 execution_probability: float = 0.1, **kw):
        self.random_state = random_state
        self.scale = scale
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            std = self.random_state.uniform(self.scale[0], self.scale[1])
            return m + self.random_state.normal(0, std, size=m.shape)
        return m


class AdditivePoissonNoise:
    def __init__(self, random_state, lam=(0.0, 1.0),
                 execution_probability: float = 0.1, **kw):
        self.random_state = random_state
        self.lam = lam
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            lam = self.random_state.uniform(self.lam[0], self.lam[1])
            return m + self.random_state.poisson(lam, size=m.shape)
        return m


class GaussianBlur3D:
    def __init__(self, sigma=(0.1, 2.0), execution_probability: float = 0.5, **kw):
        self.sigma = sigma
        self.execution_probability = execution_probability

    def __call__(self, x):
        if random.random() < self.execution_probability:
            sigma = random.uniform(self.sigma[0], self.sigma[1])
            # skimage.filters.gaussian == scipy gaussian_filter with
            # 'nearest' boundary and float output
            return gaussian_filter(x.astype(np.float64), sigma=sigma,
                                   mode="nearest")
        return x


class ToArray:
    """Terminal stage: cast to a contiguous float array
    (replaces the reference's torch ToTensor)."""

    def __init__(self, expand_dims: bool, dtype: str = "float32", **kw):
        self.expand_dims = expand_dims
        self.dtype = dtype

    def __call__(self, m):
        assert m.ndim in (3, 4)
        if self.expand_dims and m.ndim == 3:
            m = np.expand_dims(m, axis=0)
        return np.ascontiguousarray(m, dtype=self.dtype)


class Identity:
    def __init__(self, **kw):
        pass

    def __call__(self, m):
        return m


_TRANSFORMS = {
    "RandomFlip": RandomFlip, "RandomRotate90": RandomRotate90,
    "RandomRotate": RandomRotate, "RandomContrast": RandomContrast,
    "ElasticDeformation": ElasticDeformation, "ResizeCrop": ResizeCrop,
    "CropToFixed": CropToFixed, "Standardize": Standardize,
    "PercentileNormalizer": PercentileNormalizer, "Normalize": Normalize,
    "AdditiveGaussianNoise": AdditiveGaussianNoise,
    "AdditivePoissonNoise": AdditivePoissonNoise,
    "GaussianBlur3D": GaussianBlur3D, "ToTensor": ToArray,
    "ToArray": ToArray, "Identity": Identity,
}


class Transformer:
    """Build Compose pipelines from config with shared per-call seeds
    (reference: transforms.py:729-769)."""

    def __init__(self, phase_config: Dict, base_config: Optional[Dict] = None):
        self.phase_config = phase_config
        self.config_base = dict(base_config or {})
        self.seed = GLOBAL_RANDOM_STATE.randint(10000000)

    def raw_transform(self) -> Compose:
        return self._create_transform("raw")

    def label_transform(self) -> Compose:
        return self._create_transform("label")

    def _create_transform(self, name: str, keep_seed: bool = True) -> Compose:
        assert name in self.phase_config, f"Could not find {name} transform"
        stages = []
        for cls_name, opts in self.phase_config[name].items():
            opts = dict(opts)
            if not opts.pop("enabled", True):
                continue
            config = dict(self.config_base)
            config.update(opts)
            if keep_seed:
                config["random_state"] = np.random.RandomState(self.seed)
            else:
                config["random_state"] = np.random.RandomState(
                    np.random.randint(10000000))
            stages.append(_TRANSFORMS[cls_name](**config))
        return Compose(stages)
