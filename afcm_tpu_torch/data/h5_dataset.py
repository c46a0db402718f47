"""h5 volume datasets with 4-slice window assembly
(reference: data/cmsr_dataset.py).

The continuous slice-thickness conditioning works as follows (reference:
cmsr_dataset.py:98-155): for output slice index ``idx`` and thickness ``t``,
the input window is the four thick slices ``[idx_A - t, idx_A, idx_A + t,
idx_A + 2t]`` around ``idx_A = (idx // t) * t`` (zero where out of range),
and the condition is the fractional position ``(idx - idx_A) / t`` in [0, 1).
This lets one generator synthesize arbitrary intermediate slices — including
non-integer thickness factors.

Fast path: when the transform pipeline is the standard
``Normalize -> ToArray`` chain, volumes are normalized once at load time and
window assembly is pure index gathering — no per-sample python transform
stack in the hot loop.

The port's own copy of ``afcm_tpu/data/h5_dataset.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import glob
import os
import random as _random
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .slice_builder import get_slice_builder
from .transforms import Compose, CropToFixed, Normalize, ToArray, Transformer


def calculate_stats(images) -> Dict[str, float]:
    """Global percentiles / moments over a dict of volumes
    (reference: data/utils.py:327-336)."""
    flat = np.concatenate([np.asarray(img).ravel() for img in images])
    return {"pmin": np.percentile(flat, 1), "pmax": np.percentile(flat, 99.6),
            "mean": np.mean(flat), "std": np.std(flat)}


def get_cls_label(shape, idx):
    onehot = np.zeros(shape, dtype=np.float32)
    onehot[idx] = 1
    return onehot.copy()


def _is_standard_pipeline(phase_transformer_cfg: Dict) -> Optional[Tuple[float, float]]:
    """Detect the Normalize -> ToTensor standard chain; return its range."""
    enabled = [(name, dict(opts)) for name, opts in phase_transformer_cfg.items()
               if dict(opts).get("enabled", True)]
    names = [n for n, _ in enabled]
    if names in (["Normalize", "ToTensor"], ["Normalize", "ToArray"]):
        opts = dict(enabled[0][1])
        return float(opts["min_value"]), float(opts["max_value"])
    return None


class AbstractVolumeDataset:
    """One subject: multi-modality volume dict + slice-window sampling."""

    def __init__(self, file_path: str, phase: str, slice_builder_config,
                 transformer_config, raw_internal_path_in=("raw",),
                 raw_internal_path_out=("raw",), rand_output: bool = False,
                 cat_inputs: bool = False, thickness: Sequence[int] = (),
                 slice_num: int = 4, global_normalization=True,
                 mirror_padding=None):
        assert phase in ("train", "val", "test")
        self.phase = phase
        self.file_path = file_path
        self.raw_internal_path_in = list(raw_internal_path_in)
        self.raw_internal_path_out = list(raw_internal_path_out)
        self.rand_output = rand_output
        self.cat_inputs = cat_inputs
        self.thickness = list(thickness)
        self.slice_num = slice_num
        self.mirror_padding = mirror_padding
        raw_internal_path = list(dict.fromkeys(
            self.raw_internal_path_in + self.raw_internal_path_out))
        self.raw_internal_path = raw_internal_path

        input_file = self.load_volumes(file_path)
        self.raw = {p: self._ensure_3d(input_file[p]) for p in raw_internal_path}

        if global_normalization:
            self.stats = calculate_stats(list(self.raw.values()))
        else:
            self.stats = {"pmin": None, "pmax": None, "mean": None, "std": None}

        # Normalize H, W to the patch shape (reference: cmsr_dataset.py:72-74).
        crop = CropToFixed(None, size=slice_builder_config["patch_shape"][1:],
                           centered=True, mode="constant")
        for key in self.raw:
            self.raw[key] = crop(self.raw[key])

        self.transformer = Transformer(transformer_config, self.stats)
        self._norm_range = _is_standard_pipeline(transformer_config["raw"])
        self._norm_cache = None  # lazy float copies; see _norm property

        slice_builder = get_slice_builder(
            self.raw[raw_internal_path[-1]], None, None, slice_builder_config)
        self.raw_slices = slice_builder.raw_slices
        self.patch_count = len(self.raw_slices)

    @staticmethod
    def _ensure_3d(ds):
        ds = np.asarray(ds)
        if ds.ndim == 2:
            ds = ds[None]
        return ds

    def load_volumes(self, file_path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.patch_count

    # -- sampling ------------------------------------------------------------

    def _pick_thickness(self, rng: _random.Random) -> int:
        if self.thickness:
            if self.phase == "train":
                return rng.choice(self.thickness)
            return self.thickness[0]
        return -1

    def _pick_modalities(self, rng: _random.Random):
        if self.phase == "train" and self.rand_output:
            modality_b = rng.choice(self.raw_internal_path_out)
        else:
            modality_b = self.raw_internal_path_out[-1]
        if self.cat_inputs:
            modality_as = [x for x in self.raw_internal_path_in if x != modality_b]
        else:
            modality_as = [self.raw_internal_path_in[0]]
        return modality_as, modality_b

    def _window_indices(self, idx: int, thickness: int):
        """The four thick-slice indices (None = zero pad) + anchor idx_A."""
        idx_a = int((idx // thickness) * thickness)
        out = [idx_a - thickness if idx_a - thickness >= 0 else None,
               idx_a,
               idx_a + thickness if idx_a + thickness <= self.patch_count - 1 else None,
               idx_a + 2 * thickness if idx_a + 2 * thickness <= self.patch_count - 1 else None]
        return out, idx_a

    def get_item(self, idx: int, rng: Optional[_random.Random] = None) -> Dict:
        rng = rng or _random
        thickness = self._pick_thickness(rng)
        modality_as, modality_b = self._pick_modalities(rng)

        data_a: List[np.ndarray] = []
        idx_a = idx
        fast = self._norm_range is not None
        for modality_a in modality_as:
            vol = self._norm[modality_a] if fast else self.raw[modality_a]
            if self.slice_num == 1:
                idx_a = idx
                data_a.append(self._slice(vol, self.raw_slices[idx], fast))
            elif self.slice_num == 4:
                window, idx_a = self._window_indices(idx, thickness)
                for w in window:
                    if w is not None:
                        data_a.append(self._slice(vol, self.raw_slices[w], fast))
                    else:
                        zero = np.zeros_like(vol[0:1], dtype=np.float32)
                        data_a.append(self._apply_transform(zero) if not fast
                                      else self._normalize_zeros(zero))
            else:
                raise NotImplementedError(
                    f"slice number {self.slice_num} not supported")

        sample = {"A": np.concatenate(data_a, axis=0)}
        slice_idx = np.array([idx - idx_a], dtype=np.float32) / thickness
        if self.phase != "test":
            vol_b = self._norm[modality_b] if fast else self.raw[modality_b]
            sample["B"] = self._slice(vol_b, self.raw_slices[idx], fast)
            sample["B_class"] = get_cls_label(len(self.raw_internal_path_out),
                                              len(self.raw_internal_path_out) - 1)
            sample["B_idx"] = np.array([idx], dtype=np.float32)
            sample["slice_idx"] = slice_idx
            return sample
        return sample["A"], slice_idx, self.raw_slices[idx]

    def get_item_raw(self, idx: int):
        """Test-phase window in the volume's stored dtype (uint8), for
        device-side normalization: the Normalize->[-1,1] chain moves into the
        jitted forward (evaluate.make_forward_fn) so each patch crosses
        host->device at 1 byte/voxel instead of 4. Only valid when the
        standard Normalize->ToTensor pipeline was detected (``_norm_range``);
        window assembly mirrors ``get_item`` exactly — zero-filled edge
        slices are raw value 0, which normalizes to the same clipped value
        as the float path's ``_normalize_zeros``."""
        assert self.phase == "test" and self._norm_range is not None
        thickness = self._pick_thickness(_random)
        modality_as, _ = self._pick_modalities(_random)
        data_a: List[np.ndarray] = []
        idx_a = idx
        for modality_a in modality_as:
            vol = self.raw[modality_a]
            if self.slice_num == 1:
                data_a.append(np.ascontiguousarray(vol[self.raw_slices[idx]]))
            elif self.slice_num == 4:
                window, idx_a = self._window_indices(idx, thickness)
                for w in window:
                    if w is not None:
                        data_a.append(np.ascontiguousarray(
                            vol[self.raw_slices[w]]))
                    else:
                        data_a.append(np.zeros_like(vol[0:1]))
            else:
                raise NotImplementedError(
                    f"slice number {self.slice_num} not supported")
        a = np.concatenate(data_a, axis=0)
        slice_idx = np.array([idx - idx_a], dtype=np.float32) / thickness
        return a, slice_idx, self.raw_slices[idx]

    # -- native batch fast path ---------------------------------------------

    def _full_plane_slices(self) -> bool:
        """True when every patch is a full z-slice (the shipped-config case),
        enabling the native window-gather fast path."""
        ref = self.raw[self.raw_internal_path[-1]]
        if len(self.raw_slices) != ref.shape[0]:
            return False
        first = self.raw_slices[0]
        return (first[1].stop - first[1].start == ref.shape[1] and
                first[2].stop - first[2].start == ref.shape[2])

    def get_batch(self, indices, rng=None):
        """Assemble a whole batch with the native gather when eligible;
        semantics identical to stacking `get_item` results."""
        rng = rng or _random
        # dtype guard: the native gather reads raw bytes (assemble_windows
        # coerces to uint8) — non-uint8-stored volumes must take the
        # per-item float path, same as TestLoader's per-volume decision
        # (loader.py:111-113).
        if (self._norm_range is None or self.slice_num != 4 or
                self.cat_inputs or not self._full_plane_slices() or
                any(v.dtype != np.uint8 for v in self.raw.values())):
            return None
        from ..native import assemble_windows
        lo, hi = self._norm_range

        n = len(indices)
        win_a = np.empty((n, 4), dtype=np.int32)
        win_b = np.empty((n, 1), dtype=np.int32)
        slice_idx = np.empty((n, 1), dtype=np.float32)
        mods_a, mods_b = [], []
        for i, idx in enumerate(indices):
            thickness = self._pick_thickness(rng)
            modality_as, modality_b = self._pick_modalities(rng)
            window, idx_a = self._window_indices(idx, thickness)
            win_a[i] = [(-1 if z is None else z) for z in window]
            win_b[i] = idx
            slice_idx[i, 0] = (idx - idx_a) / thickness
            mods_a.append(modality_as[0])
            mods_b.append(modality_b)

        def gather(mods, windows):
            if len(set(mods)) == 1:
                return assemble_windows(self.raw[mods[0]], windows, lo, hi)
            out = np.empty(windows.shape + self.raw[mods[0]].shape[1:],
                           dtype=np.float32)
            for i, mod in enumerate(mods):
                out[i] = assemble_windows(self.raw[mod], windows[i:i + 1],
                                          lo, hi)[0]
            return out

        batch = {"A": gather(mods_a, win_a), "slice_idx": slice_idx}
        if self.phase != "test":
            batch["B"] = gather(mods_b, win_b)
        return batch

    @property
    def _norm(self):
        """Float32 normalized copies of every modality, built lazily on the
        first slow-path access: the native ``get_batch`` gather and the
        uint8-transfer test path never read them, and building eagerly
        multiplied a uint8 subject's resident RAM ~5x on this
        whole-volume-in-RAM design."""
        if self._norm_cache is None:
            lo, hi = self._norm_range
            self._norm_cache = {k: np.clip(
                2 * ((v.astype(np.float32) - lo) / (hi - lo)) - 1, -1, 1)
                for k, v in self.raw.items()}
        return self._norm_cache

    def _slice(self, vol, raw_idx, fast: bool):
        patch = vol[raw_idx]
        if fast:
            return np.ascontiguousarray(patch, dtype=np.float32)
        return self._apply_transform(np.asarray(patch))

    def _apply_transform(self, patch):
        return self.transformer.raw_transform()(patch)

    def _normalize_zeros(self, zero):
        lo, hi = self._norm_range
        return np.clip(2 * ((zero - lo) / (hi - lo)) - 1, -1, 1).astype(np.float32)

    # -- construction over directories --------------------------------------

    @classmethod
    def create_datasets(cls, loaders_config, phase: str) -> List["AbstractVolumeDataset"]:
        phase_cfg = loaders_config["train"] if phase == "train" else \
            loaders_config.get(phase, loaders_config["test"])
        if phase == "val" and not phase_cfg.get("file_paths"):
            phase_cfg = loaders_config["test"]
        transformer_config = phase_cfg["transformer"] if "transformer" in phase_cfg \
            else loaders_config["test"]["transformer"]
        slice_builder_config = phase_cfg["slice_builder"] if "slice_builder" in phase_cfg \
            else loaders_config["test"]["slice_builder"]
        file_paths = cls.traverse_paths(list(phase_cfg["file_paths"]),
                                        loaders_config)
        datasets = []
        for file_path in file_paths:
            try:
                datasets.append(cls(
                    file_path=file_path, phase=phase,
                    slice_builder_config=slice_builder_config,
                    transformer_config=transformer_config,
                    raw_internal_path_in=loaders_config.get(
                        "raw_internal_path_in", ["raw"]),
                    raw_internal_path_out=loaders_config.get(
                        "raw_internal_path_out", ["raw"]),
                    rand_output=loaders_config.get("rand_output", False),
                    cat_inputs=loaders_config.get("cat_inputs", False),
                    thickness=loaders_config.get("thickness", []),
                    slice_num=loaders_config.get("slice_num", 4),
                    global_normalization=loaders_config.get(
                        "global_normalization", None),
                    mirror_padding=loaders_config.get("mirror_padding")))
            except Exception as exc:  # match reference skip-and-continue
                print(f"Skipping {phase} set {file_path}: {exc!r}")
        return datasets

    @classmethod
    def traverse_paths(cls, file_paths: List[str], loaders_config) -> List[str]:
        results = []
        for file_path in file_paths:
            if os.path.isdir(file_path):
                iters = [glob.glob(os.path.join(file_path, ext))
                         for ext in ("*.h5", "*.hdf", "*.hdf5", "*.hd5")]
                results.extend(sorted(chain(*iters)))
            else:
                results.append(file_path)
        return results


class StandardHDF5Dataset(AbstractVolumeDataset):
    """Whole-volume-in-RAM h5 dataset (reference: cmsr_dataset.py:226-249)."""

    def load_volumes(self, file_path: str) -> Dict[str, np.ndarray]:
        import h5py
        with h5py.File(file_path, "r") as f:
            return {p: f[p][:] for p in self.raw_internal_path}


class CmsrDataset:
    """Concatenation of per-subject datasets (reference: cmsr_dataset.py:252-255)."""

    def __init__(self, loaders_config, phase: str = "train",
                 dataset_cls=StandardHDF5Dataset):
        self.datasets = dataset_cls.create_datasets(loaders_config, phase=phase)
        if not self.datasets:
            raise FileNotFoundError(
                f"no datasets found for phase={phase}: "
                f"{loaders_config.get(phase, loaders_config.get('test'))}")
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def get_item(self, index: int, rng=None):
        ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds_idx].get_item(index - int(self._offsets[ds_idx]),
                                              rng=rng)

    def get_batch(self, indices, rng=None):
        """Batch assembly through the native fast path (grouped by subject);
        returns None when any subject is ineligible so callers fall back."""
        per_ds = {}
        for pos, index in enumerate(indices):
            ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
            local = int(index) - int(self._offsets[ds_idx])
            per_ds.setdefault(ds_idx, []).append((pos, local))

        parts = {}
        for ds_idx, items in per_ds.items():
            batch = self.datasets[ds_idx].get_batch([l for _, l in items],
                                                    rng=rng)
            if batch is None:
                return None
            parts[ds_idx] = (batch, [p for p, _ in items])

        keys = next(iter(parts.values()))[0].keys()
        n = len(indices)
        out = {}
        for key in keys:
            sample = next(iter(parts.values()))[0][key]
            out[key] = np.empty((n,) + sample.shape[1:], dtype=sample.dtype)
            for batch, positions in parts.values():
                for row, pos in enumerate(positions):
                    out[key][pos] = batch[key][row]
        return out
