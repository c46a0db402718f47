"""Batch iterators feeding the device.

Replaces the reference's torch DataLoader stack (reference:
data/__init__.py:61-92, data/utils.py:218-308) with plain-numpy batch
assembly + a single background prefetch thread; device placement (with
optional mesh sharding) happens at the train-loop boundary via
the trainer.

The port's own copy of ``afcm_tpu/data/loader.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import queue
import random as _random
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from .h5_dataset import CmsrDataset, StandardHDF5Dataset


def _stack(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples], axis=0)
    return out


class TrainLoader:
    """Shuffled epoch iterator over a CmsrDataset yielding stacked batches."""

    def __init__(self, dataset: CmsrDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)
        self._pyrng = _random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        limit = len(self) * self.batch_size if self.drop_last else len(order)
        get_batch = getattr(self.dataset, "get_batch", None)
        for start in range(0, limit, self.batch_size):
            idxs = order[start:start + self.batch_size]
            if get_batch is not None:
                batch = get_batch([int(i) for i in idxs], rng=self._pyrng)
                if batch is not None:
                    yield batch
                    continue
            samples = [self.dataset.get_item(int(i), rng=self._pyrng)
                       for i in idxs]
            yield _stack(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._epoch_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def _put(item) -> bool:
            # bounded put that aborts when the consumer abandoned the
            # iterator (e.g. train.py's max_iters break) — otherwise the
            # worker would block in q.put forever, leaking the thread and
            # pinning the queued batches for the life of the process.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._epoch_batches():
                    if not _put(batch):
                        return
            except BaseException as exc:  # propagate to consumer
                error.append(exc)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()        # unblock + retire the worker on early exit
            t.join()
        if error:
            raise error[0]


class TestLoader:
    """Sequential batches of (A, slice_idx, raw_index) for one subject
    (reference: data/utils.py:265-324)."""

    __test__ = False  # not a pytest class

    def __init__(self, dataset, batch_size: int,
                 transfer_dtype: str = "float32"):
        self.dataset = dataset
        self.batch_size = batch_size
        # uint8 transfer (tpu.transfer_dtype): yield raw byte windows and let
        # the jitted forward normalize on device (4x less host->device
        # traffic). norm_range doubles as the mode flag consumers check.
        self.norm_range = None
        if transfer_dtype == "uint8":
            raw = getattr(dataset, "raw", None)
            vol = next(iter(raw.values())) if raw else None
            if (getattr(dataset, "_norm_range", None) is not None
                    and vol is not None and vol.dtype == np.uint8):
                self.norm_range = dataset._norm_range

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        get = (self.dataset.get_item_raw if self.norm_range is not None
               else self.dataset.get_item)
        for start in range(0, len(self.dataset), self.batch_size):
            items = [get(i)
                     for i in range(start, min(start + self.batch_size,
                                               len(self.dataset)))]
            a = np.stack([it[0] for it in items], axis=0)
            slice_idx = np.stack([it[1] for it in items], axis=0)
            indices = [it[2] for it in items]
            yield a, slice_idx, indices


def create_dataset(loaders_config, phase: str, direction: str = "AtoB",
                   input_nc: int = 1, output_nc: int = 1):
    """Dataset factory by ``loaders.dataset_mode``
    (reference: data/__init__.py:18-58 find_dataset_using_name — the closed
    set here covers every dataset the reference ships: the h5/NII volume
    pipelines plus the legacy pix2pix image-folder datasets).

    ``direction``/``input_nc``/``output_nc`` only matter for the aligned/
    single image-folder modes (the reference reads them from the top-level
    opt, aligned_dataset.py); volume datasets ignore them."""
    mode = loaders_config.get("dataset_mode", "cmsr")
    if mode == "cmsr":
        return CmsrDataset(loaders_config, phase=phase,
                           dataset_cls=StandardHDF5Dataset)
    if mode == "cmsrnii":
        from .nii_dataset import StandardNIIDataset
        return CmsrDataset(loaders_config, phase=phase,
                           dataset_cls=StandardNIIDataset)
    if mode in ("aligned", "unaligned", "single", "template"):
        raise NotImplementedError(
            f"dataset_mode {mode}: the pix2pix image-folder datasets and the "
            "template dataset are not ported yet (ROADMAP item A11)")
    raise NotImplementedError(f"dataset_mode {mode}")


def get_train_loaders(cfg, seed: int = 0) -> Dict[str, TrainLoader]:
    loaders_config = cfg.loaders
    # image-folder modes read direction / channel counts from the top-level
    # config like the reference (aligned_dataset.py, base_options)
    kw = dict(direction=getattr(cfg, "direction", "AtoB"))
    g_cfg = getattr(getattr(cfg, "model", None), "G", None)
    if g_cfg is not None:
        kw["input_nc"] = getattr(g_cfg, "input_nc", 1)
        kw["output_nc"] = getattr(g_cfg, "output_nc", 1)
    train = TrainLoader(create_dataset(loaders_config, "train", **kw),
                        batch_size=loaders_config.batch_size,
                        shuffle=not loaders_config.serial_batches, seed=seed)
    val = TrainLoader(create_dataset(loaders_config, "val", **kw),
                      batch_size=loaders_config.batch_size, shuffle=False,
                      seed=seed, drop_last=False)
    return {"train": train, "val": val}


def get_test_loaders(cfg) -> Iterator[TestLoader]:
    """Lazy per-subject TestLoader generator
    (reference: data/utils.py:265-308)."""
    loaders_config = cfg.loaders
    mode = loaders_config.get("dataset_mode", "cmsr")
    if mode == "cmsr":
        dataset_cls = StandardHDF5Dataset
    elif mode == "cmsrnii":
        from .nii_dataset import StandardNIIDataset
        dataset_cls = StandardNIIDataset
    else:
        raise NotImplementedError(f"dataset_mode {mode}")
    transfer_dtype = "float32"
    tpu_cfg = getattr(cfg, "tpu", None)
    if tpu_cfg is not None:
        transfer_dtype = tpu_cfg.get("transfer_dtype", "float32")
    datasets = dataset_cls.create_datasets(loaders_config, phase="test")
    for ds in datasets:
        yield TestLoader(ds, batch_size=loaders_config.batch_size,
                         transfer_dtype=transfer_dtype)
