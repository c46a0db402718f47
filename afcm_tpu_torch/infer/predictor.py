"""Patch-in / volume-out prediction with overlap averaging
(reference: models/predictor.py).

The jitted EMA generator runs fixed-shape batches on device (ragged final
batches are padded to avoid recompilation); halo removal + overlap-average
accumulation happen host-side in numpy (the patches are full slices in the
shipped configs, so stitching is negligible next to the G forward).

Output heads follow the reference convention the evaluate CLI expects
(reference: evaluate.py:58-60): ``_predictions0`` = model output,
``_predictions2`` = the (center-slice) input; the reference's phantom
``pred_mask`` head 1 — which no shipped model defines — is written as a copy
of head 0 so downstream tooling indexed on three heads keeps working.

The port's own copy of ``afcm_tpu/infer/predictor.py`` (host code, numpy only): the port imports
nothing of the JAX package.

Each phase of the loop (load, dispatch, fetch, stitch, finalize) runs in one
context (``_phase``) that adds its host seconds to ``timings`` and, while a
profiler captures, opens its span (``afcm.serve.<phase>``, the batch's
``#s<subject>.b<batch>``, the subject's ``#s<subject>``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from ..utils.nifti import write_nifti
from ..utils.profiling import profiler_on, span


def remove_halo(patch: np.ndarray, index, shape, patch_halo):
    """Crop `patch_halo` voxels from non-boundary patch edges
    (reference: models/predictor.py:17-51)."""
    assert len(patch_halo) == 3

    def _new_slices(slicing: slice, max_size: int, pad: int):
        if slicing.start == 0:
            p_start, i_start = 0, 0
        else:
            p_start, i_start = pad, slicing.start + pad
        if slicing.stop == max_size:
            p_stop, i_stop = None, max_size
        else:
            # Broken in the reference (predictor.py:35): pad == 0 sets
            # p_stop = 1, cropping an interior patch to one voxel against a
            # full-size index slice (shape-mismatch crash for any overlapping
            # stride with a zero halo component). Fixed to keep the full
            # extent — identical for the only reference-reachable case
            # (single-slice z patches, where slice(0,1) == slice(0,None)) and
            # matching the native stitcher (_accumulate_native).
            p_stop = -pad if pad != 0 else None
            i_stop = slicing.stop - pad
        return slice(p_start, p_stop), slice(i_start, i_stop)

    d, h, w = shape
    i_c, i_z, i_y, i_x = index
    p_c = slice(0, patch.shape[0])
    p_z, i_z = _new_slices(i_z, d, patch_halo[0])
    p_y, i_y = _new_slices(i_y, h, patch_halo[1])
    p_x, i_x = _new_slices(i_x, w, patch_halo[2])
    return patch[(p_c, p_z, p_y, p_x)], (i_c, i_z, i_y, i_x)


def _slice_from_pad(pad: int) -> slice:
    return slice(None, None) if pad == 0 else slice(pad, -pad)


def subject_id(file_path) -> str:
    """Subject name from a dataset file path: the basename up to the first
    dot (handles both ``sub.h5`` and ``sub.nii.gz``). The single source for
    the name the predictor writes, serve logs, and evaluate scores under."""
    return os.path.basename(str(file_path)).split(".")[0]


class StandardPredictor:
    """Run a forward fn over a subject's patches and stitch the volume."""

    def __init__(self, forward_fn: Callable, output_dir: str, config,
                 patch_halo: Sequence[int] = (0, 8, 8), out_channels: int = 1,
                 output_heads: int = 3, **kwargs):
        """
        Args:
          forward_fn: (a_batch [N,C,H,W] float32, slice_idx [N,1]) -> fake_B
            array [N,1,H,W] (numpy, or a device result with ``__array__``);
            typically the EMA generator.
          output_dir: where the per-head NIfTI files go.
          config: full config tree (used for halo validation).
        """
        self.forward_fn = forward_fn
        self.output_dir = output_dir
        self.config = config
        self.patch_halo = tuple(patch_halo)
        self.out_channels = out_channels
        self.output_heads = output_heads
        # per-phase host seconds (``_phase``), read by the benchmark's
        # predictor_* metrics (portbench/metrics/)
        self.timings = {"load": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "stitch": 0.0, "save": 0.0}
        self._subjects = 0
        self._writer: Optional[ThreadPoolExecutor] = None
        self._write_futures: list = []
        # finalized head-0 volume of the most recent subject (numpy, float32)
        self.last_prediction: Optional[np.ndarray] = None
        self._last_out_path: Optional[str] = None

    def __call__(self, test_loader) -> str:
        """Predict + stitch one subject; returns the head-0 NIfTI path.

        Writes are queued on a background thread (write-behind): the
        returned path — and the other heads' files — are only guaranteed
        on disk after ``wait_for_writes()``. The stitched head-0 volume is
        immediately available in memory as ``self.last_prediction``.
        """
        for _ in self.run_pipelined([test_loader]):
            pass
        return self._last_out_path

    def run_pipelined(self, loaders: Iterable, depth: Optional[int] = None):
        """Drive a sequence of subject loaders through ONE continuous
        device stream; yields each subject's loader after its volume is
        stitched (``self.last_prediction``) and its writes are queued.

        ``depth`` batches stay in flight after every fetch (depth+1
        transiently between a dispatch and the paired fetch; JAX dispatch
        is async and the ``np.asarray`` fetch is the sync point), so the
        device keeps working across subject boundaries — through the
        previous subject's finalize/save, the next subject's h5 open +
        slice building, and whatever per-subject host work the consumer
        does between yields. ``depth=None`` reads ``tpu.pipeline_depth``
        from the predictor's config (default 4); 0 disables pipelining.
        The reference runs subjects strictly serially
        (reference: evaluate.py:49-66); overlap-add stitching is
        order-independent so the pipelined result is identical.
        """
        if depth is None:
            depth = self._config_depth()

        def _stream():
            for loader in loaders:
                ctx = self._new_subject(loader)
                for item in loader:
                    yield ctx, item
                yield ctx, None  # end-of-subject marker (FIFO => in order)

        pending: deque = deque()
        stream = _stream()
        exhausted = False
        in_flight = 0  # real (non-marker) batches dispatched but not fetched
        while not exhausted or pending:
            if not exhausted:
                with self._phase("load", "afcm.serve.load"):
                    nxt = next(stream, None)
                if nxt is None:
                    exhausted = True
                    continue  # drain loop below takes over
                ctx, item = nxt
                if item is None:
                    pending.append((ctx, None))
                else:
                    ctx.batches += 1
                    with self._phase("dispatch", "afcm.serve.dispatch",
                                     ctx.index, ctx.batches - 1):
                        pending.append((ctx, self._dispatch(ctx, item)))
                    in_flight += 1
            # Finalize any subject whose last batch has been fetched
            # (markers never count against depth — they hold no device work).
            while pending and pending[0][1] is None:
                mctx, _ = pending.popleft()
                with self._phase("save", "afcm.serve.finalize", mctx.index):
                    self._finalize_subject(mctx)
                yield mctx.loader
            if pending and (in_flight > depth or exhausted):
                ctx, entry = pending.popleft()
                in_flight -= 1
                self._fetch_and_stitch(ctx, entry)

    @contextlib.contextmanager
    def _phase(self, key: str, name: str, subject: Optional[int] = None,
               batch: Optional[int] = None):
        """One phase of the loop: its host seconds go to ``timings[key]``,
        and while a profiler captures it runs in the span ``name``."""
        ident = None
        if subject is not None and profiler_on():
            ident = f"s{subject}" if batch is None else f"s{subject}.b{batch}"
        t0 = time.perf_counter()
        try:
            with span(name, ident):
                yield
        finally:
            self.timings[key] += time.perf_counter() - t0

    def _config_depth(self) -> int:
        try:
            return int(self.config.tpu.pipeline_depth)
        except (AttributeError, TypeError):
            return 4

    def _new_subject(self, test_loader) -> SimpleNamespace:
        """Allocate the per-subject stitching state."""
        dataset = test_loader.dataset
        volume_shape = self._volume_shape(dataset)
        if self.config is not None:
            self._validate_halo(self.patch_halo,
                                dict(self.config.loaders.test.slice_builder))
        maps_shape = (self.out_channels,) + tuple(volume_shape)
        heads = self.output_heads
        self._subjects += 1
        # Head 1 (the reference's phantom ``pred_mask``) is by construction
        # identical to head 0 (see _stitch) — it is never
        # accumulated and its file is written as a copy of head 0's.
        return SimpleNamespace(
            loader=test_loader, dataset=dataset, volume_shape=volume_shape,
            batch_size=test_loader.batch_size, index=self._subjects - 1, batches=0,
            prediction_maps=[None if h == 1 else np.zeros(maps_shape,
                                                          np.float32)
                             for h in range(heads)],
            normalization_masks=[None if h == 1 else np.zeros(maps_shape,
                                                              np.uint16)
                                 for h in range(heads)])

    def _dispatch(self, ctx, item):
        a_batch, slice_idx, indices = item
        n = a_batch.shape[0]
        if n < ctx.batch_size:  # pad ragged tail to keep the jit shape static
            pad = ctx.batch_size - n
            a_batch = np.concatenate(
                [a_batch, np.repeat(a_batch[-1:], pad, axis=0)], axis=0)
            slice_idx = np.concatenate(
                [slice_idx, np.repeat(slice_idx[-1:], pad, axis=0)], axis=0)
        out = self.forward_fn(a_batch, slice_idx)
        try:
            # Start the device->host copy as soon as the (async-dispatched)
            # forward finishes, so the later np.asarray fetch finds the
            # bytes already streamed instead of paying transfer latency.
            out.copy_to_host_async()
        except AttributeError:  # a forward_fn that returns host arrays
            pass
        return out, a_batch, n, indices, ctx.batches - 1

    def _fetch_and_stitch(self, ctx, entry):
        out_dev, a_batch, n, indices, batch = entry
        with self._phase("fetch", "afcm.serve.fetch", ctx.index, batch):
            # bf16 fetch (tpu.fetch_dtype) arrives as ml_dtypes bfloat16;
            # stitching accumulates float32 either way.
            predictions = np.asarray(out_dev)[:n]
            if predictions.dtype != np.float32:
                predictions = predictions.astype(np.float32)
        with self._phase("stitch", "afcm.serve.stitch", ctx.index, batch):
            self._stitch(ctx, predictions, a_batch, n, indices)

    def _stitch(self, ctx, predictions, a_batch, n, indices):
        if predictions.ndim == 4:  # 2-D model output -> add depth axis
            predictions = predictions[:, :, None]  # [N, C, 1, H, W]

        # input head: the center slice of the 4-slice window
        if a_batch.shape[1] > 1:
            inputs = a_batch[:n, 1:2]
        else:
            inputs = a_batch[:n]
        if a_batch.dtype == np.uint8:
            # uint8-transfer loaders (TestLoader.norm_range) ship raw
            # bytes; the written input head must match the float path.
            lo, hi = ctx.loader.norm_range
            inputs = np.clip(
                2 * ((inputs.astype(np.float32) - lo) / (hi - lo)) - 1,
                -1, 1)
        inputs = inputs[:, :, None]

        per_head = [predictions, predictions, inputs][:self.output_heads]
        for pred_batch, pmap, nmask in zip(
                per_head, ctx.prediction_maps, ctx.normalization_masks):
            if pmap is None:  # head 1: written as a copy of head 0
                continue
            if self._accumulate_native(pred_batch, indices, ctx.volume_shape,
                                       pmap, nmask):
                continue
            for pred, index in zip(pred_batch, indices):
                index = (slice(0, self.out_channels),) + tuple(index)
                u_pred, u_index = remove_halo(pred, index, ctx.volume_shape,
                                              self.patch_halo)
                pmap[u_index] += u_pred
                nmask[u_index] += 1

    def _finalize_subject(self, ctx):
        self._last_out_path = self._save_results(
            ctx.prediction_maps, ctx.normalization_masks, ctx.dataset)
        return self._last_out_path

    def _accumulate_native(self, pred_batch, indices, volume_shape, pmap,
                           nmask) -> bool:
        """Batch overlap-add through the C++ stitcher for the common case:
        1-channel, single-z-slice patches."""
        pred_batch = np.asarray(pred_batch)
        if (self.out_channels != 1 or pred_batch.shape[1] != 1 or
                pred_batch.shape[2] != 1 or self.patch_halo[0] != 0):
            return False
        from ..native import accumulate_patches
        d, h, w = volume_shape
        n = pred_batch.shape[0]
        coords = np.empty((n, 3), np.int32)
        offsets = np.empty((n, 2), np.int32)
        sizes = np.empty((n, 2), np.int32)
        hy, hx = self.patch_halo[1], self.patch_halo[2]
        for b, index in enumerate(indices):
            z_sl, y_sl, x_sl = index
            if z_sl.stop - z_sl.start != 1:
                return False
            oy = 0 if y_sl.start == 0 else hy
            ox = 0 if x_sl.start == 0 else hx
            y1 = y_sl.stop if y_sl.stop == h else y_sl.stop - hy
            x1 = x_sl.stop if x_sl.stop == w else x_sl.stop - hx
            coords[b] = (z_sl.start, y_sl.start + oy, x_sl.start + ox)
            offsets[b] = (oy, ox)
            sizes[b] = (y1 - (y_sl.start + oy), x1 - (x_sl.start + ox))
        accumulate_patches(pmap[0], nmask[0],
                           pred_batch[:, 0, 0], coords, offsets, sizes)
        return True

    @staticmethod
    def _volume_shape(dataset):
        raw = next(iter(dataset.raw.values()))
        return raw.shape if raw.ndim == 3 else raw.shape[1:]

    def _save_results(self, prediction_maps, normalization_masks, dataset):
        os.makedirs(self.output_dir, exist_ok=True)
        base = subject_id(dataset.file_path)
        out_paths = [os.path.join(self.output_dir,
                                  f"{base}_predictions{i}.nii.gz")
                     for i in range(len(prediction_maps))]

        def _finalize(pmap, nmask):
            out = pmap / np.maximum(nmask, 1)
            if getattr(dataset, "mirror_padding", None) is not None:
                z_s, y_s, x_s = [_slice_from_pad(p)
                                 for p in dataset.mirror_padding]
                out = out[:, z_s, y_s, x_s]
            return np.squeeze(out)

        # All head files go to a single background writer so the gzip cost
        # overlaps the next subject's device forward (the host sits idle in
        # the fetch wait otherwise — 1-core box). The finalized head-0 volume
        # stays available in memory as `last_prediction` (bit-identical to
        # the float32 write->read roundtrip); callers that read the FILES
        # must call wait_for_writes() first.
        self.last_prediction = _finalize(prediction_maps[0],
                                         normalization_masks[0])
        self.submit_write(write_nifti, out_paths[0], self.last_prediction)
        for i in range(1, len(prediction_maps)):
            if prediction_maps[i] is None:  # head 1 == head 0 byte-for-byte
                self.submit_write(shutil.copyfile, out_paths[0], out_paths[i])
            else:
                self.submit_write(write_nifti, out_paths[i],
                                  _finalize(prediction_maps[i],
                                            normalization_masks[i]))
        return out_paths[0]

    def submit_write(self, fn, *args):
        """Queue an IO task on the predictor's single background writer
        (ordered; use wait_for_writes() as the barrier)."""
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1)
        self._write_futures.append(self._writer.submit(fn, *args))

    def wait_for_writes(self):
        """Block until all background head writes land (re-raises errors)."""
        futures, self._write_futures = self._write_futures, []
        for f in futures:
            f.result()

    @staticmethod
    def _validate_halo(patch_halo, slice_builder_config):
        patch = slice_builder_config["patch_shape"]
        stride = slice_builder_config["stride_shape"]
        overlap = np.subtract(patch, stride)
        assert np.all(overlap - np.asarray(patch_halo) >= 0), \
            f"Not enough patch overlap for stride {stride} and halo {patch_halo}"


_PREDICTORS = {"StandardPredictor": StandardPredictor}


def get_predictor(name: str):
    return _PREDICTORS[name]
