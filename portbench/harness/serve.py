"""The serving cells: one client submits subjects back to back through the
port's pipelined predictor (``StandardPredictor.run_pipelined``) fed by the
evaluate CLI's forward (``evaluate.make_forward_fn``), as
``serve.serve_subjects`` runs them, minus the NIfTI writes.

The window runs from one subject's yield to the first subject that
completes after the run's seconds, and counts the slices of the subjects
completed in between. A sample of those subjects' stitched volumes, drawn
from the seed with the longest among them, is checked against the plain
reference after the window."""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from afcm_tpu_torch.data.h5_dataset import AbstractVolumeDataset
from afcm_tpu_torch.data.loader import TestLoader
from afcm_tpu_torch.evaluate import build_serving_forward, checkpoint_tag
from afcm_tpu_torch.infer.predictor import StandardPredictor
from afcm_tpu_torch.ops.modulated_conv import set_conv_impl

from .phantoms import draw_pool, sub_seed
from .trace import Spans, traced


class PoolSubject(AbstractVolumeDataset):
    """One subject of the traffic's pool, windowed by the port's dataset
    under the configuration's test settings; ``load_volumes`` hands over
    the pool's arrays in place of an h5 file."""

    def __init__(self, name: str, volumes: Dict[str, np.ndarray], cfg, phase: str = "test"):
        self._volumes = volumes
        loaders = cfg.loaders
        phase_cfg = loaders.test if phase == "test" else loaders.train
        super().__init__(
            name + ".h5", phase, dict(phase_cfg.slice_builder),
            dict(phase_cfg.transformer),
            raw_internal_path_in=list(loaders.raw_internal_path_in),
            raw_internal_path_out=list(loaders.raw_internal_path_out),
            rand_output=loaders.rand_output, cat_inputs=loaders.cat_inputs,
            thickness=list(loaders.thickness), slice_num=loaders.slice_num,
            global_normalization=loaders.global_normalization,
            mirror_padding=loaders.mirror_padding)

    def load_volumes(self, file_path):
        return self._volumes


class BenchPredictor(StandardPredictor):
    """The port's predictor with its NIfTI writes dropped: ``submit_write``
    counts the bytes each write would have put to disk."""

    written_bytes = 0

    def submit_write(self, fn, *args):
        self.written_bytes += int(self.last_prediction.nbytes)


class SpannedLoader:
    """A subject's ``TestLoader`` whose batches are drawn inside the
    benchmark's ``portbench.load`` span."""

    def __init__(self, loader: TestLoader, spans: Spans):
        self._loader, self._spans = loader, spans
        self.dataset, self.batch_size = loader.dataset, loader.batch_size
        self.norm_range = loader.norm_range

    def __iter__(self):
        it = iter(self._loader)
        while True:
            with self._spans("portbench.load"):
                item = next(it, None)
            if item is None:
                return
            yield item


class SpannedResult:
    """A forward's device result whose fetch runs in ``portbench.fetch``."""

    def __init__(self, result, spans: Spans):
        self._result, self._spans = result, spans

    def copy_to_host_async(self):
        self._result.copy_to_host_async()

    def __array__(self, dtype=None, copy=None):
        with self._spans("portbench.fetch"):
            return self._result.__array__(dtype)


def spanned_forward(forward, spans: Spans):
    def run(a_batch, slice_idx):
        with spans("portbench.forward"):
            return SpannedResult(forward(a_batch, slice_idx), spans)
    return run


def subject_stream(pool, cfg, traffic, seed: int, spans: Spans, log: List[dict]):
    """Loaders of pool subjects in a seeded order, forever (each pass over
    the pool a fresh permutation); ``log`` gets one entry per subject made:
    its pool index, depth and batches."""
    rng = np.random.RandomState(sub_seed(seed, 4))
    batch = cfg.loaders.batch_size
    k = 0
    while True:
        for p in rng.permutation(len(pool)):
            depth = pool[p][traffic["modality_in"]].shape[0]
            log.append({"pool": int(p), "depth": int(depth), "batches": -(-depth // batch)})
            loader = TestLoader(PoolSubject(f"subject_{k}", pool[p], cfg), batch,
                                transfer_dtype=cfg.tpu.transfer_dtype)
            k += 1
            yield SpannedLoader(loader, spans)


def save_checkpoint(cfg, weights) -> None:
    """The run's G weights as the checkpoint file the evaluate CLI loads
    (``<checkpoints_dir>/<name>/<tag>_net_G_ema.pth``)."""
    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    torch.save(weights["G"], os.path.join(run_dir, f"{checkpoint_tag(cfg)}_net_G_ema.pth"))


# the seed of the serving forward's z stream (``evaluate.make_forward_fn``'s
# default, which the serve CLI takes)
Z_SEED = 0


class CountedForward:
    """A forward that counts its calls: each call draws the next batch of
    the forward's z stream."""

    def __init__(self, forward):
        self._forward, self.calls = forward, 0

    def __call__(self, a_batch, slice_idx):
        self.calls += 1
        return self._forward(a_batch, slice_idx)


class Clock:
    """Seconds between set-up phases, printed on standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str):
        now = time.perf_counter()
        print(f"portbench: set-up {phase} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, traffic, weights, device, seed: int, seconds: float, out_dir: str,
        trace_path=None, conv_impl=None):
    """Warm up, measure the window, trace the tail when asked; returns the
    window's numbers and what the check needs. ``out_dir`` is the
    predictor's output directory, which stays empty."""
    spans = Spans()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    clock = Clock()
    pool = draw_pool(traffic, seed, device)
    clock("pool")
    try:
        # the serve CLI's forward over the run's weights saved as its
        # checkpoint; the warm-up takes the same forward, code path and shapes
        save_checkpoint(cfg, weights)
        forward = CountedForward(build_serving_forward(cfg, device)[0])
        if conv_impl is not None:
            set_conv_impl(conv_impl, min_ch=cfg.tpu.conv_int8_min_ch)
        clock("model")
        warm = BenchPredictor(spanned_forward(forward, spans), out_dir, cfg,
                              patch_halo=cfg.predictor.patch_halo)
        warm_log: List[dict] = []
        warm_run = warm.run_pipelined(subject_stream(pool, cfg, traffic, seed + 1, spans,
                                                     warm_log))
        for i, _ in enumerate(warm_run):
            if i + 1 >= traffic["warmup_subjects"]:
                break
        warm_run.close()
        sync(device)
        z_skip = forward.calls
        clock("warm-up")

        predictor = BenchPredictor(spanned_forward(forward, spans), out_dir, cfg,
                                   patch_halo=cfg.predictor.patch_halo)
        log: List[dict] = []
        served = predictor.run_pipelined(subject_stream(pool, cfg, traffic, seed, spans, log))
        next(served)                       # the pipeline is full from here on
        clock("first subject")
        t0 = time.perf_counter()
        timings0 = dict(predictor.timings)
        window: List[dict] = []
        t1 = t0
        for k, _ in enumerate(served, start=1):
            t1 = time.perf_counter()
            window.append(dict(log[k], ordinal=k, volume=predictor.last_prediction))
            if t1 - t0 >= seconds:
                break
        timings1 = dict(predictor.timings)
        peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
        result = {"t0": t0, "window_s": t1 - t0,
                  "slices": sum(s["depth"] for s in window),
                  "batches": sum(s["batches"] for s in window),
                  "subjects": window, "log": log, "memory_peak_bytes": peak,
                  "timings": {k: timings1[k] - timings0[k] for k in timings1},
                  "z_seed": Z_SEED, "z_skip": z_skip, "pool": pool}
        if trace_path is not None:
            with traced(trace_path, spans, result):
                for i, _ in enumerate(served, start=1):
                    if i >= traffic["trace_subjects"]:
                        break
        served.close()
        sync(device)
        result["written_bytes"] = predictor.written_bytes
    finally:
        set_conv_impl("xla")       # the knob is this run's, not the process's
    return result
