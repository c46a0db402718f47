"""The training cells: the port's train loop (``train.train`` with its
``on_step`` callback) on ``TrainLoader``s over a seeded pool of phantom
volumes, the run's weights loaded into the model it builds.

Set-up runs the loop's first steps (the steps the check follows, then
warm-up); the window runs from one step's end to the first step's end past
the run's seconds, where the loop is stopped: no checkpoint or validation
runs, and nothing is written. Each step's end is a CUDA event recorded in
``on_step``; nothing synchronizes inside the window."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import afcm_tpu_torch.train as port_train
from afcm_tpu_torch.data.h5_dataset import CmsrDataset
from afcm_tpu_torch.data.loader import TrainLoader
from afcm_tpu_torch.ops.modulated_conv import set_conv_impl

from .check import adam_grad_norms, ema_change, step_losses
from .phantoms import draw_pool, sub_seed
from .serve import Clock, PoolSubject, sync
from .trace import Spans, traced


class Pool(CmsrDataset):
    """The port's concatenation of subjects over the traffic's pool."""

    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])


class SpannedTrainLoader:
    """The ``TrainLoader`` handed to ``train.train``: each batch's draw is
    timed (the benchmark's own span around the loader) and, while traced,
    runs inside ``portbench.load``."""

    def __init__(self, loader: TrainLoader, spans: Spans):
        self._loader, self._spans = loader, spans
        self.dataset = loader.dataset
        self.seconds = 0.0
        self.draws = 0

    def __iter__(self):
        it = iter(self._loader)
        try:
            while True:
                t = time.perf_counter()
                with self._spans("portbench.load"):
                    item = next(it, None)
                self.seconds += time.perf_counter() - t
                self.draws += 1
                if item is None:
                    return
                yield item
        finally:
            it.close()


class StopWindow(Exception):
    """Raised from ``on_step`` to end the train loop at the window's end."""


class Steps:
    """``on_step``: records each step's end event, follows the first
    ``check_steps`` steps for the check, opens the window after
    ``warmup_steps`` and stops the loop at its end (and after the traced
    tail)."""

    def __init__(self, traffic, seconds, device, spans, loader, trace_path, result):
        self.traffic, self.seconds, self.device = traffic, seconds, device
        self.spans, self.loader, self.trace_path = spans, loader, trace_path
        self.result = result
        self.model = None
        self.events: List[torch.cuda.Event] = []
        self.t0 = None
        self.tail = None
        self.clock = lambda phase: None

    def record(self):
        if torch.device(self.device).type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)

    def __call__(self, step: int, metrics: Dict[str, torch.Tensor]):
        with self.spans("portbench.on_step"):
            self.record()
            self._follow(step, metrics)
        warm = self.traffic["warmup_steps"]
        if step == warm:
            sync(self.device)
            self.clock(f"{warm} steps")
            self.t0 = time.perf_counter()
            self.first_event = len(self.events) - 1
            self.loader_s0, self.loader_n0 = self.loader.seconds, self.loader.draws
        elif self.t0 is not None and self.tail is None \
                and time.perf_counter() - self.t0 >= self.seconds:
            sync(self.device)
            self._close_window(step)
            if self.trace_path is None:
                raise StopWindow
            self.tail = traced(self.trace_path, self.spans, self.result)
            self.tail.__enter__()
            self.tail_start = step
        elif self.tail is not None and step - self.tail_start >= self.traffic["trace_steps"]:
            self.tail.__exit__(None, None, None)
            raise StopWindow

    def _follow(self, step, metrics):
        checked = self.traffic["check_steps"]
        if step > checked:
            return
        self.result["losses"].append(step_losses(metrics))
        if step == 1:
            grads = adam_grad_norms(self.model.opt_G, self.model.generator, "G")
            grads.update(adam_grad_norms(self.model.opt_D, self.model.discriminator, "D"))
            self.result["grad_norms"] = grads
        if step == checked:
            self.result["change"] = {
                f"{net}.{k}": float((p.detach() - self.start[f"{net}.{k}"]).norm())
                for net, mod in (("G", self.model.generator), ("D", self.model.discriminator))
                for k, p in mod.named_parameters()}
            self.result["change"].update(ema_change(
                self.model.generator_ema,
                {k[2:]: v for k, v in self.start.items() if k.startswith("G.")}))
            del self.start

    def _close_window(self, step):
        t1 = time.perf_counter()
        steps = step - self.traffic["warmup_steps"]
        events = self.events[self.first_event:]
        times = [a.elapsed_time(b) for a, b in zip(events, events[1:])] if events else []
        self.result.update({
            "t0": self.t0, "window_s": t1 - self.t0, "steps": steps, "step_ms": times,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                  if torch.device(self.device).type == "cuda" else 0),
            "loader_s": self.loader.seconds - self.loader_s0,
            "loader_draws": self.loader.draws - self.loader_n0})


def run(cfg, traffic, weights, device, seed: int, seconds: float, trace_path=None,
        conv_impl=None):
    """Set up, run the window (and the traced tail when asked); returns the
    window's numbers and what the check needs."""
    spans = Spans()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    clock = Clock()
    pool = draw_pool(traffic, seed, device)
    clock("pool")
    order_seed = sub_seed(seed, 8)
    cfg.manual_seed = sub_seed(seed, 9)
    subjects = [PoolSubject(f"subject_{i}", v, cfg, phase="train") for i, v in enumerate(pool)]
    train_loader = SpannedTrainLoader(
        TrainLoader(Pool(subjects), batch_size=cfg.loaders.batch_size,
                    shuffle=not cfg.loaders.serial_batches, seed=order_seed), spans)
    val_loader = TrainLoader(Pool(subjects), batch_size=cfg.loaders.batch_size,
                             shuffle=False, drop_last=False)
    result: Dict = {"losses": [], "order_seed": order_seed, "step_seed": cfg.manual_seed,
                    "pool": pool}
    clock("loaders")
    steps = Steps(traffic, seconds, device, spans, train_loader, trace_path, result)
    steps.clock = clock
    build_model = port_train.build_model

    def build_with_weights(cfg_, generator=None):
        """The train CLI's model, with the run's weights (G_ema a copy of G)."""
        clock("train loop entered")
        model = build_model(cfg_, generator=generator)
        model.generator.load_state_dict(weights["G"], strict=True)
        model.generator_ema.load_state_dict(weights["G"], strict=True)
        model.discriminator.load_state_dict(weights["D"], strict=True)
        clock("model")
        steps.model = model
        steps.start = {f"{net}.{k}": p.detach().clone().to(device)
                       for net, state in (("G", weights["G"]), ("D", weights["D"]))
                       for k, p in state.items()}
        return model

    if conv_impl is not None:
        set_conv_impl(conv_impl, min_ch=cfg.tpu.conv_int8_min_ch)
    elif getattr(cfg.tpu, "conv_int8", False):
        set_conv_impl("int8", cfg.tpu.conv_int8_variant, cfg.tpu.conv_int8_min_ch)
    port_train.build_model = build_with_weights
    try:
        port_train.train(cfg, loaders={"train": train_loader, "val": val_loader},
                         device=device, on_step=steps)
    except StopWindow:
        pass
    finally:
        port_train.build_model = build_model
        set_conv_impl("xla")
    sync(device)
    if "window_s" not in result:
        raise RuntimeError("the train loop ended before the window did")
    result["images"] = result["steps"] * cfg.loaders.batch_size
    return result
