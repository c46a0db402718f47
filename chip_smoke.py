#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace DIR]

Drives the port's main paths — CMSR serving with the shipped ADNI alias-free
generator, and the CMSR training step of that generator and its
discriminator, both at full width and depth (random weights from a seed) —
and checks the hand-written kernels on them, K1 and K2 (the fused filtered
leaky ReLU forward and backward):

1. the device, and nvidia-smi's name and power limit;
2. builds K1 and K2 from csrc/ with nvcc, both at once, and prints the
   build times;
3. K1 against its plain PyTorch version for the four filter variants of the
   generator at full-size layer shapes (batch 2): fp32 with TF32 off within
   1e-4 * max|plain| + 1e-4, bf16 at PSNR >= 38 dB against fp32 plain; both
   timed with CUDA events;
4. the full generator at batch 2, fp32, TF32 off: kernel path against the
   plain path within 1e-3 * max|plain|; bf16 against fp32 plain at >= 30 dB;
5. serves an in-memory phantom subject (24 slices of 256^2) through the
   evaluate CLI's own serve-and-score loop (afcm_tpu_torch.evaluate.
   serve_and_score) at batch 16 in bf16 and fp32: the stitched volume is
   finite and of the right shape, PSNR/SSIM are finite, and K1 launched
   exactly 28 times per batch;
6. times the generator forward at bf16 b16, bf16 b32 and fp32 b16 (median of
   3 windows and the spread). With --trace DIR it also traces each leg with
   torch.profiler and writes the gzipped chrome trace and a breakdown
   (summary_<leg>.json) under DIR: device time by kernel, K1's time per
   layer, and the device-busy share of the traced window;
7. training: (a) K2 against its plain version (autograd of the plain
   composition) at the four variant shapes, batch 2, fp32 with TF32 off
   within 1e-4 * max|plain| + 1e-4 and bf16 at PSNR >= 38 dB, both timed;
   if some pixel misses, the pixels whose pre-activation sits within
   rounding of the leaky ReLU's kink (slope_ambiguous, at most 5%) are
   counted and held to no bound, the rest are; (b) the
   gradients of one scalar loss for every generator parameter at batch 2,
   fp32, TF32 off: kernel path against plain path within
   1e-3 * max|plain| per tensor, 28 K2 launches; (c) the train CLI's own
   loop (afcm_tpu_torch.train.train) on the shipped CMSR config over a
   phantom subject: bf16 b16, shared G forward, R1 every step, blur sigma
   10: finite losses, 28 K1 and 28 K2 launches per step, median ms/step
   and img/s over 3 windows with the spread, peak memory; then fp32 b16
   steps and their peak memory (a phase line says so if they do not fit
   the card); (d) the trained EMA generator, saved as
   latest_net_G_ema.pth, served through serve_and_score. With --trace DIR
   one bf16 train step is traced too.

Then prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
Any failure raises and exits non-zero; without CUDA nothing is printed.
Needs torch with CUDA, nvcc, numpy, scipy and yaml (the training config);
no h5py or JAX (it fails if anything loaded jax, flax or optax). It imports
only the port, afcm_tpu_torch, which reuses afcm_tpu's framework-free host
code (config, data, predictor, metrics) by import.
"""

import argparse
import contextlib
import functools
import gzip
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Fails outside a checkout of the repository, before anything is printed.
from afcm_tpu_torch import train as train_cli
from afcm_tpu_torch.data.demo import phantom_test_loader, phantom_train_loaders
from afcm_tpu_torch.evaluate import (load_generator_ema, make_forward_fn,
                                     serve_and_score, set_matmul_precision)
from afcm_tpu_torch.models import CMSR_ADNI_G, build_eval_model, build_generator
from afcm_tpu_torch.ops.cuda import _build
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1

SEED = 0
# One full-size layer per filter variant of the shipped generator: the
# kernel's input is the 3x3 conv's output, layer size + 2.
VARIANT_LAYERS = {
    "A up2/down2 (L12_276_64)": ("decoder", 12),
    "B up2/down4 (encoder_4)": ("encoder", 4),
    "C up4/down2 (L10_276_128)": ("decoder", 10),
    "D crop (L13_256_64)": ("decoder", 13),
}
SERVE_BATCH = 16
LAYERS_WITH_KERNEL = 28        # 29 layers; toRGB is elementwise
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml")
TRAIN_BATCH = 16
WARM_STEPS, WINDOW_STEPS, WINDOWS = 3, 4, 3


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def psnr(got, want):
    err = float(torch.mean((got.float() - want.float()) ** 2))
    data_range = float(want.max() - want.min())
    return 10 * np.log10(data_range ** 2 / max(err, 1e-20))


@contextlib.contextmanager
def plain_filtered_lrelu():
    """Route CUDA tensors through the plain composition: the reference run
    the kernel path is compared with."""
    # the module, not the function that afcm_tpu_torch.ops re-exports
    dispatch = importlib.import_module("afcm_tpu_torch.ops.filtered_lrelu")
    saved = dispatch.filtered_lrelu_cuda
    dispatch.filtered_lrelu_cuda = k1.filtered_lrelu_plain
    try:
        yield
    finally:
        dispatch.filtered_lrelu_cuda = saved


@functools.lru_cache(maxsize=None)
def shipped_model(compute_dtype: str):
    """The shipped ADNI CMSR generator on the card; every dtype gets the
    same random weights, drawn from SEED."""
    model = build_eval_model(CMSR_ADNI_G, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(SEED))
    model.generator_ema.to("cuda")
    return model


def check_variants(device):
    """Phase 3: K1 against its plain version at full-size layer shapes."""
    synthesis = shipped_model("float32").generator_ema.synthesis
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst, total_ms, total_plain_ms = 0.0, 0.0, 0.0
    for label, (side, idx) in VARIANT_LAYERS.items():
        layer = (synthesis.decoders if side == "decoder" else synthesis.encoders)[idx]
        spec = layer.spec
        shape = (2, spec.out_channels, spec.in_size + 2, spec.in_size + 2)
        x = torch.randn(shape, generator=gen, device=device)
        b = torch.randn(shape[1], generator=gen, device=device)
        kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up,
                  down=layer.down, padding=layer.padding, gain=float(np.sqrt(2)),
                  slope=0.2, clamp=layer.conv_clamp)
        set_matmul_precision("float32")
        want = k1.filtered_lrelu_plain(x, b=b, **kw)
        got = k1.filtered_lrelu_cuda(x, b=b, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape[2:] != (spec.out_size,) * 2:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        err = float((got - want).abs().max())
        bound = 1e-4 * float(want.abs().max()) + 1e-4
        xb, bb = x.bfloat16(), b.bfloat16()
        got_bf16 = k1.filtered_lrelu_cuda(xb, b=bb, **kw)
        db = psnr(got_bf16, want)
        row = dict(variant=label, shape=list(shape), out=spec.out_size,
                   fp32_max_abs_err=err, fp32_bound=bound, bf16_psnr_db=db,
                   ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_cuda(x, b=b, **kw)),
                   plain_ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_plain(x, b=b, **kw)),
                   ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_cuda(xb, b=bb, **kw)),
                   plain_ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_plain(xb, b=bb, **kw)))
        phase("3 kernel vs plain", **row)
        if not err <= bound:
            raise AssertionError(f"{label}: fp32 max|diff| {err} > {bound}")
        if not db >= 38:
            raise AssertionError(f"{label}: bf16 PSNR {db:.2f} dB < 38")
        worst = max(worst, err)
        total_ms += row["ms_fp32"]
        total_plain_ms += row["plain_ms_fp32"]
    return worst, total_ms, total_plain_ms


def check_generator(device):
    """Phase 4: the full generator, kernel path against plain path."""
    model = shipped_model("float32")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    z = torch.randn((2, 512), generator=gen, device=device)
    c = torch.rand((2, 1), generator=gen, device=device)
    cond = torch.randn((2, 4, 256, 256), generator=gen, device=device).clamp(-1, 1)
    set_matmul_precision("float32")
    launches = k1.launches
    got = model.eval_step(cond, c, z=z)
    if k1.launches - launches != LAYERS_WITH_KERNEL:
        raise AssertionError(f"{k1.launches - launches} kernel launches in one forward")
    with plain_filtered_lrelu():
        want = model.eval_step(cond, c, z=z)
    if k1.launches - launches != LAYERS_WITH_KERNEL:
        raise AssertionError("the plain run launched the kernel")
    err = float((got - want).abs().max())
    bound = 1e-3 * float(want.abs().max())
    got_bf16 = shipped_model("bfloat16").eval_step(cond, c, z=z)
    db = psnr(got_bf16, want)
    phase("4 generator kernel vs plain", batch=2, shape=list(got.shape),
          fp32_max_abs_err=err, bound=bound, max_abs_plain=float(want.abs().max()),
          bf16_psnr_db=db, finite=bool(torch.isfinite(got).all()))
    if not (torch.isfinite(got).all() and err <= bound):
        raise AssertionError(f"generator fp32 max|diff| {err} > {bound}")
    if not db >= 30:
        raise AssertionError(f"generator bf16 PSNR {db:.2f} dB < 30")


def serve_phantom(device, compute_dtype):
    """Phase 5 (one dtype): the phantom through the evaluate CLI's loop."""
    loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH,
                                 seed=SEED)
    set_matmul_precision(compute_dtype)
    forward = make_forward_fn(shipped_model(compute_dtype), device, seed=SEED,
                              norm_range=loader.norm_range)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        scores = serve_and_score(forward, [loader], out_dir, "t1_hr4sr")
        seconds = time.perf_counter() - t0
    (subject,) = scores["subjects"].values()
    ok = subject["shape"] == (24, 256, 256) and subject["finite"]
    metrics = [scores[k] for k in ("psnr", "ssim", "psnr_slice", "ssim_slice")]
    phase("5 serve phantom", compute_dtype=compute_dtype, batch=SERVE_BATCH,
          batches=len(loader), volume=list(subject["shape"]), finite=ok,
          psnr=metrics[0], ssim=metrics[1], psnr_slice=metrics[2],
          ssim_slice=metrics[3], seconds=seconds,
          slices_per_s=subject["shape"][0] / seconds,
          note="random weights: PSNR/SSIM only prove the path runs")
    if not (ok and np.isfinite(metrics).all()):
        raise AssertionError(f"bad stitched volume {subject} or metrics")
    return len(loader)


def variant_case(label, device, seed):
    """A full-size layer's filter arguments and seeded (x, b) at batch 2."""
    side, idx = VARIANT_LAYERS[label]
    synthesis = shipped_model("float32").generator_ema.synthesis
    layer = (synthesis.decoders if side == "decoder" else synthesis.encoders)[idx]
    spec = layer.spec
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (2, spec.out_channels, spec.in_size + 2, spec.in_size + 2)
    x = torch.randn(shape, generator=gen, device=device)
    b = torch.randn(shape[1], generator=gen, device=device)
    kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up,
              down=layer.down, padding=layer.padding, gain=float(np.sqrt(2)),
              slope=0.2, clamp=layer.conv_clamp)
    return x, b, kw, spec, gen


def check_backward_variants(device):
    """Phase 7a: K2 against its plain version at full-size layer shapes."""
    worst, total_ms, total_plain_ms = 0.0, 0.0, 0.0
    for label in VARIANT_LAYERS:
        x, b, kw, spec, gen = variant_case(label, device, SEED + 3)
        dy = torch.randn((2, spec.out_channels, spec.out_size, spec.out_size),
                         generator=gen, device=device)
        set_matmul_precision("float32")
        want_dx, want_db = k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)
        dx, db = k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)
        torch.cuda.synchronize()
        if dx.shape != x.shape:
            raise AssertionError(f"{label}: dx {tuple(dx.shape)} for x {tuple(x.shape)}")
        # The slope at a pre-activation within rounding of the leaky ReLU's
        # kink is the rounding's choice. If the kernel and the plain version
        # choose differently there, the check holds the other pixels to the
        # bound and counts these, whose dx (and share of db) it takes from
        # the kernel.
        kink = k1.slope_ambiguous(x, b=b, **{k: v for k, v in kw.items()
                                             if k not in ("fd", "down")})
        diff = (dx - want_dx).abs()
        bound = 1e-4 * float(want_dx.abs().max()) + 1e-4
        err_all = float(diff.max())
        db_bound = 1e-4 * float(want_db.abs().max()) + 1e-4
        db_err_all = float((db - want_db).abs().max())
        at_kink = not (err_all <= bound and db_err_all <= db_bound)
        err = float(diff.masked_fill(kink, 0).max()) if at_kink else err_all
        db_err = float((db - want_db - torch.where(kink, dx - want_dx, 0)
                        .sum((0, 2, 3))).abs().max()) if at_kink else db_err_all
        xb, bb, dyb = x.bfloat16(), b.bfloat16(), dy.bfloat16()
        dx_bf16, _ = k1.filtered_lrelu_bwd_cuda(xb, dyb, b=bb, **kw)
        dx_psnr = psnr(dx_bf16, want_dx)
        row = dict(variant=label, x=list(x.shape), dy=list(dy.shape),
                   fp32_dx_max_abs_err=err, dx_bound=bound,
                   fp32_db_max_abs_err=db_err, db_bound=db_bound,
                   kink_pixels=int(kink.sum()), kink_share=float(kink.float().mean()),
                   all_pixels_within_bound=not at_kink,
                   bf16_psnr_db=dx_psnr,
                   ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)),
                   plain_ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)),
                   ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_bwd_cuda(xb, dyb, b=bb, **kw)),
                   plain_ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_bwd_plain(xb, dyb, b=bb, **kw)))
        phase("7a K2 vs plain", **row)
        if not (err <= bound and db_err <= db_bound):
            raise AssertionError(f"{label}: fp32 dx {err} > {bound} or db {db_err} > {db_bound}")
        if at_kink and not row["kink_share"] < 0.05:
            raise AssertionError(f"{label}: {row['kink_share']:.2%} of the pixels at the kink")
        if not dx_psnr >= 38:
            raise AssertionError(f"{label}: bf16 PSNR {dx_psnr:.2f} dB < 38")
        worst = max(worst, err, db_err)
        total_ms += row["ms_fp32"]
        total_plain_ms += row["plain_ms_fp32"]
    return worst, total_ms, total_plain_ms


def check_generator_backward(device):
    """Phase 7b: every generator parameter's gradient of one scalar loss,
    kernel path (K1 + K2) against plain path, batch 2, fp32, TF32 off."""
    set_matmul_precision("float32")
    net = build_generator(CMSR_ADNI_G, generator=torch.Generator().manual_seed(SEED))
    net.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    z = torch.randn((2, 512), generator=gen, device=device)
    c = torch.rand((2, 1), generator=gen, device=device)
    cond = torch.randn((2, 4, 256, 256), generator=gen, device=device).clamp(-1, 1)
    weight = torch.randn((2, 1, 256, 256), generator=gen, device=device)

    def grads():
        net.zero_grad(set_to_none=True)
        (net(z, c, cond) * weight).sum().backward()
        return {name: p.grad.clone() for name, p in net.named_parameters()}

    fwd, bwd = k1.launches, k1.bwd_launches
    got = grads()
    counts = (k1.launches - fwd, k1.bwd_launches - bwd)
    with plain_filtered_lrelu():
        want = grads()
    if counts != (LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL) or \
            (k1.launches - fwd, k1.bwd_launches - bwd) != counts:
        raise AssertionError(f"K1/K2 launches {counts} in one forward and "
                             f"backward, then {(k1.launches - fwd, k1.bwd_launches - bwd)}")
    ratios = {name: float((got[name] - want[name]).abs().max()) /
              max(float(want[name].abs().max()), 1e-30) for name in want}
    worst = max(ratios, key=ratios.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    phase("7b generator backward kernel vs plain", batch=2, tensors=len(ratios),
          worst_tensor=worst, worst_rel_err=ratios[worst], bound_rel=1e-3,
          k1_launches=counts[0], k2_launches=counts[1], finite=finite)
    if not (finite and ratios[worst] <= 1e-3):
        raise AssertionError(f"{worst}: max|diff| / max|plain| {ratios[worst]} > 1e-3")


def train_config(out_dir, compute_dtype):
    """The shipped CMSR training config (configs/adni/stylegan3/cmsr.yml:
    b16, shared G forward, R1 every step, blur sigma 10 fading over 100
    kimg) with its periodic display, printing and saving turned off."""
    from afcm_tpu.config import default_argument_parser
    never = str(10 ** 9)
    return default_argument_parser([
        "--config-file", TRAIN_CONFIG, "tpu.compute_dtype", compute_dtype,
        "checkpoints_dir", out_dir, "name", f"smoke_{compute_dtype}",
        "trainer.display_freq", never, "trainer.print_freq", never,
        "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never])


class StepMonitor:
    """on_step callback of the train loop: launches per step, the losses
    (kept on the device, checked at the end), window times on the host
    clock around torch.cuda.synchronize(), and an optional traced step."""

    def __init__(self, boundaries=(), trace_step=None, trace_dir=None):
        self.boundaries = set(boundaries)
        self.times = {}
        self.counts = []
        self.metrics = []
        self.trace_step, self.trace_dir = trace_step, trace_dir
        self._last = (0, 0)
        self._prof = None

    def __call__(self, step, metrics):
        now = (k1.launches, k1.bwd_launches)
        self.counts.append((now[0] - self._last[0], now[1] - self._last[1]))
        self._last = now
        self.metrics.append(metrics)
        if step in self.boundaries:
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
        if step == self.trace_step:
            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            self._span = torch.profiler.record_function("traced_step")
            self._span.__enter__()
        elif self._prof is not None and step == self.trace_step + 1:
            torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self._prof.stop()
            summarize_trace(self._prof, "train_bfloat16_b16", "traced_step", 1,
                            self.trace_dir, layers=None, phase_name="7c trace")
            self._prof = None

    def losses_finite(self):
        return all(bool(torch.isfinite(v).all()) for m in self.metrics
                   for v in m.values())


def train_shipped(device, trace_dir=None):
    """Phase 7c: the train CLI's loop on the shipped config, bf16 b16, then
    fp32 b16; returns the bf16 run's directory."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    loaders = phantom_train_loaders(depth=6 * TRAIN_BATCH, size=256,
                                    batch_size=TRAIN_BATCH, seed=SEED)
    steps = WARM_STEPS + WINDOW_STEPS * WINDOWS
    bounds = [WARM_STEPS + i * WINDOW_STEPS for i in range(WINDOWS + 1)]
    monitor = StepMonitor(bounds, trace_step=steps if trace_dir else None,
                          trace_dir=trace_dir)
    cfg = train_config(out_dir, "bfloat16")
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.bwd_launches = 0          # the training path's run starts here
    t0 = time.perf_counter()
    val = train_cli.train(cfg, max_iters=TRAIN_BATCH * (steps + (1 if trace_dir else 0)),
                          loaders=loaders, device=device, on_step=monitor)
    seconds = time.perf_counter() - t0
    launches = {"filtered_lrelu": k1.launches, "filtered_lrelu_bwd": k1.bwd_launches}
    ms = [1e3 * (monitor.times[b] - monitor.times[a]) / WINDOW_STEPS
          for a, b in zip(bounds, bounds[1:])]
    per_step = sorted(set(monitor.counts))
    finite = monitor.losses_finite()
    last = {k: float(v) for k, v in monitor.metrics[-1].items()}
    phase("7c train bf16 b16", config=os.path.relpath(TRAIN_CONFIG, REPO),
          batch=TRAIN_BATCH, shared_g_fwd=bool(cfg.tpu.shared_g_fwd),
          r1_interval=int(cfg.loss.get("r1_interval", 1)),
          blur_sigma=last["blur_sigma"], steps=len(monitor.counts),
          ms_per_step=float(np.median(ms)), spread_ms=sorted(ms),
          img_per_s=1e3 * TRAIN_BATCH / float(np.median(ms)),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          launches_per_step=per_step, launches=launches, losses_finite=finite,
          last_losses=last, val=val, seconds=seconds)
    if per_step != [(LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL)]:
        raise AssertionError(f"K1/K2 launches per step {per_step}, want "
                             f"{LAYERS_WITH_KERNEL} each")
    if not finite:
        raise AssertionError("non-finite losses in the bf16 train steps")

    fp32 = StepMonitor(boundaries=(1, 3))
    k1.launches = k1.bwd_launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        train_cli.train(train_config(out_dir, "float32"), max_iters=3 * TRAIN_BATCH,
                        loaders=loaders, device=device, on_step=fp32)
    except torch.cuda.OutOfMemoryError as exc:
        phase("7c train fp32 b16", fits=False, steps=len(fp32.counts),
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
              error=str(exc).splitlines()[0])
    else:
        if not fp32.losses_finite():
            raise AssertionError("non-finite losses in the fp32 train steps")
        phase("7c train fp32 b16", fits=True, steps=len(fp32.counts),
              ms_per_step=1e3 * (fp32.times[3] - fp32.times[1]) / 2,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
              launches_per_step=sorted(set(fp32.counts)))
    torch.cuda.empty_cache()
    return os.path.join(out_dir, cfg.name), launches


def serve_trained(device, run_dir):
    """Phase 7d: the trained EMA generator, loaded from the run's
    latest_net_G_ema.pth as the evaluate CLI loads it, serves the phantom."""
    model = build_eval_model(CMSR_ADNI_G, compute_dtype="bfloat16")
    load_generator_ema(model, run_dir, "latest")
    model.generator_ema.to(device)
    loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH,
                                 seed=SEED)
    set_matmul_precision("bfloat16")
    forward = make_forward_fn(model, device, seed=SEED, norm_range=loader.norm_range)
    with tempfile.TemporaryDirectory() as out_dir:
        scores = serve_and_score(forward, [loader], out_dir, "t1_hr4sr")
    (subject,) = scores["subjects"].values()
    ok = subject["shape"] == (24, 256, 256) and subject["finite"]
    phase("7d serve trained G_ema", checkpoint="latest_net_G_ema.pth",
          volume=list(subject["shape"]), finite=ok, psnr=scores["psnr"],
          ssim=scores["ssim"], note="a few steps from random weights")
    if not (ok and np.isfinite([scores["psnr"], scores["ssim"]]).all()):
        raise AssertionError(f"bad stitched volume {subject} from the trained G_ema")


def forward_inputs(batch, device):
    """The timed forward's seeded (cond, slice_idx, z)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    z = torch.randn((batch, 512), generator=gen, device=device)
    c = torch.rand((batch, 1), generator=gen, device=device)
    cond = torch.randn((batch, 4, 256, 256), generator=gen,
                       device=device).clamp(-1, 1)
    return cond, c, z


def busy_us(intervals) -> float:
    """Length of the union of [start, stop) intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
        elif stop > end:
            total += stop - end
        end = max(end, stop)
    return total


def kernel_layers(synthesis):
    """Names of the layers that launch K1, in call order (toRGB is
    elementwise and launches none)."""
    names = [f"encoder_{i}" for i in range(len(synthesis.encoders))]
    return names + [f"L{i}_{layer.spec.out_size}_{layer.spec.out_channels}"
                    for i, layer in enumerate(synthesis.decoders)
                    if not layer.spec.is_torgb]


def trace_leg(model, inputs, key, iters, out_dir):
    """torch.profiler over `iters` forwards: device time by kernel, K1 per
    layer, and the busy share."""
    cond, c, z = inputs
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("traced_forwards"):
            for _ in range(iters):
                model.eval_step(cond, c, z=z)
            torch.cuda.synchronize()
    summarize_trace(prof, key, "traced_forwards", iters, out_dir,
                    layers=kernel_layers(model.generator_ema.synthesis),
                    phase_name="6 trace", unit="forward")


def summarize_trace(prof, key, span_name, iters, out_dir, layers, phase_name,
                    unit="step"):
    """Write the gzipped chrome trace and summary_<key>.json under out_dir:
    device time by kernel, K1 and K2 totals (and K1 per layer when `layers`
    names them), and the busy share. The window runs from the first to the
    last timestamp of the host span `span_name` and the device events in
    it, all on the trace's one clock, so the share is at most 1."""
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"trace_{key}.json.gz")
    prof.export_chrome_trace(trace_path)           # gzipped for the suffix
    with gzip.open(trace_path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = next((e for e in events if e["name"] == span_name
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        raise AssertionError(f"the trace holds no host span {span_name}")
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    window = (max([span["ts"] + span["dur"]] + [b for _, b in intervals])
              - min([span["ts"]] + [a for a, _ in intervals]))

    by_name = {}
    for e in device:
        total, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"], calls + 1)
    top = [{"name": name[:90], "calls": calls, f"ms_per_{unit}": us / 1e3 / iters}
           for name, (us, calls) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][0])][:25]
    k1_events = sorted((e for e in device if "filtered_lrelu_fwd_kernel" in e["name"]),
                       key=lambda e: e["ts"])
    k2_events = [e for e in device if "filtered_lrelu_bwd_kernel" in e["name"]]
    summary = {"leg": key, "iters": iters,
               f"window_ms_per_{unit}": window / 1e3 / iters,
               f"device_ms_per_{unit}": sum(e["dur"] for e in device) / 1e3 / iters,
               "device_busy_share": busy_us(intervals) / window,
               f"k1_ms_per_{unit}": sum(e["dur"] for e in k1_events) / 1e3 / iters,
               f"k2_ms_per_{unit}": sum(e["dur"] for e in k2_events) / 1e3 / iters,
               "k1_calls": len(k1_events), "k2_calls": len(k2_events), "top": top}
    if layers is not None:
        if len(k1_events) != len(layers) * iters:
            raise AssertionError(f"{len(k1_events)} K1 launches traced, want "
                                 f"{len(layers)} per {unit}")
        summary["k1_ms_per_layer"] = {
            name: sum(e["dur"] for e in k1_events[i::len(layers)]) / 1e3 / iters
            for i, name in enumerate(layers)}
    with open(os.path.join(out_dir, f"summary_{key}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    phase(phase_name, trace=os.path.relpath(trace_path, REPO),
          **{k: v for k, v in summary.items() if k not in ("k1_ms_per_layer", "top")},
          top=top[:8])


def time_forward(device, trace_dir=None):
    """Phase 6: generator forward slices/s, the legs of bench.py:150."""
    legs = {}
    for dtype, batch in (("bfloat16", 16), ("bfloat16", 32), ("float32", 16)):
        model = shipped_model(dtype)
        set_matmul_precision(dtype)
        torch.cuda.reset_peak_memory_stats()
        cond, c, z = inputs = forward_inputs(batch, device)
        model.eval_step(cond, c, z=z)
        torch.cuda.synchronize()
        iters, rates = 10, []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                model.eval_step(cond, c, z=z)
            torch.cuda.synchronize()
            rates.append(batch * iters / (time.perf_counter() - t0))
        key = f"{dtype}_b{batch}"
        legs[key] = float(np.median(rates))
        phase("6 generator forward", leg=key, slices_per_s=legs[key],
              spread=sorted(rates), ms_per_batch=1e3 * batch / legs[key],
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if trace_dir is not None:
            trace_leg(model, inputs, key, 2 if dtype == "float32" else 5,
                      trace_dir)
    return legs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", metavar="DIR",
                        help="also trace each leg of phase 6 and one train "
                             "step of phase 7 into DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          "nvidia-smi name, power limit:")
    print(smi)

    builds = _build.load_libraries(["filtered_lrelu", "filtered_lrelu_bwd"])
    for kernel, (_, info) in builds.items():
        ptxas = [line.strip() for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line]
        phase("2 build", kernel=kernel, seconds=info["seconds"],
              library=os.path.relpath(info["path"], REPO), ptxas=ptxas)

    worst, ms, plain_ms = check_variants(device)
    check_generator(device)

    k1.launches = k1.bwd_launches = 0    # the serving path's run starts here
    batches = sum(serve_phantom(device, dt)
                  for dt in ("bfloat16", "float32"))
    serve_launches = (k1.launches, k1.bwd_launches)
    if serve_launches != (LAYERS_WITH_KERNEL * batches, 0):
        raise AssertionError(f"{serve_launches} K1/K2 launches for {batches} "
                             f"batches; want {LAYERS_WITH_KERNEL} K1 per batch")
    time_forward(device, args.trace)

    bwd_worst, bwd_ms, bwd_plain_ms = check_backward_variants(device)
    check_generator_backward(device)
    run_dir, train_launches = train_shipped(device, args.trace)
    serve_trained(device, run_dir)
    shutil.rmtree(os.path.dirname(run_dir), ignore_errors=True)
    phase("launches by path", serve={"filtered_lrelu": serve_launches[0],
                                     "filtered_lrelu_bwd": serve_launches[1]},
          train=train_launches)
    if not train_launches["filtered_lrelu_bwd"]:
        raise AssertionError("the training path launched no K2")

    jax_loaded = [m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in ("jax", "flax", "optax")]
    if jax_loaded:
        raise AssertionError(f"the port's path loaded {jax_loaded[:5]}")

    print(json.dumps({"kernels": [
        {"name": "filtered_lrelu", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:273",
         "launches": serve_launches[0] + train_launches["filtered_lrelu"],
         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms},
        {"name": "filtered_lrelu_bwd", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu_bwd.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:292",
         "launches": train_launches["filtered_lrelu_bwd"],
         "max_abs_err": bwd_worst, "ms": bwd_ms, "plain_ms": bwd_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
