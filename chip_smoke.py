#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace DIR]

Drives the port's main paths — CMSR serving with the shipped ADNI alias-free
generator, the CMSR training step of that generator and its discriminator,
the int8 serving path (tpu.conv_int8 True), all at full width and depth
(random weights from a seed), the five measurement probes and the serve
entry point's loop — and checks the hand-written kernels on them: K1 and K2
(the fused filtered leaky ReLU forward and backward), K3 (the int8 3x3 conv
with its dequantizing epilogue; K4, its straight-through autograd Function,
has no kernel of its own) with its two quantizer kernels, and the probe
kernels K5-K9 (stream, copy, window-load and int8 matrix-rate probes):

1. the device, and nvidia-smi's name and power limit;
2. builds the six sources of csrc/ (K1, K2, K3, the int8 quantizers, the
   stream probes, the int8 probes) with nvcc, all at once, and prints the
   build times and ptxas's registers and spills;
3. K1 against its plain PyTorch version for the four filter variants of the
   generator at full-size layer shapes (batch 2): fp32 with TF32 off within
   1e-4 * max|plain| + 1e-4, bf16 at PSNR >= 38 dB against fp32 plain; both
   timed with CUDA events; per variant which instantiation ran, its tile and
   shared memory, and the generic kernel on the same inputs (timed, and
   within 1e-5 * max + 1e-6 of the specialised one, its count of unequal
   elements printed);
4. the full generator at batch 2, fp32, TF32 off: kernel path against the
   plain path within 1e-3 * max|plain|; bf16 against fp32 plain at >= 30 dB;
5. serves an in-memory phantom subject (24 slices of 256^2) through the
   evaluate CLI's own serve-and-score loop (afcm_tpu_torch.evaluate.
   serve_and_score) at batch 16 in bf16 and fp32: the stitched volume is
   finite and of the right shape, PSNR/SSIM are finite, and K1 launched
   exactly 28 times per batch;
6. times the generator forward at bf16 b16, bf16 b32, fp32 b16 and bf16 b16
   under conv impl 'int8' (median of 3 windows and the spread). With
   --trace DIR it also traces each leg with torch.profiler and writes the
   gzipped chrome trace and a breakdown (summary_<leg>.json) under DIR:
   device time by kernel, K1's time per layer beside the sum of its bounds
   over the forward's 28 launches, and the device-busy share of the traced
   window;
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
   one bf16 train step is traced too;
8. the int8 path: (a) K3 against its plain version on quantized inputs made
   with numpy from the seed, batch 2, at the path's shapes (512 -> 512 at
   36^2 and 52^2, padding 2, and 38^2 without padding), at 362 -> 512 148^2,
   91 -> 128 and 64 -> 64 at 276^2, and with padding 1 and 0 and an
   extra_scale: the bf16 outputs are equal bit for bit (the count of
   unequal elements is printed and must be 0), and the whole quantized conv
   is >= 50 dB from the fp32 conv of the unquantized inputs; the activation
   and the weight quantizer kernels against their plain versions (packed
   int8 tensor and scales) at the three routed shapes and a ragged one,
   float32 and bfloat16, with an all-zero sample: 0 unequal elements;
   (b) timing at batch 16 of every distinct 3x3 conv shape of the
   generator: K3 alone with the idle share of its pixel tiles, the
   quantizer kernels and their plain versions, quantize + K3 (the fused
   path the wrapper takes), the float conv the path makes with the knob off
   (conv2d_gradfix.conv2d in bf16), cuDNN's bf16 conv of the same quantized
   integers, and the plain version, beside the bound; (c) K4's dx and dw
   against the plain path's within 1e-4 * max + 1e-5, and K4's backward
   (the fp32 conv adjoint, TF32 off and on) timed at the three routed
   shapes, batch 16, beside its bound; (d) the generator
   under 'int8' at batch 2, fp32, TF32 off: the kernel path (K1 and K3)
   equals the path with K3's plain version bit for bit, is within
   1e-2 * max|plain| of the path with both plain versions (K1's last-bit
   differences flip single quantization steps), and >= 30 dB from the float
   generator; (e) the phantom served under a config with tpu.conv_int8 True
   at bf16 b16, the conv implementation set by configure_numerics: finite
   volume and scores, 28 K1, 11 K3 and 11 launches of each quantizer per
   batch; then the knob off and no K3 launch in the next forward;
9. the probes: (a) each of the nine probe kernels (copy, wr4x, rd4x, chain,
   copy3d, copy2d, windows, stacked_matmul, nine_tap in its four modes) at
   a small shape and at a full one against its plain version: every one is
   exact, the count of unequal elements is printed and must be 0; (b) the
   five entry points (afcm_tpu_torch.probes.*.main) at full size, their
   tables printed, each kernel launched at least once; (c) per kernel its
   time, rate, bound and the library call's time;
10. the serve entry point's loop (afcm_tpu_torch.serve.serve_subjects) over
   the phantom at full width in float32, with the float32 fetch and with
   tpu.fetch_dtype bfloat16: 28 K1 launches per batch, the bf16-fetched
   volume >= 50 dB from the float32-fetched one, NIfTI heads written.

Then prints the kernels' JSON line (per kernel: launches on its main paths,
error, time, plain version's time, the bound from the bytes and operations
of the timed inputs, the library call's time where there is one) and, last,
{"ok": true, "device": ...}. Any failure raises and exits non-zero; without CUDA nothing is printed.
Needs torch with CUDA, nvcc, numpy, scipy and yaml (the training config);
no h5py or JAX: it imports only the port, afcm_tpu_torch, and fails if
anything loaded jax, flax, optax or the JAX package afcm_tpu.
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
from afcm_tpu_torch import probes, serve
from afcm_tpu_torch import train as train_cli
from afcm_tpu_torch.data.demo import phantom_test_loader, phantom_train_loaders
from afcm_tpu_torch.evaluate import (configure_numerics, load_generator_ema,
                                     make_forward_fn, serve_and_score,
                                     set_matmul_precision)
from afcm_tpu_torch.models import CMSR_ADNI_G, build_eval_model, build_generator
from afcm_tpu_torch.ops import (conv2d_gradfix, get_conv_impl, modulated_conv,
                                set_conv_impl)
from afcm_tpu_torch.ops.cuda import _build
from afcm_tpu_torch.ops.cuda import conv_int8 as k3
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1
from afcm_tpu_torch.ops.cuda import probe_int8 as p8
from afcm_tpu_torch.ops.cuda import probe_stream as ps
from afcm_tpu_torch.probes import (element_windows, fir_roofline, int8_kernel,
                                   int8_matmul, stream_diag)
from afcm_tpu_torch.utils.profiling import cuda_median_ms, cuda_ms

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
# Convs that mode 'int8' routes to K3: 512 -> 512 at 36^2 (6 layers) and
# 52^2 (4), padding 2, and the bottleneck conv e_16x16 at 38^2, padding 0.
INT8_ROUTED = 11
# Published peaks of one H100 SXM (dense): the rates the bounds are taken at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml")
TRAIN_BATCH = 16
WARM_STEPS, WINDOW_STEPS, WINDOWS = 3, 4, 3


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


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


@contextlib.contextmanager
def plain_conv_int8():
    """Route CUDA tensors through K3's plain version (same quantizers, the
    integer conv in float64)."""
    saved = k3.conv3x3_int8_cuda
    k3.conv3x3_int8_cuda = k3.conv3x3_int8_plain
    try:
        yield
    finally:
        k3.conv3x3_int8_cuda = saved


@contextlib.contextmanager
def conv_impl(impl):
    """The conv implementation for the block, then the float conv again."""
    set_conv_impl(impl)
    try:
        yield
    finally:
        set_conv_impl("xla")


@functools.lru_cache(maxsize=None)
def shipped_model(compute_dtype: str):
    """The shipped ADNI CMSR generator on the card; every dtype gets the
    same random weights, drawn from SEED."""
    model = build_eval_model(CMSR_ADNI_G, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(SEED))
    model.generator_ema.to("cuda")
    return model


def filtered_lrelu_bound_ms(x, out_size, kw, backward=False):
    """The least time the card could take for one filtered_lrelu call (or
    its backward) on x: the larger of the bytes it must move (x and the
    bias read, y written; backward: x and dy read, dx written) over the HBM
    rate and its FMAs over the fp32 rate, with which of the two binds. The
    FMAs are those of the separable polyphase form: per plane the up-FIR
    touches ceil(ntu / up) taps per sample (W pass over the input rows, H
    pass over the mid window the output needs), the down-FIR ntd taps (H
    then W pass); the backward recomputes the up passes and runs both
    transposed."""
    n, c, in_size = x.shape[0], x.shape[1], x.shape[2]
    up, down = kw["up"], kw["down"]
    ntu = 1 if kw["fu"] is None else len(kw["fu"])
    ntd = 1 if kw["fd"] is None else len(kw["fd"])
    mid = (out_size - 1) * down + ntd
    up_fmas = (in_size * mid + mid * mid) * -(-ntu // up)
    down_fmas = (out_size * mid + out_size * out_size) * ntd
    fmas = n * c * ((2 * up_fmas + down_fmas) if backward else (up_fmas + down_fmas))
    x_bytes = x.numel() * x.element_size()
    y_bytes = n * c * out_size * out_size * x.element_size()
    nbytes = (2 * x_bytes + y_bytes) if backward else \
        (x_bytes + c * x.element_size() + y_bytes)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * fmas / FP32_FLOP_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def add_bound(total, bound):
    """Sum of per-call bounds; bound_by is that of the largest term."""
    ms, by, largest = total
    return ms + bound[0], (bound[1] if bound[0] > largest else by), max(largest, bound[0])


@contextlib.contextmanager
def generic_k1():
    """Plan K1's calls for its generic kernel, whatever their geometry."""
    saved = k1.FWD_SPECIALISED
    k1.FWD_SPECIALISED = frozenset()
    try:
        yield
    finally:
        k1.FWD_SPECIALISED = saved


def k1_tile(x, kw):
    """K1's plan (instantiation, tile, windows, shared memory) for a call."""
    plan = k1._Plan(x, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"], False)
    return k1.plan_fwd_tile(plan.up, plan.down, len(plan.gu), len(plan.gd),
                            plan.out_h, plan.out_w)


def check_variants(device):
    """Phase 3: K1 against its plain version at full-size layer shapes, and
    its specialised instantiations against its generic kernel."""
    synthesis = shipped_model("float32").generator_ema.synthesis
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst, total_ms, total_plain_ms = 0.0, 0.0, 0.0
    total_bound = (0.0, "bytes", 0.0)
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
        tile = k1_tile(x, kw)
        with generic_k1():
            generic = k1.filtered_lrelu_cuda(x, b=b, **kw)
            generic_ms = cuda_ms(lambda: k1.filtered_lrelu_cuda(x, b=b, **kw))
            generic_tile = k1_tile(x, kw)
        unequal = int((got != generic).sum())
        spec_err = float((got - generic).abs().max())
        spec_bound = 1e-5 * float(generic.abs().max()) + 1e-6
        least = filtered_lrelu_bound_ms(x, spec.out_size, kw)
        total_bound = add_bound(total_bound, least)
        geometry = (kw["up"], kw["down"], len(kw["fu"]), len(kw["fd"]))
        row = dict(variant=label, shape=list(shape), out=spec.out_size,
                   instantiation=("specialised %d/%d %d/%d" % geometry
                                  if tile["specialised"] else "generic"),
                   tile=[tile["tile_y"], tile["tile_x"]], smem_bytes=tile["smem_bytes"],
                   tiles=tile["tiles"], fmas_per_plane=tile["fmas_per_plane"],
                   fp32_max_abs_err=err, fp32_bound=bound, bf16_psnr_db=db,
                   generic_tile=[generic_tile["tile_y"], generic_tile["tile_x"]],
                   generic_smem_bytes=generic_tile["smem_bytes"],
                   unequal_vs_generic=unequal, max_abs_diff_vs_generic=spec_err,
                   bound_vs_generic=spec_bound, ms_fp32_generic=generic_ms,
                   bound_ms_fp32=least[0], bound_by=least[1],
                   ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_cuda(x, b=b, **kw)),
                   plain_ms_fp32=cuda_ms(lambda: k1.filtered_lrelu_plain(x, b=b, **kw)),
                   ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_cuda(xb, b=bb, **kw)),
                   plain_ms_bf16=cuda_ms(lambda: k1.filtered_lrelu_plain(xb, b=bb, **kw)))
        phase("3 kernel vs plain", **row)
        if not err <= bound:
            raise AssertionError(f"{label}: fp32 max|diff| {err} > {bound}")
        if not db >= 38:
            raise AssertionError(f"{label}: bf16 PSNR {db:.2f} dB < 38")
        if not (tile["specialised"] and spec_err <= spec_bound):
            raise AssertionError(f"{label}: the specialised K1 ({tile['specialised']}) "
                                 f"differs from the generic one by {spec_err} > {spec_bound}")
        worst = max(worst, err)
        total_ms += row["ms_fp32"]
        total_plain_ms += row["plain_ms_fp32"]
    return worst, total_ms, total_plain_ms, total_bound[:2]


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


def serve_phantom(device, compute_dtype, phase_name="5 serve phantom"):
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
    phase(phase_name, compute_dtype=compute_dtype, conv_impl=get_conv_impl(),
          batch=SERVE_BATCH,
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
    total_bound = (0.0, "bytes", 0.0)
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
        least = filtered_lrelu_bound_ms(x, spec.out_size, kw, backward=True)
        total_bound = add_bound(total_bound, least)
        row = dict(variant=label, x=list(x.shape), dy=list(dy.shape),
                   bound_ms_fp32=least[0], bound_by=least[1],
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
    return worst, total_ms, total_plain_ms, total_bound[:2]


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
    from afcm_tpu_torch.config import default_argument_parser
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


def int8_case(n, i, o, h, p, extra, seed):
    """Seeded numpy (x, w, extra_scale) of one conv on the card, and the
    quantized operands: integer values, scale, packed int8 tensors."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, i, h, h).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32)).cuda()
    es = torch.from_numpy((rng.rand(n, o) + 0.5).astype(np.float32)).cuda() if extra else None
    xq, x_scale = k3.quantize_activations(x)
    wq, w_scale = k3.quantize_weights(w)
    scale = k3.dequant_scale(x_scale, w_scale, es)
    return x, w, es, xq, wq, scale, k3.pack_activations(xq, p), k3.pack_weights(wq)


def check_conv_int8():
    """Phase 8a: K3 against its plain version, bit for bit."""
    cases = [(512, 512, 36, 2, False), (512, 512, 52, 2, False),
             (512, 512, 38, 0, False), (362, 512, 148, 2, False),
             (91, 128, 276, 2, False), (64, 64, 276, 2, False),
             (181, 256, 84, 1, True), (91, 181, 40, 0, True)]
    set_matmul_precision("float32")
    unequal_total, worst = 0, 0.0
    for idx, (i, o, h, p, extra) in enumerate(cases):
        x, w, es, xq, wq, scale, xp, wp = int8_case(2, i, o, h, p, extra, SEED + 10 + idx)
        got = k3.int8_conv_cuda(xp, wp, scale, o)
        torch.cuda.synchronize()
        want = k3.int8_conv_plain(xq, wq, scale, p)
        size = h + 2 * p - 2
        if got.shape != want.shape or tuple(got.shape) != (2, o, size, size) \
                or got.dtype != torch.bfloat16:
            raise AssertionError(f"K3 gave {tuple(got.shape)} {got.dtype}, plain "
                                 f"{tuple(want.shape)}")
        unequal = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        err = float((got.float() - want.float()).abs().max())
        # the whole op through its wrapper, against the float conv it stands for
        full = k3.conv3x3_int8(x, w, p, es)
        ref = torch.nn.functional.conv2d(x, w, padding=p)
        if extra:
            ref = ref * es[:, :, None, None]
        db = psnr(full, ref)
        phase("8a K3 vs plain", channels=[i, o], size=h, padding=p,
              extra_scale=extra, out=list(got.shape), unequal_elements=unequal,
              max_abs_err=err, wrapper_equal=bool(torch.equal(full, got)),
              psnr_vs_fp32_conv_db=db)
        if unequal or not torch.equal(full, got):
            raise AssertionError(f"K3 {i}->{o} at {h}^2 p{p}: {unequal} elements "
                                 "differ from the plain version")
        if not db >= 50:
            raise AssertionError(f"int8 conv {i}->{o} at {h}^2: {db:.2f} dB < 50")
        unequal_total += unequal
        worst = max(worst, err)
    return unequal_total, worst


def bit_unequal(got, want):
    """Count of elements whose bits differ (same shape and dtype)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.float32:
        return int((got.view(torch.int32) != want.view(torch.int32)).sum())
    return int((got != want).sum())


def check_quantizers():
    """Phase 8a, the quantizer kernels against their plain versions, bit
    for bit: the packed int8 tensors and the scales, at the three routed
    shapes and a ragged one, float32 and bfloat16 inputs, sample 0 all zero.
    Then a NaN in one sample and one weight channel, which must reach the
    scale and the conv's output as in the plain version. Returns per kernel
    the total of unequal elements and the largest |kernel - plain| over the
    packed integers and the scales."""
    cases = [(512, 512, 36, 2), (512, 512, 52, 2), (512, 512, 38, 0), (91, 160, 41, 1)]
    totals = {"activations": 0, "weights": 0}
    worst = {"activations": 0.0, "weights": 0.0}

    def max_abs(got, want):
        return float((got.double() - want.double()).abs().max())
    for idx, (i, o, h, p) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(SEED + 50 + idx)
            x = torch.from_numpy(rng.randn(3, i, h, h).astype(np.float32)).cuda().to(dtype)
            w = torch.from_numpy((rng.randn(o, i, 3, 3) / np.sqrt(9 * i))
                                 .astype(np.float32)).cuda().to(dtype)
            x[0] = 0                            # the scale's floor, 1e-8 / 127
            before = (k3.quantize_launches, k3.weight_quantize_launches)
            xp, x_scale = k3.quantize_pack_activations_cuda(x, p)
            wp, w_scale = k3.quantize_pack_weights_cuda(w)
            torch.cuda.synchronize()
            launched = (k3.quantize_launches - before[0],
                        k3.weight_quantize_launches - before[1])
            want_xp, want_xs = k3.quantize_pack_activations_plain(x, p)
            want_wp, want_ws = k3.quantize_pack_weights_plain(w)
            row = dict(x_unequal=bit_unequal(xp, want_xp),
                       x_scale_unequal=bit_unequal(x_scale, want_xs),
                       w_unequal=bit_unequal(wp, want_wp),
                       w_scale_unequal=bit_unequal(w_scale, want_ws))
            errs = dict(x_max_abs_err=max(max_abs(xp, want_xp), max_abs(x_scale, want_xs)),
                        w_max_abs_err=max(max_abs(wp, want_wp), max_abs(w_scale, want_ws)))
            phase("8a quantizer vs plain", channels=[i, o], size=h, padding=p,
                  dtype=str(dtype).split(".")[1], packed_x=list(xp.shape),
                  packed_w=list(wp.shape), launches=list(launched), **row, **errs)
            if any(row.values()) or launched != (1, 1):
                raise AssertionError(f"quantizer kernels {i}->{o} at {h}^2 p{p} {dtype}: "
                                     f"{row}, launches {launched}")
            totals["activations"] += row["x_unequal"] + row["x_scale_unequal"]
            totals["weights"] += row["w_unequal"] + row["w_scale_unequal"]
            worst["activations"] = max(worst["activations"], errs["x_max_abs_err"])
            worst["weights"] = max(worst["weights"], errs["w_max_abs_err"])

    rng = np.random.RandomState(SEED + 60)
    x = torch.from_numpy(rng.randn(3, 512, 36, 36).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.randn(512, 512, 3, 3) / 68).astype(np.float32)).cuda()
    x[1, 7, 3, 5] = float("nan")
    w[4, 9, 1, 2] = float("nan")
    x_scale = k3.quantize_pack_activations_cuda(x, 2)[1]
    w_scale = k3.quantize_pack_weights_cuda(w)[1]
    nan = torch.isnan(k3.conv3x3_int8_cuda(x, w, 2))
    want_nan = torch.isnan(k3.conv3x3_int8_plain(x, w, 2))
    row = dict(x_scale_nan=torch.isnan(x_scale).nonzero().flatten().tolist(),
               w_scale_nan=torch.isnan(w_scale).nonzero().flatten().tolist(),
               nan_outputs=int(nan.sum()), plain_nan_outputs=int(want_nan.sum()),
               same_outputs_nan=bool(torch.equal(nan, want_nan)))
    phase("8a quantizer NaN", channels=[512, 512], size=36, padding=2, nan_sample=1,
          nan_weight_channel=4, **row)
    if row["x_scale_nan"] != [1] or row["w_scale_nan"] != [4] or not row["same_outputs_nan"] \
            or not (nan[1].all() and nan[:, 4].all()):
        raise AssertionError(f"a NaN input did not reach the scales and the output: {row}")
    return totals, worst


def conv3x3_shapes(synthesis):
    """Distinct (in_channels, out_channels, input size, padding) of the
    generator's 3x3 convs that the int8 kernel takes, with the count of
    each, in first-use order: 27 layers (full padding; the first encoder
    layer has 4 input channels and is not eligible) and the bottleneck conv
    e_16x16."""
    shapes = {}
    for layer in list(synthesis.encoders) + list(synthesis.decoders):
        spec = layer.spec
        key = (spec.in_channels, spec.out_channels, spec.in_size, 2)
        if not spec.is_torgb and k3.int8_routable(
                (1, key[0], key[2], key[2]), (key[1], key[0], 3, 3), 2):
            shapes[key] = shapes.get(key, 0) + 1
    c = synthesis.layout.bottleneck_channels
    key = (c, c, synthesis.encoders[-1].spec.out_size + 2, 0)
    shapes[key] = shapes.get(key, 0) + 1
    return shapes


def time_conv_int8():
    """Phase 8b: every distinct conv shape at batch 16. Returns K3's sums
    over the shapes mode 'int8' routes (the serving path's)."""
    synthesis = shipped_model("bfloat16").generator_ema.synthesis
    sums = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=(0.0, "operations", 0.0),
                qx_ms=0.0, qx_plain_ms=0.0, qx_bound_ms=0.0,
                qw_ms=0.0, qw_plain_ms=0.0, qw_bound_ms=0.0)
    gated = 0
    for idx, ((i, o, h, p), count) in enumerate(conv3x3_shapes(synthesis).items()):
        x, w, _, xq, wq, scale, xp, wp = int8_case(SERVE_BATCH, i, o, h, p, False,
                                                    SEED + 30 + idx)
        size = h + 2 * p - 2
        ops = 2 * 9 * o * i * size * size * SERVE_BATCH
        moved = sum(t.numel() * t.element_size() for t in (xp, wp, scale)) + \
            SERVE_BATCH * o * size * size * 2
        by_ops, by_bytes = 1e3 * ops / INT8_OP_PER_S, 1e3 * moved / HBM_BYTES_PER_S
        least = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes")
        xb, wb = x.bfloat16(), w.bfloat16()
        xqb, wqb = xq.bfloat16(), wq.bfloat16()     # the integers are exact in bf16
        routed = modulated_conv._int8_gate(x.shape, w.shape)   # what mode 'int8' takes
        # the quantizers move x (or w) in once and the packed tensor and scales out
        qx_bytes = xb.numel() * 2 + xp.numel() + 4 * SERVE_BATCH
        qw_bytes = w.numel() * 4 + wp.numel() + 4 * o
        row = dict(channels=[i, o], size=h, padding=p, batch=SERVE_BATCH, layers=count,
                   routed_by_int8_gate=routed, g_ops=ops / 1e9, mbytes=moved / 1e6,
                   tile_rows=k3.plan_tile_rows(size),
                   tile_idle_share=k3.tile_idle_share(size, size),
                   k3_ms=cuda_median_ms(lambda: k3.int8_conv_cuda(xp, wp, scale, o)),
                   quantize_k3_ms=cuda_median_ms(lambda: k3.conv3x3_int8_cuda(x, w, p)),
                   quantize_k3_bf16_x_ms=cuda_median_ms(
                       lambda: k3.conv3x3_int8_cuda(xb, w, p)),
                   quantize_x_bf16_ms=cuda_median_ms(
                       lambda: k3.quantize_pack_activations_cuda(xb, p)),
                   quantize_x_plain_ms=cuda_median_ms(
                       lambda: k3.quantize_pack_activations_plain(xb, p), repeats=3, warmup=1),
                   quantize_x_bound_ms=1e3 * qx_bytes / HBM_BYTES_PER_S,
                   quantize_w_ms=cuda_median_ms(lambda: k3.quantize_pack_weights_cuda(w)),
                   quantize_w_plain_ms=cuda_median_ms(
                       lambda: k3.quantize_pack_weights_plain(w), repeats=3, warmup=1),
                   quantize_w_bound_ms=1e3 * qw_bytes / HBM_BYTES_PER_S,
                   float_conv_bf16_ms=cuda_median_ms(
                       lambda: conv2d_gradfix.conv2d(xb, wb, padding=p)),
                   library_ms=cuda_median_ms(
                       lambda: torch.nn.functional.conv2d(xqb, wqb, padding=p)),
                   plain_ms=cuda_median_ms(
                       lambda: k3.int8_conv_plain(xq, wq, scale, p), repeats=3, warmup=1),
                   bound_ms=least[0], bound_by=least[1])
        row["k3_top_per_s"] = ops / row["k3_ms"] / 1e9
        phase("8b conv shapes", **row)
        if routed:
            gated += count
            for key in ("ms", "plain_ms", "library_ms"):
                sums[key] += row["k3_ms" if key == "ms" else key]
            sums["bound"] = add_bound(sums["bound"], least)
            for q, name in (("qx", "quantize_x"), ("qw", "quantize_w")):
                sums[q + "_ms"] += row[name + ("_bf16_ms" if q == "qx" else "_ms")]
                sums[q + "_plain_ms"] += row[name + "_plain_ms"]
                sums[q + "_bound_ms"] += row[name + "_bound_ms"]
        del x, w, xq, wq, xp, wp, xb, wb, xqb, wqb
    if gated != INT8_ROUTED:
        raise AssertionError(f"the gate takes {gated} convs of the layout, want {INT8_ROUTED}")
    return sums


def check_ste_backward():
    """Phase 8c: K4's dx and dw against the plain path's (plain forward, the
    same conv backward), 512 -> 512 at 36^2, batch 2, fp32, TF32 off."""
    set_matmul_precision("float32")
    x, w = int8_case(2, 512, 512, 36, 2, False, SEED + 20)[:2]
    g = torch.randn((2, 512, 38, 38), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED + 21))

    def grads():
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = k3.conv3x3_int8_ste(xg, wg, 2)
        (torch.sin(y.float()) * g).sum().backward()
        return y.detach(), xg.grad, wg.grad

    before = k3.launches
    y, dx, dw = grads()
    launched = k3.launches - before
    with plain_conv_int8():
        want_y, want_dx, want_dw = grads()
    if launched != 1 or k3.launches - before != 1:
        raise AssertionError(f"K4's forward launched K3 {launched} times, the plain "
                             f"run {k3.launches - before - launched}")
    errs = {}
    for name, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        errs[name] = float((got - want).abs().max())
        errs[name + "_bound"] = 1e-4 * float(want.abs().max()) + 1e-5
    phase("8c K4 backward", channels=[512, 512], size=36, batch=2,
          forward_equal=bool(torch.equal(y, want_y)), **errs)
    if not (torch.equal(y, want_y) and errs["dx"] <= errs["dx_bound"]
            and errs["dw"] <= errs["dw_bound"]):
        raise AssertionError(f"K4 backward against the plain path: {errs}")


def time_ste_backward():
    """Phase 8c, timing: K4's backward (the fp32 conv adjoint, dx and dw
    through conv2d_gradfix, as the Function's backward computes them) at the
    three conv shapes mode 'int8' routes, batch 16, with TF32 off and on,
    beside its bound: the adjoint's FLOPs (dx and dw, 2 * 9 * O * I * Ho *
    Wo * N each) over the fp32 rate, and its bytes (dy read as the bf16 K3
    gives it, x and w read, dx and dw written in fp32) over the HBM rate."""
    synthesis = shipped_model("bfloat16").generator_ema.synthesis
    routed = [key for key in conv3x3_shapes(synthesis)
              if modulated_conv._int8_gate((1, key[0], key[2], key[2]), (key[1], key[0], 3, 3))]
    if len(routed) != 3:
        raise AssertionError(f"mode 'int8' routes the conv shapes {routed}, want three")
    for idx, (i, o, h, p) in enumerate(routed):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 50 + idx)
        xg = torch.randn((SERVE_BATCH, i, h, h), generator=gen, device="cuda").requires_grad_(True)
        wg = (torch.randn((o, i, 3, 3), generator=gen, device="cuda") / np.sqrt(9 * i)) \
            .requires_grad_(True)
        y = k3.conv3x3_int8_ste(xg, wg, p)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
        size = h + 2 * p - 2
        flops = 2 * (2 * 9 * o * i * size * size * SERVE_BATCH)
        nbytes = dy.numel() * dy.element_size() + 4 * 2 * (xg.numel() + wg.numel())
        by_ops, by_bytes = 1e3 * flops / FP32_FLOP_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
        ms = {}
        for tf32 in (False, True):
            set_matmul_precision("bfloat16" if tf32 else "float32")
            ms["tf32" if tf32 else "fp32"] = cuda_median_ms(
                lambda: torch.autograd.grad(y, (xg, wg), dy, retain_graph=True))
        set_matmul_precision("float32")
        phase("8c K4 backward timing", channels=[i, o], size=h, padding=p, batch=SERVE_BATCH,
              ms_tf32_off=ms["fp32"], ms_tf32_on=ms["tf32"], gflop=flops / 1e9,
              mbytes=nbytes / 1e6, bound_ms=max(by_ops, by_bytes),
              bound_by="operations" if by_ops >= by_bytes else "bytes")
        del xg, wg, y, dy


def check_generator_int8(device):
    """Phase 8d: the generator under conv impl 'int8'. The kernel path (K1
    and K3) against the same path with K3's plain version: equal bit for
    bit, since K3 is exact. Against the path with both plain versions:
    within 1e-2 * max|plain|. That is looser than phase 4's 1e-3: K1 and its
    plain version differ by ~1e-6 relative, which carries some activations
    across a rounding boundary of the next quantizer, and each such flip is
    a step of 1/127 of that layer's range at one element."""
    model = shipped_model("float32")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    z = torch.randn((2, 512), generator=gen, device=device)
    c = torch.rand((2, 1), generator=gen, device=device)
    cond = torch.randn((2, 4, 256, 256), generator=gen, device=device).clamp(-1, 1)
    set_matmul_precision("float32")
    float_out = model.eval_step(cond, c, z=z)
    counts = (k1.launches, k3.launches)
    quantized = (k3.quantize_launches, k3.weight_quantize_launches)
    with conv_impl("int8"):
        got = model.eval_step(cond, c, z=z)
        launched = (k1.launches - counts[0], k3.launches - counts[1])
        quantized = (k3.quantize_launches - quantized[0],
                     k3.weight_quantize_launches - quantized[1])
        with plain_conv_int8():
            same_k1 = model.eval_step(cond, c, z=z)
        k1_again = k1.launches - counts[0] - launched[0]
        with plain_filtered_lrelu(), plain_conv_int8():
            want = model.eval_step(cond, c, z=z)
    if launched != (LAYERS_WITH_KERNEL, INT8_ROUTED) or k1_again != LAYERS_WITH_KERNEL or \
            quantized != (INT8_ROUTED, INT8_ROUTED) or \
            (k1.launches - counts[0], k3.launches - counts[1]) != \
            (2 * LAYERS_WITH_KERNEL, INT8_ROUTED):
        raise AssertionError(f"K1/K3 launches {launched} and quantizer launches "
                             f"{quantized} in one int8 forward, want "
                             f"{(LAYERS_WITH_KERNEL, INT8_ROUTED)} and {INT8_ROUTED} "
                             "each; the plain runs must launch no K3 and the last no K1")
    unequal = int((got != same_k1).sum())
    err = float((got - want).abs().max())
    bound = 1e-2 * float(want.abs().max())
    db = psnr(got, float_out)
    phase("8d generator int8 kernel vs plain", batch=2, shape=list(got.shape),
          unequal_elements_vs_plain_k3=unequal,
          fp32_max_abs_err_vs_both_plain=err, bound=bound,
          max_abs_plain=float(want.abs().max()),
          k1_launches=launched[0], k3_launches=launched[1],
          quantizer_launches=list(quantized), psnr_vs_float_generator_db=db,
          finite=bool(torch.isfinite(got).all()))
    if unequal:
        raise AssertionError(f"int8 generator: {unequal} elements differ between "
                             "K3 and its plain version")
    if not (torch.isfinite(got).all() and err <= bound):
        raise AssertionError(f"int8 generator fp32 max|diff| {err} > {bound}")
    if not (np.isfinite(db) and db >= 30):
        raise AssertionError(f"int8 generator {db:.2f} dB from the float one, < 30")


def serve_phantom_int8(device):
    """Phase 8e: the phantom served under a config with tpu.conv_int8 True;
    the conv implementation comes from configure_numerics, as in the CLI.
    Returns the (K1, K3, activation quantizer, weight quantizer) launches
    of the int8 serving path."""
    from afcm_tpu_torch.config import default_argument_parser
    argv = ["--config-file", TRAIN_CONFIG, "tpu.compute_dtype", "bfloat16"]
    try:
        compute_dtype = configure_numerics(
            default_argument_parser(argv + ["tpu.conv_int8", "True"]))
        if get_conv_impl() != "int8":
            raise AssertionError(f"configure_numerics left conv impl {get_conv_impl()}")
        k1.launches = k1.bwd_launches = k3.launches = 0   # the int8 path's run starts here
        k3.quantize_launches = k3.weight_quantize_launches = 0
        batches = serve_phantom(device, compute_dtype, phase_name="8e serve phantom int8")
        launches = (k1.launches, k3.launches, k3.quantize_launches,
                    k3.weight_quantize_launches)
        configure_numerics(default_argument_parser(argv))
        if get_conv_impl() != "xla":
            raise AssertionError("configure_numerics did not reset the conv impl")
        cond, c, z = forward_inputs(SERVE_BATCH, device)
        shipped_model(compute_dtype).eval_step(cond, c, z=z)
        after = (k1.launches - launches[0], k3.launches - launches[1])
    finally:
        set_conv_impl("xla")
    phase("8e int8 launches", batches=batches, k1=launches[0], k3=launches[1],
          quantize_activations=launches[2], quantize_weights=launches[3],
          knob_off_next_forward={"k1": after[0], "k3": after[1]})
    if launches != (LAYERS_WITH_KERNEL * batches,) + (INT8_ROUTED * batches,) * 3:
        raise AssertionError(f"{launches} K1/K3/quantizer launches for {batches} int8 "
                             f"batches; want {LAYERS_WITH_KERNEL} K1 and {INT8_ROUTED} "
                             "of K3 and of each quantizer per batch")
    if after != (LAYERS_WITH_KERNEL, 0):
        raise AssertionError(f"knob off: {after} K1/K3 launches in the next forward")
    return launches


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


def forward_k1_bound_ms(synthesis, batch, dtype):
    """Sum of K1's bounds (filtered_lrelu_bound_ms) over one forward's
    launches, one per layer but toRGB, at the forward's batch and dtype."""
    total = 0.0
    for layer in list(synthesis.encoders) + list(synthesis.decoders):
        if layer.spec.is_torgb:
            continue
        size = layer.spec.in_size + 2
        x = torch.empty((batch, layer.spec.out_channels, size, size), dtype=dtype,
                        device="meta")
        kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up, down=layer.down)
        total += filtered_lrelu_bound_ms(x, layer.spec.out_size, kw)[0]
    return total


def trace_leg(model, inputs, key, iters, out_dir, dtype):
    """torch.profiler over `iters` forwards: device time by kernel, K1 per
    layer beside the sum of its bounds, and the busy share."""
    cond, c, z = inputs
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("traced_forwards"):
            for _ in range(iters):
                model.eval_step(cond, c, z=z)
            torch.cuda.synchronize()
    synthesis = model.generator_ema.synthesis
    summarize_trace(prof, key, "traced_forwards", iters, out_dir,
                    layers=kernel_layers(synthesis), phase_name="6 trace", unit="forward",
                    k1_bound_ms_per_forward=forward_k1_bound_ms(synthesis, cond.shape[0],
                                                                dtype))


def summarize_trace(prof, key, span_name, iters, out_dir, layers, phase_name,
                    unit="step", **extra):
    """Write the gzipped chrome trace and summary_<key>.json under out_dir:
    device time by kernel, K1 and K2 totals (and K1 per layer when `layers`
    names them), the busy share and the `extra` fields. The window runs from
    the first to the last timestamp of the host span `span_name` and the
    device events in it, all on the trace's one clock, so the share is at
    most 1."""
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
    # K1's and K2's generic kernels and their instantiations per filter geometry
    k1_events = sorted((e for e in device if "filtered_lrelu_fwd_" in e["name"]),
                       key=lambda e: e["ts"])
    k2_events = [e for e in device if "filtered_lrelu_bwd_" in e["name"]]
    summary = {"leg": key, "iters": iters,
               f"window_ms_per_{unit}": window / 1e3 / iters,
               f"device_ms_per_{unit}": sum(e["dur"] for e in device) / 1e3 / iters,
               "device_busy_share": busy_us(intervals) / window,
               f"k1_ms_per_{unit}": sum(e["dur"] for e in k1_events) / 1e3 / iters,
               f"k2_ms_per_{unit}": sum(e["dur"] for e in k2_events) / 1e3 / iters,
               "k1_calls": len(k1_events), "k2_calls": len(k2_events), **extra,
               "top": top}
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
    for dtype, batch, impl in (("bfloat16", 16, "xla"), ("bfloat16", 32, "xla"),
                               ("float32", 16, "xla"), ("bfloat16", 16, "int8")):
        model = shipped_model(dtype)
        set_matmul_precision(dtype)
        set_conv_impl(impl)
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
        key = f"{dtype}_b{batch}" + ("" if impl == "xla" else f"_{impl}")
        legs[key] = float(np.median(rates))
        phase("6 generator forward", leg=key, slices_per_s=legs[key],
              spread=sorted(rates), ms_per_batch=1e3 * batch / legs[key],
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if trace_dir is not None:
            # float32 with TF32 off launches ~33,600 kernels a forward (cuDNN's
            # FFT convs): one forward, or the profiler may drop an event
            trace_leg(model, inputs, key, 1 if dtype == "float32" else 5,
                      trace_dir, getattr(torch, dtype))
        set_conv_impl("xla")
    return legs


def unequal_elements(got, want):
    """(count of elements whose bits differ, max |difference|)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.bfloat16:
        differ = got.view(torch.int16) != want.view(torch.int16)
    else:
        differ = got != want
    count = int(differ.sum())
    err = float((got.double() - want.double()).abs().max()) if count else 0.0
    return count, err


def check_probe_kernels(device):
    """Phase 9a: every probe kernel against its plain version, at a small
    and at a full shape. All are exact: any unequal element fails. Returns
    {kernel: (unequal, max_abs_err, plain_ms at the full shape)}."""
    gen = probes.device_generator(device, SEED + 40)
    results = {}

    def hold(kernel, size, fn, plain, *args, note=None):
        before = dict(ps.launches), dict(p8.launches)
        got = fn(*args)
        torch.cuda.synchronize()
        launched = sum(ps.launches.values()) + sum(p8.launches.values()) \
            - sum(before[0].values()) - sum(before[1].values())
        want = plain(*args)
        unequal, err = unequal_elements(got, want)
        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=0) if size == "full" else None
        phase("9a probe kernel vs plain", kernel=kernel, size=size,
              **({"note": note} if note else {}), out=list(got.shape),
              unequal_elements=unequal, max_abs_err=err, launches=launched,
              plain_ms=plain_ms)
        if unequal or launched != 1:
            raise AssertionError(f"{kernel} ({size}): {unequal} elements differ from the "
                                 f"plain version, {launched} launches")
        old = results.get(kernel, (0, 0.0, None))
        results[kernel] = (old[0] + unequal, max(old[1], err),
                           plain_ms if plain_ms is not None else old[2])
        del got, want
        torch.cuda.empty_cache()

    name, c0, h, w, rep = fir_roofline.SHAPES[0]
    for size, shape in (("small", (8, 16, 24)), ("small", (5, 7, 9)),
                        ("full", (fir_roofline.BATCH * c0 * rep, h, w))):
        x = probes.randn_bf16(shape, device, gen)
        hold("copy", size, ps.stream_copy, ps.stream_copy_plain, x)
        hold("wr4x", size, ps.stream_wr4x, ps.stream_wr4x_plain, x)
        hold("chain", size, ps.stream_chain, ps.stream_chain_plain, x)
        del x
        x4 = probes.randn_bf16((shape[0], 4) + shape[1:], device, gen)
        hold("rd4x", size, ps.stream_rd4x, ps.stream_rd4x_plain, x4)
        del x4
    for size, shape, cb, cols, br in (("small", (8, 9, 276), 2, 72, 5),
                                      ("full", stream_diag.SHAPES[0][1:], 8,
                                       stream_diag.FLAT_COLS, 4096)):
        x = probes.randn_bf16(shape, device, gen)
        hold("copy3d", size, lambda t: ps.copy3d(t, cb), ps.stream_copy_plain, x,
             note=f"cb={cb}")
        flat = x.reshape(-1, cols)
        hold("copy2d", size, lambda t: ps.copy2d(t, br), ps.stream_copy_plain, flat,
             note=f"br={br}, {flat.shape[0]} rows")
        del x, flat
    xw = torch.randn((element_windows.C, element_windows.H, element_windows.W),
                     generator=gen, device=device)
    for label, n_t, stride, lo, c_out in element_windows.CASES:
        kw = dict(win_w=element_windows.WIN, n_tw=n_t, stride_w=stride, lo_w=lo, c_out=c_out)
        hold("windows", "small", lambda t: ps.element_windows(t, **kw),
             lambda t: ps.element_windows_plain(t, **kw), xw, note=label)
    for label, planes, in_size, _, (t, win, stride, lo, tiles) in \
            element_windows.variant_geometry(small=False):
        xv = torch.randn((planes, in_size, in_size), generator=gen, device=device)
        kw = dict(win_w=win, n_tw=tiles, stride_w=stride, lo_w=lo, win_h=win, n_th=tiles,
                  stride_h=stride, lo_h=lo)
        hold("windows", "full" if label.startswith("A") else "full (not timed)",
             lambda t: ps.element_windows(t, **kw),
             lambda t: ps.element_windows_plain(t, **kw), xv, note=label)
        del xv
    for size, (o, i, l, k) in (("small", (128, 64, 128, 2)), ("full", int8_matmul.SHAPES[0])):
        a, b = probes.randint8((o, i), device, gen), probes.randint8((k, i, l), device, gen)
        hold("stacked_matmul", size, p8.stacked_matmul_int8, p8.stacked_matmul_int8_plain,
             a, b, note="b [K, I, L]")
        bt = b.transpose(1, 2).contiguous()
        del b
        hold("stacked_matmul", size + " (not timed)" if size == "full" else size,
             lambda u, v: p8.stacked_matmul_int8(u, v, "kli"),
             lambda u, v: p8.stacked_matmul_int8_plain(u, v, "kli"), a, bt,
             note="b [K, L, I]")
        del a, bt
    for size, (o, i, cols, wp, steps) in (
            ("small", (128, 64, 128, 21, 2)),
            ("full", (int8_kernel.O, int8_kernel.I, int8_kernel.COLS, int8_kernel.WP,
                      int8_kernel.STEPS))):
        w9 = probes.randint8((9, o, i), device, gen)
        x = probes.randint8((steps, i, int8_kernel.window(cols, wp)), device, gen)
        for mode in p8.MODES:
            hold("nine_tap", size if mode == "slices" or size == "small"
                 else size + " (not timed)",
                 lambda u, v: p8.nine_tap_int8(u, v, mode, cols, wp),
                 lambda u, v: p8.nine_tap_int8_plain(u, v, mode, cols, wp), w9, x, note=mode)
        del w9, x
    return results


def run_probes(checked):
    """Phases 9b and 9c: the five probe entry points at full size on the
    card, then one kernels-line entry per probe kernel from their rows.
    Every probe kernel must have been launched by the entry points."""
    ps.reset_launches()
    p8.reset_launches()                         # the probe entry points' run starts here
    tables = {}
    for module in (fir_roofline, stream_diag, element_windows, int8_matmul, int8_kernel):
        name = module.__name__.rsplit(".", 1)[1]
        print(f"--- 9b python -m {module.__name__}", flush=True)
        tables[name] = module.main([])
    launches = {**ps.launches, **p8.launches}
    phase("9b probe launches", **launches)
    missing = [k for k, v in launches.items() if not v]
    if missing:
        raise AssertionError(f"the probe entry points launched no {missing}")
    bad = [r["case"] for r in tables["element_windows"] if "case" in r and not r["ok"]]
    if bad:
        raise AssertionError(f"element_windows: {bad} differ from the numpy reference")

    hbm = probes.HBM_BYTES_PER_S
    fir = tables["fir_roofline"][0]
    diag = {(r["shape"], r["kernel"], r["block"]): r for r in tables["stream_diag"]}
    win = next(r for r in tables["element_windows"] if r.get("variant", "").startswith("A"))
    mm = tables["int8_matmul"][0]
    taps = {r["mode"]: r for r in tables["int8_kernel"]}
    shape = f"{fir['shape']} x{fir_roofline.BATCH} ({fir['planes']} planes of {fir['h']}x{fir['w']} bf16)"
    src = "afcm_tpu_torch/csrc/probe_stream.cu"
    entries = []

    def entry(name, kernel, source, replaces, ms, bound_ms, bound_by, library_ms, library,
              timed_at, **more):
        unequal, err, plain_ms = checked[kernel]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "path": "probe entry point", "launches": launches[kernel],
                        "max_abs_err": err, "unequal_elements": unequal, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "library": library, "timed_at": timed_at,
                        **more})

    for kernel, line in (("copy", 81), ("wr4x", 94), ("rd4x", 112), ("chain", 130)):
        nb = fir["bytes"][kernel]
        entry(f"probe_stream_{kernel}", kernel, src, f"scripts/probe_fir_roofline.py:{line}",
              fir[f"{kernel}_ms"], 1e3 * nb / hbm, "bytes",
              fir["library_copy_ms"] if kernel == "copy" else None,
              "Tensor.copy_" if kernel == "copy" else None, shape,
              gbps=fir[f"{kernel}_gbps"])
    first = stream_diag.SHAPES[0][0]
    for kernel, key, line in (("copy3d", (first, "copy3d", "cb=8"), 39),
                              ("copy2d", ("flat", "copy2d", "br=4096"), 49)):
        row, lib = diag[key], diag[(key[0], "library-mult", "")]
        entry(f"probe_stream_{kernel}", kernel, src, f"scripts/probe_stream_diag.py:{line}",
              row["ms"], 1e3 * row["bytes"] / hbm, "bytes", lib["ms"],
              "x * 1.0009765625 (torch elementwise)",
              f"{key[0]} {key[2]}, {row['bytes'] / 2e6:.0f} MB bf16", gbps=row["gbps"])
    entry("probe_stream_windows", "windows", src, "scripts/probe_element_windows.py:41",
          win["ms"], 1e3 * win["moved_bytes"] / hbm, "bytes", None, None,
          f"the fused kernel's windows at {win['variant']}: {win['tiles']} windows of "
          f"{win['window']}^2 per plane, {win['planes']} planes of {win['in_size']}^2 fp32",
          gbps=win["moved_gbps"], window_read_gbps=win["read_gbps"])
    entry("probe_int8_stacked_matmul", "stacked_matmul", "afcm_tpu_torch/csrc/probe_int8.cu",
          "scripts/bench_int8_matmul.py:37", mm["kernel_ms"], mm["bound_ms"], mm["bound_by"],
          mm["int_mm_ms"] if mm["int_mm_ms"] is not None else mm["bf16_ms"],
          "torch._int_mm per k" if mm["int_mm_ms"] is not None else
          "torch.matmul in bf16 (this torch has no _int_mm for the shape)",
          f"[{mm['o']},{mm['i']}] @ [{mm['k']},{mm['i']},{mm['l']}] int8 -> int32",
          tops=mm["kernel_tops"], kli_ms=mm["kernel_kli_ms"], bf16_matmul_ms=mm["bf16_ms"])
    sl = taps["slices"]
    nbytes = 9 * int8_kernel.O * int8_kernel.I + int8_kernel.STEPS * (
        int8_kernel.I * int8_kernel.window(int8_kernel.COLS, int8_kernel.WP)
        + 2 * int8_kernel.O * int8_kernel.COLS)
    by_ops, by_bytes = 1e3 * sl["ops"] / probes.INT8_OP_PER_S, 1e3 * nbytes / hbm
    entry("probe_int8_nine_tap", "nine_tap", "afcm_tpu_torch/csrc/probe_int8.cu",
          "scripts/diag_int8_kernel.py:38", sl["ms"], max(by_ops, by_bytes),
          "operations" if by_ops >= by_bytes else "bytes", None, None,
          f"mode slices: w9 [9,{int8_kernel.O},{int8_kernel.I}], x [{int8_kernel.STEPS},"
          f"{int8_kernel.I},{int8_kernel.window(int8_kernel.COLS, int8_kernel.WP)}] int8 "
          "-> bf16", tops=sl["tops"],
          modes_ms={mode: row["ms"] for mode, row in taps.items()})
    for e in entries:
        phase("9c probe kernel", kernel=e["name"], **{k: e[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed_at")}, rate=e.get("gbps", e.get("tops")),
            rate_unit="GB/s" if "gbps" in e else "TOP/s")
    return entries


def serve_phantom_cli_loop(device):
    """Phase 10: the serve entry point's loop over the phantom, float32
    compute, with the float32 fetch and with tpu.fetch_dtype bfloat16.
    Returns the K1 launches of the two runs."""
    set_matmul_precision("float32")
    model = shipped_model("float32")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    runs, batches = {}, 0
    k1.launches = k1.bwd_launches = k3.launches = 0     # the serve path's run starts here
    for fetch in ("float32", "bfloat16"):
        loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH, seed=SEED)
        forward = make_forward_fn(model, device, seed=SEED, norm_range=loader.norm_range,
                                  fetch_dtype=fetch)
        runs[fetch] = serve.serve_subjects(forward, [loader], os.path.join(out_dir, fetch),
                                           keep_volumes=True)
        runs[fetch]["heads"] = sorted(os.listdir(runs[fetch]["out_dir"]))
        batches += len(loader)
    launches = k1.launches
    (full,), (half,) = (list(runs[f]["volumes"].values()) for f in ("float32", "bfloat16"))
    mse = float(np.mean((full.astype(np.float64) - half) ** 2))
    db = 10 * np.log10(float(full.max() - full.min()) ** 2 / max(mse, 1e-30))
    finite = bool(np.isfinite(full).all() and np.isfinite(half).all())
    heads = runs["bfloat16"]["heads"]
    phase("10 serve loop", compute_dtype="float32", batch=SERVE_BATCH, batches=batches,
          subjects=[runs[f]["subjects"] for f in runs],
          patches_per_s={f: runs[f]["patches_per_s"] for f in runs},
          heads=heads, volume=list(full.shape), finite=finite, bf16_fetch_psnr_db=db,
          bf16_fetch_differs=bool((full != half).any()), k1_launches=launches)
    shutil.rmtree(out_dir, ignore_errors=True)
    if launches != LAYERS_WITH_KERNEL * batches or k1.bwd_launches or k3.launches:
        raise AssertionError(f"{launches} K1 launches for {batches} served batches; want "
                             f"{LAYERS_WITH_KERNEL} per batch and no K2 or K3")
    if not (finite and full.shape == half.shape == (24, 256, 256) and db >= 50
            and any("predictions" in h for h in heads)):
        raise AssertionError(f"bf16-fetched volume {db:.2f} dB from the float32-fetched "
                             f"one (< 50), a bad volume {full.shape} or no NIfTI head "
                             f"in {heads}")
    return launches


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

    builds = _build.load_libraries(["filtered_lrelu", "filtered_lrelu_bwd", "conv_int8",
                                    "quantize_int8", "probe_stream", "probe_int8"])
    for kernel, (_, info) in builds.items():
        ptxas = [line.strip() for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line]
        phase("2 build", kernel=kernel, seconds=info["seconds"],
              library=os.path.relpath(info["path"], REPO), ptxas=ptxas)

    worst, ms, plain_ms, bound = check_variants(device)
    check_generator(device)

    k1.launches = k1.bwd_launches = k3.launches = 0    # the serving path's run starts here
    batches = sum(serve_phantom(device, dt)
                  for dt in ("bfloat16", "float32"))
    serve_launches = (k1.launches, k1.bwd_launches, k3.launches)
    if serve_launches != (LAYERS_WITH_KERNEL * batches, 0, 0):
        raise AssertionError(f"{serve_launches} K1/K2/K3 launches for {batches} "
                             f"batches; want {LAYERS_WITH_KERNEL} K1 per batch")
    time_forward(device, args.trace)

    bwd_worst, bwd_ms, bwd_plain_ms, bwd_bound = check_backward_variants(device)
    check_generator_backward(device)
    run_dir, train_launches = train_shipped(device, args.trace)
    serve_trained(device, run_dir)
    shutil.rmtree(os.path.dirname(run_dir), ignore_errors=True)

    unequal, int8_worst = check_conv_int8()
    quantizer_unequal, quantizer_worst = check_quantizers()
    int8_sums = time_conv_int8()
    check_ste_backward()
    time_ste_backward()
    check_generator_int8(device)
    int8_launches = serve_phantom_int8(device)
    probe_entries = run_probes(check_probe_kernels(device))
    cli_serve_launches = serve_phantom_cli_loop(device)
    phase("launches by path", serve={"filtered_lrelu": serve_launches[0],
                                     "filtered_lrelu_bwd": serve_launches[1],
                                     "conv_int8": serve_launches[2]},
          train=train_launches,
          serve_int8={"filtered_lrelu": int8_launches[0],
                      "conv_int8": int8_launches[1],
                      "quantize_int8": int8_launches[2],
                      "quantize_weights_int8": int8_launches[3]},
          probes={e["name"]: e["launches"] for e in probe_entries},
          serve_entry_point={"filtered_lrelu": cli_serve_launches})
    if not train_launches["filtered_lrelu_bwd"]:
        raise AssertionError("the training path launched no K2")
    if not all(int8_launches[1:]):
        raise AssertionError(f"the int8 serving path's K3 and quantizer launches: "
                             f"{int8_launches[1:]}")

    jax_loaded = [m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in ("jax", "flax", "optax",
                                                             "afcm_tpu")]
    if jax_loaded:
        raise AssertionError(f"the port's path loaded {jax_loaded[:5]}")

    print(json.dumps({"kernels": [
        {"name": "filtered_lrelu", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:273",
         "launches": serve_launches[0] + train_launches["filtered_lrelu"]
         + int8_launches[0] + cli_serve_launches,
         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
         "timed_at": "the four filter variants' layer shapes, batch 2, fp32, summed"},
        {"name": "filtered_lrelu_bwd", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu_bwd.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:292",
         "launches": train_launches["filtered_lrelu_bwd"],
         "max_abs_err": bwd_worst, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None,
         "timed_at": "the four filter variants' layer shapes, batch 2, fp32, summed"},
        {"name": "conv_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/conv_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:129",
         "launches": int8_launches[1],
         "max_abs_err": int8_worst, "unequal_elements": unequal,
         "ms": int8_sums["ms"], "plain_ms": int8_sums["plain_ms"],
         "bound_ms": int8_sums["bound"][0], "bound_by": int8_sums["bound"][1],
         "library_ms": int8_sums["library_ms"],
         "library": "cuDNN's bf16 conv (F.conv2d) of the same quantized integers",
         "timed_at": "the int8 path's three conv shapes (512 -> 512 at 36^2 and "
                     "52^2 p2, 38^2 p0), batch 16, one call each, summed",
         "autograd": "K4 = conv3x3_int8_ste: K3 forward, fp32 conv adjoint backward"},
        {"name": "quantize_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/quantize_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:258-262",
         "launches": int8_launches[2],
         "max_abs_err": quantizer_worst["activations"],
         "unequal_elements": quantizer_unequal["activations"],
         "ms": int8_sums["qx_ms"], "plain_ms": int8_sums["qx_plain_ms"],
         "bound_ms": int8_sums["qx_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "timed_at": "the int8 path's three conv inputs (512 channels at 36^2 and 52^2 "
                     "p2, 38^2 p0), batch 16, bf16, one call each (amax and "
                     "quantize-and-pack kernels), summed"},
        {"name": "quantize_weights_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/quantize_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:276-280",
         "launches": int8_launches[3],
         "max_abs_err": quantizer_worst["weights"],
         "unequal_elements": quantizer_unequal["weights"],
         "ms": int8_sums["qw_ms"], "plain_ms": int8_sums["qw_plain_ms"],
         "bound_ms": int8_sums["qw_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "timed_at": "the int8 path's 512 -> 512 3x3 weights, float32, one call per "
                     "routed shape, summed"},
        *probe_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
