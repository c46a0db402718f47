#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace DIR]

Drives the port's main paths — CMSR serving with the shipped ADNI alias-free
generator, the CMSR training step of that generator and its discriminator,
the int8 serving path (tpu.conv_int8 True), all at full width and depth
(random weights from a seed), the five measurement probes, the serve entry
point's loop, the serving export, the CoModGAN baseline's serving,
int8 and training paths, the pix2pix baseline's training, and the CMSR
train step under remat, with style mixing and under the int8 conv, with the
StyleGAN-V family and grid_sample held against the CPU, reference AFCM
checkpoints converted and served, and the model axis (tensor parallelism)
on two ranks sharing the card — and checks the
hand-written kernels on them: K1
and K2 (the fused filtered leaky ReLU forward and backward, bound as the
torch.library operators afcm_tpu_torch::filtered_lrelu{,_bwd}), K3 (the int8 3x3 conv
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
   and img/s over 3 windows with the spread, peak memory; then three fp32
   b16 steps in a fresh process through the train CLI's entry
   (train.main), so that cuDNN plans them under the train path's 4 GiB
   workspace cap (train.bound_conv_workspace; this process has planned
   convs under PyTorch's default): finite losses, 28 K1 and 28 K2 a step,
   the cap in force, ms/step and the peak (a phase line says so if they do
   not fit the card; phase 16 reuses the run); (d) the trained EMA
   generator, saved as
   latest_net_G_ema.pth, served through serve_and_score. With --trace DIR
   one bf16 train step is traced too;
8. the int8 path: (a) K3 against its plain version on quantized inputs drawn
   on the card from the seed, batch 2, at the path's shapes (512 -> 512 at
   36^2 and 52^2, padding 2, and 38^2 without padding), at 362 -> 512 148^2,
   91 -> 128 and 64 -> 64 at 276^2, and with padding 1 and 0 and an
   extra_scale, and at batch 16 at the CoModGAN path's shapes (512 -> 512
   at 10^2, 18^2 and 34^2 without padding): the bf16 outputs are equal bit for bit (the count of
   unequal elements is printed and must be 0), and the whole quantized conv
   is >= 50 dB from the fp32 conv of the unquantized inputs; the activation
   and the weight quantizer kernels against their plain versions (packed
   int8 tensor and scales) at the three routed shapes and a ragged one,
   float32 and bfloat16, with an all-zero sample: 0 unequal elements;
   (b) timing at batch 16 of every distinct 3x3 conv shape of the
   generator: K3 alone with the idle share of its pixel tiles, the
   quantizer kernels (the activations' beside both bounds, x read once and
   twice, and torch.linalg.vector_norm(x, inf) as the time of their amax
   half alone) and their plain versions, quantize + K3 (the fused path the
   wrapper takes), the float conv the path makes with the knob off
   (conv2d_gradfix.conv2d in bf16), cuDNN's bf16 conv of the same quantized
   integers, and the plain version, beside the bound; the calls in turns
   by utils/profiling.time_windows (median of 5 windows of 10 behind a
   device sleep long enough for the host to enqueue them: device time, not
   dispatch; the same x each call, so warm in L2), the plain versions the
   median of 3 calls; (c) K4's dx and dw
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
9. the probes: (a) each of the ten probe kernels (copy, wr4x, rd4x, chain,
   copy3d, copy2d, windows, stacked_matmul, nine_tap in three modes,
   slice_sum for the fourth, sliceonly) at a small shape and at a full one
   against its plain version, one launch under its own count (copy3d and
   copy2d at every cb and br of stream_diag, the small ones also from a view
   2 bytes off a 16-byte boundary): every one is exact, the count of
   unequal elements is printed and must be 0, and wr4x's library call
   (x.unsqueeze(1) * s) is held to its plain version the same way (rd4x's,
   x4.sum(1), rounds once: its largest difference is printed); (b) the
   five entry points (afcm_tpu_torch.probes.*.main) at full size, their
   tables printed, each kernel launched at least once; (c) per kernel its
   time, rate, bound and the library call's time (Tensor.copy_ for the
   three copies, x4.sum(1) for rd4x, with the spread of both over the
   probes' windows);
10. the serve entry point's loop (afcm_tpu_torch.serve.serve_subjects) over
   the phantom at full width in float32, with the float32 fetch and with
   tpu.fetch_dtype bfloat16: 28 K1 launches per batch, the bf16-fetched
   volume >= 50 dB from the float32-fetched one, NIfTI heads written;
11. the serving export (afcm_tpu_torch.infer.export): (a) the host's cost
   of a filtered_lrelu call through the custom operator against K1's launch
   alone (µs a call; 28 calls against 2% of the bf16 b16 forward); the
   shipped generator exported at bf16 b16 with uint8 ingest: its MB and its
   28 filtered_lrelu nodes, then served over the phantom by
   serve.serve_subjects in a fresh Python process that imports only the
   port, whose volume must equal the in-process one within 1e-4 * max (bit
   equality printed) with 28 K1 launches per batch; the bf16-fetch artifact
   >= 50 dB from the float32-fetched one, a symbolic-batch artifact at batch
   1 and 16, a bf16-weights artifact < 0.65x the size and > 40 dB from the
   float one; the artifact's forward and the in-process forward timed
   (slices/s, median of 3 windows);
12. the CoModGAN baseline (configs/adni/comodgan/ccsr.yml, random weights):
   (a) the phantom through serve_and_score under compute dtype bf16 (G in
   float32, TF32 on): finite volume and scores, no K1 launch, the forward
   timed at b16 (with --trace DIR traced too); (b) the routed conv shapes
   timed as in 8b, the activation quantizer also on the float32 x this
   path quantizes; (c) the phantom under tpu.conv_int8 True: 9 launches of
   K3 and of each quantizer per batch, >= 30 dB from the float volume; (d)
   the train CLI's loop on the config at bf16 b16: finite losses, no K1 or
   K2, w_avg moved in G and G_ema, ms/step and img/s (median of 3 windows),
   peak memory; (e) the EMA generator exported and served from a fresh
   process equal to in-process, with no filtered_lrelu node;
13. the pix2pix baseline (configs/adni/base.yml with the channel counts of
   the 4-slice window, model.G.input_nc 4 model.D.input_nc 5; random
   weights): (a) the full-width UNet G and PatchGAN D at batch 2, fp32 with
   TF32 off, on the card against the same modules on the CPU with the same
   weights and dropout masks: G's output and the statistics G and D move in
   a train-mode step, each within 1e-3 * max|CPU|, and the gradients of a
   step's D and G losses on the running statistics, per net within 1e-3 in
   ||card - CPU|| / ||CPU|| (or 10x the float32 rounding floor measured on
   the CPU, where larger; each tensor's error printed); the train-mode
   step's gradients printed;
   (b) the train CLI's loop at b32 over a phantom subject: finite losses,
   every running statistic of G and D moved, no launch of a kernel of the
   port, median ms/step and img/s over 3 windows with the spread, peak
   memory; (c) the saved latest_net_G.pth loaded into a freshly built model
   gives the live model's output on a val batch, bit for bit;
14. the StyleGAN-V generator and discriminator at 256^2 and the CCSR
   config's widths, batch 4, fp32 with TF32 off, on the card against the
   CPU: the outputs within 1e-3 * max|CPU|, every parameter's gradient per
   net as in 13a; grid_sample (built from gathers) against F.grid_sample within
   1e-5 on an affine warp of a [32, 5, 256^2] discriminator input, both
   timed, and its backward;
15. data parallelism (afcm_tpu_torch.parallel): (a) the train CLI's loop
   at bf16 b16 as the one rank of an NCCL process group, its losses step by
   step against 7c's one-process run from the same seed (bit equality
   printed; held within 1e-3), 28 K1 and 28 K2 launches per step, ms/step
   beside 7c's; (b) two gloo ranks sharing the card, one fp32 step (TF32
   off) of the shipped config on a global batch of 16, against one process
   on the whole batch: losses within rtol 1e-4, each net's all-reduced
   gradient within 1e-4 in L2 or 10x the float32 rounding floor measured
   on the card, the collective census per step and K1/K2 launches per rank
   printed; (c) the phantom served at fp32 over the mesh [cuda:0, cuda:0]
   (two replicas, 56 K1 launches per batch) within 1e-4 * max of one
   device's (bit equality printed), and the artifact exported over that
   mesh served over it within 1e-4 * max of the in-process mesh volume;
16. tpu.remat and the train path's conv workspace (ROADMAP C12): the train
   step at bf16 b16 and fp32 b16, each (dtype, workspace policy, remat
   setting) in a fresh process through the train CLI's entry (train.main,
   three steps, its checkpoint and validation): at fp32 PyTorch's default
   cuDNN planning ("plain") at remat off and 0, and the train path's policy
   (train.bound_conv_workspace, "train": a 4 GiB cap at fp32, the default
   at bf16) at off (7c's fp32 run), 148 and 0; the peak over a step after a
   warm one and
   ms/step printed per setting; under the train path's policy, at both
   dtypes, the peak falls from off to 148 to 0, K1 launches per step are 28
   + the rematted layers that launch K1 (28 K2), and the first step's
   gradients are within 1e-5 * max of remat off (bit equality printed); at
   fp32 its remat-off gradients within 1e-3 * max of the plain ones, and
   the plain policy's remat-0 gradients within 1e-3 * max of its remat-off
   ones (each fresh process plans its own algorithms there);
17. style mixing (style_mixing_prob 0.9) in the shipped config's train
   step at bf16 b16: with the coin false and the draws given, the step
   equals the unmixed one (losses and gradients within 1e-5 * max); with
   it true the styles from the cutoff on are the second latent's mapping;
   the mixed step drawing its own draws: 28 K1 and 28 K2 per step, ms/step
   and peak beside the unmixed step's;
18. the shipped config's train step at bf16 b16 under conv impl 'int8'
   (K4 in training: K3 and its quantizers forward, the fp32 conv adjoint
   backward, also in R1's double backward through D's routed convs): K3
   and each quantizer launched once per routed conv of each step, every
   routed conv's backward (dx, dw) in the step within 1e-4 in relative L2
   of the fp32 conv adjoint at its own inputs, G's gradients >= 30 dB from
   the float step's, ms/step and peak beside it;
19. reference AFCM checkpoints (afcm_tpu_torch.utils.port): (a) the shipped
   CMSR G_ema written as a reference 50_net_G_ema.pth (its state_dict and
   the construction-time filter buffers the reference registers), refused
   by the strict load (the keys it names printed), converted by python -m
   afcm_tpu_torch.utils.port in a subprocess and loaded by
   evaluate.load_generator_ema: the phantom through serve_and_score at
   bf16 b16 equals the directly loaded weights' volume bit for bit, with 28
   K1 launches a batch; (b) the same for the CCSR CoModGAN G with channel
   attention (its CALayer conv_du keys in the file): one batch bit-equal,
   no K1; (c) SynthesisInput (w_dim 512, 512 channels, 36^2), the
   StyleGAN-V D at architecture orig (CCSR widths) and the CCSR D with
   block_kwargs resample_filter [1, 2, 1], b4, on the card against the CPU
   as in 13a;
20. the model axis (parallel.tensor): two gloo ranks sharing the card at
   mesh (1, 2) on the shipped CMSR config, each holding its slices of the
   parameters the placement rule shards, at fp32 (TF32 off) and at bf16,
   b4: (a) the sharded G_ema forward against the unsharded forward in this
   process, at fp32 within 1e-3 * max, 28 K1 launches per rank (on channel
   slices where a layer is sharded); (b) one train step against one
   process at the same inputs and draws, at fp32 the losses within rtol
   1e-4 and the whole gradients within 1e-4 in relative L2 or 10x the
   rounding floor (bf16's own floor at b4 is percents: its errors are
   printed), every rank holding the same whole gradients, the census per
   purpose and each rank's peak; (c) the times at bf16. The same two ranks
   then run the shipped CCSR CoModGAN (configs/adni/comodgan/ccsr.yml at
   full width, its G sharded in SynthesisLayerSG2 and the encoder's and
   mapper's layers), b4: (d) the sharded G_ema forward at fp32 within
   1e-3 * max of one process's; (e) one fp32 train step with R1 against
   one process's at the same inputs, noise and co-modulation dropout,
   held as (b); (f) the sharded forward under tpu.conv_int8: K3 and both
   quantizers once per routed conv on each rank (9 each), every K3 call's
   output on the rank's 256-channel slice bit-equal to K3's plain version,
   the output within 8d's 1e-2 * max of one process's int8 forward or 10x
   the floor of a 2^-24 nudge (the sliced convs' last bits move single
   quantization steps).

Then prints the total seconds, the kernels' JSON line (per kernel: launches on its main paths,
error, time, plain version's time, the bound from the bytes and operations
of the timed inputs, the library call's time where there is one) and, last,
{"ok": true, "device": ...}. Any failure raises and exits non-zero; without CUDA nothing is printed.
Needs torch with CUDA, nvcc, numpy, scipy and yaml (the training config);
no h5py or JAX: it imports only the port, afcm_tpu_torch, and fails if
anything loaded jax, flax, optax or the JAX package afcm_tpu.
"""

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
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
from afcm_tpu_torch import parallel, probes, serve
from afcm_tpu_torch import train as train_cli
from afcm_tpu_torch.data.demo import phantom_test_loader, phantom_train_loaders
from afcm_tpu_torch.evaluate import (configure_numerics, load_generator_ema,
                                     make_forward_fn, normalize_uint8, serve_and_score,
                                     set_matmul_precision)
from afcm_tpu_torch.infer import export
from afcm_tpu_torch.models import (CMSR_ADNI_G, StyleMix, build_eval_model,
                                   build_generator, build_model)
from afcm_tpu_torch.models.losses import gan_loss, l1_loss
from afcm_tpu_torch.nn import CoModDiscriminator, SynthesisInput, motion
from afcm_tpu_torch.ops import (conv2d_gradfix, get_conv_impl, grid_sample, modulated_conv,
                                set_conv_impl)
from afcm_tpu_torch.ops.cuda import _build
from afcm_tpu_torch.ops.cuda import conv_int8 as k3
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1
from afcm_tpu_torch.ops.cuda import probe_int8 as p8
from afcm_tpu_torch.ops.cuda import probe_stream as ps
from afcm_tpu_torch.parallel.check import grad_errors, train_step_check
from afcm_tpu_torch.probes import (element_windows, fir_roofline, int8_kernel,
                                   int8_matmul, stream_diag)
from afcm_tpu_torch.utils.nifti import read_nifti
from afcm_tpu_torch.utils.port import DROP_LEAVES
from afcm_tpu_torch.utils.profiling import cuda_median_ms, cuda_ms, time_windows

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
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
# The CoModGAN baseline (configs/adni/comodgan/ccsr.yml): mode 'int8' routes
# nine 512 -> 512 convs a batch, padding 0, at these input sizes (the
# encoder's conv_layer0 and conv0/conv1 of blocks b8, b16, b32); its 6^2
# convs are declined. tests/test_torch_comodgan.py holds the count.
CCSR_CONFIG = os.path.join(REPO, "configs/adni/comodgan/ccsr.yml")
COMOD_INT8_SIZES = (10, 18, 34)
COMOD_INT8_ROUTED = 9
PHANTOM_RANGE = (0.0, 255.0)   # the phantom loader's Normalize range: uint8 ingest
PHANTOM_SHAPE = (24, 256, 256)  # the served phantom subject
COND_SHAPE = (4, 256, 256)      # a batch element: the 4-slice window
# Published peaks of one H100 SXM (dense): the rates the bounds are taken at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
TRAIN_CONFIG = os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml")
TRAIN_BATCH = 16
WARM_STEPS, WINDOW_STEPS, WINDOWS = 3, 4, 3
# The pix2pix baseline of configs/adni/base.yml (unet_256 ngf 64, basic D
# ndf 64, b32). As shipped its channel counts are the pix2pix defaults, 1
# and 2, which the 4-slice window does not fit (ROADMAP C8): these make it
# run.
PIX2PIX_CONFIG = os.path.join(REPO, "configs/adni/base.yml")
PIX2PIX_CHANNELS = ("model.G.input_nc", "4", "model.D.input_nc", "5")
PIX2PIX_BATCH = 32
# The StyleGAN-V family at the CCSR config's widths (channel_base 16384,
# channel_max 512, 256^2, the 4-slice window in) with StyleGAN-V's motion
# defaults (512-d motion codes, a knot every 32 frames, 11-tap trajectory
# convs, 256 aligned time frequencies over periods of 16-1024 frames).
STYLEGANV_G = dict(
    z_dim=512, c_dim=1, w_dim=512, motion_v_dim=512, img_resolution=256,
    img_channels_in=4, img_channels_out=1, max_num_frames=1024,
    mapping_kwargs=dict(num_layers=8),
    synthesis_kwargs=dict(channel_base=16384, channel_max=512, skip_resolution=256,
                          cond_mod=True, global_enc=True),
    motion_mapping_kwargs=dict(motion_z_dim=512, motion_z_distance=32, motion_kernel_size=11,
                               time_encoder_kwargs=dict(dim=256, min_period_len=16,
                                                        max_period_len=1024)))
STYLEGANV_D = dict(c_dim=1, img_resolution=256, img_channels=1, num_frames=3,
                   channel_base=16384, channel_max=512, concat_res=16,
                   num_frames_div_factor=4, max_num_frames=1024)
MOTION_BATCH = 4


# the host clock at import: each phase line says when it was printed
STARTED = time.perf_counter()


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


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


def train_argv(out_dir, compute_dtype, *opts):
    """The train CLI's arguments for the shipped CMSR training config
    (configs/adni/stylegan3/cmsr.yml: b16, shared G forward, R1 every step,
    blur sigma 10 fading over 100 kimg) with its periodic display, printing
    and saving turned off, on the one-device mesh [1, 1], and ``opts``
    (KEY VALUE ...) over it."""
    never = str(10 ** 9)
    return ["--config-file", TRAIN_CONFIG, "tpu.compute_dtype", compute_dtype,
            "checkpoints_dir", out_dir, "name", f"smoke_{compute_dtype}",
            "trainer.display_freq", never, "trainer.print_freq", never,
            "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never,
            "tpu.mesh_shape", "[1, 1]", *opts]


def train_config(out_dir, compute_dtype, *opts):
    """The config of ``train_argv``."""
    from afcm_tpu_torch.config import default_argument_parser
    return default_argument_parser(train_argv(out_dir, compute_dtype, *opts))


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
    """Phase 7c: the train CLI's loop on the shipped config, bf16 b16;
    returns the run's directory (its fp32 leg is ``train_fp32``)."""
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
    reference = {"metrics": monitor.metrics[:WARM_STEPS + WINDOW_STEPS],
                 "ms_per_step": float(np.median(ms))}
    torch.cuda.empty_cache()
    return os.path.join(out_dir, cfg.name), launches, reference


def train_fp32(grads_dir):
    """Phase 7c's fp32 leg: three fp32 b16 steps of the shipped config in a
    fresh process through the train CLI's entry, so that cuDNN plans them
    under the train path's workspace cap (``train.bound_conv_workspace``,
    which ``train.main`` sets before the process's first conv; this
    process has run convs under PyTorch's default planning, ROADMAP C13).
    Phase 16 reuses the run as its (float32, train policy, remat off)
    setting. Returns the setting's row."""
    row = run_setting("float32", "train", None, grads_dir)
    phase("7c train fp32 b16", planned_by="train.main -> train.bound_conv_workspace "
          "(a fresh process; phase 16's float32 train-policy remat-off setting)", **row)
    if not row["fits"]:
        return row
    if not row["losses_finite"]:
        raise AssertionError("non-finite losses in the fp32 train steps")
    if row["workspace_cap_mib"] != train_cli.CONV_WORKSPACE_MIB:
        raise AssertionError(f"the fp32 leg planned without the train path's cap: {row}")
    if row["launches_per_step"] != [[LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL]]:
        raise AssertionError(f"fp32 K1/K2 launches per step {row['launches_per_step']}, "
                             f"want {LAYERS_WITH_KERNEL} each")
    return row


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
    """Seeded (x, w, extra_scale) of one conv, drawn on the card (phase 8b
    draws up to 156 M values a shape at batch 16), and the quantized
    operands: integer values, scale, packed int8 tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, i, h, h), generator=gen, device="cuda")
    w = torch.randn((o, i, 3, 3), generator=gen, device="cuda") / float(np.sqrt(9 * i))
    es = torch.rand((n, o), generator=gen, device="cuda") + 0.5 if extra else None
    xq, x_scale = k3.quantize_activations(x)
    wq, w_scale = k3.quantize_weights(w)
    scale = k3.dequant_scale(x_scale, w_scale, es)
    return x, w, es, xq, wq, scale, k3.pack_activations(xq, p), k3.pack_weights(wq)


def check_conv_int8():
    """Phase 8a: K3 against its plain version, bit for bit: batch 2 at the
    StyleGAN3 path's shapes and others, batch 16 at the CoModGAN path's."""
    cases = [(2, 512, 512, 36, 2, False), (2, 512, 512, 52, 2, False),
             (2, 512, 512, 38, 0, False), (2, 362, 512, 148, 2, False),
             (2, 91, 128, 276, 2, False), (2, 64, 64, 276, 2, False),
             (2, 181, 256, 84, 1, True), (2, 91, 181, 40, 0, True)] + \
        [(SERVE_BATCH, 512, 512, h, 0, False) for h in COMOD_INT8_SIZES]
    set_matmul_precision("float32")
    unequal_total, worst = 0, 0.0
    for idx, (n, i, o, h, p, extra) in enumerate(cases):
        x, w, es, xq, wq, scale, xp, wp = int8_case(n, i, o, h, p, extra, SEED + 10 + idx)
        got = k3.int8_conv_cuda(xp, wp, scale, o)
        torch.cuda.synchronize()
        want = k3.int8_conv_plain(xq, wq, scale, p)
        size = h + 2 * p - 2
        if got.shape != want.shape or tuple(got.shape) != (n, o, size, size) \
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
        phase("8a K3 vs plain", channels=[i, o], size=h, padding=p, batch=n,
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
    shapes and a ragged one (batch 3) and the CoModGAN path's three (batch
    16), float32 and bfloat16 inputs, sample 0 all zero.
    Then a NaN in one sample and one weight channel, which must reach the
    scale and the conv's output as in the plain version. Returns per kernel
    the total of unequal elements and the largest |kernel - plain| over the
    packed integers and the scales."""
    cases = [(3, 512, 512, 36, 2), (3, 512, 512, 52, 2), (3, 512, 512, 38, 0),
             (3, 91, 160, 41, 1)] + [(SERVE_BATCH, 512, 512, h, 0) for h in COMOD_INT8_SIZES]
    totals = {"activations": 0, "weights": 0}
    worst = {"activations": 0.0, "weights": 0.0}

    def max_abs(got, want):
        return float((got.double() - want.double()).abs().max())
    for idx, (n, i, o, h, p) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(SEED + 50 + idx)
            x = torch.from_numpy(rng.randn(n, i, h, h).astype(np.float32)).cuda().to(dtype)
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
            phase("8a quantizer vs plain", channels=[i, o], size=h, padding=p, batch=n,
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


def conv_shape_row(i, o, h, p, seed):
    """One conv shape at batch 16: K3 alone with the idle share of its pixel
    tiles, the quantizer kernels and their plain versions, quantize + K3
    (the fused path the wrapper takes), the float conv of the path with the
    knob off (conv2d_gradfix.conv2d in bf16), cuDNN's bf16 conv of the same
    quantized integers, and the plain version, beside the bound. The calls
    take turns in time_windows (device time: median and the fastest and
    slowest of 5 windows), the plain versions the median of 3 calls. At
    the CoModGAN path's shapes the activation quantizer is also timed on
    the float32 x that path quantizes, and the TF32 float conv it runs.
    Returns the row and the bound (ms, bound_by)."""
    x, w, _, xq, wq, scale, xp, wp = int8_case(SERVE_BATCH, i, o, h, p, False, seed)
    size = h + 2 * p - 2
    ops = 2 * 9 * o * i * size * size * SERVE_BATCH
    moved = sum(t.numel() * t.element_size() for t in (xp, wp, scale)) + \
        SERVE_BATCH * o * size * size * 2
    by_ops, by_bytes = 1e3 * ops / INT8_OP_PER_S, 1e3 * moved / HBM_BYTES_PER_S
    least = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes")
    xb, wb = x.bfloat16(), w.bfloat16()
    xqb, wqb = xq.bfloat16(), wq.bfloat16()     # the integers are exact in bf16
    comodgan = i == o == 512 and p == 0 and h in COMOD_INT8_SIZES
    calls = {"k3": lambda: k3.int8_conv_cuda(xp, wp, scale, o),
             "quantize_k3": lambda: k3.conv3x3_int8_cuda(x, w, p),
             "quantize_x_bf16": lambda: k3.quantize_pack_activations_cuda(xb, p),
             "quantize_x_amax_library": lambda: torch.linalg.vector_norm(
                 xb, float("inf"), dim=(1, 2, 3)),
             "quantize_w": lambda: k3.quantize_pack_weights_cuda(w),
             "float_conv_bf16": lambda: conv2d_gradfix.conv2d(xb, wb, padding=p),
             "library": lambda: torch.nn.functional.conv2d(xqb, wqb, padding=p)}
    if comodgan:
        calls["quantize_x_fp32"] = lambda: k3.quantize_pack_activations_cuda(x, p)
        calls["quantize_x_amax_library_fp32"] = lambda: torch.linalg.vector_norm(
            x, float("inf"), dim=(1, 2, 3))
    timed = time_windows(calls, "cuda")
    # the quantizers move x (or w) in once and the packed tensor and scales
    # out; the activations' two-read bound reads x twice
    out_x = xp.numel() + 4 * SERVE_BATCH
    qw_bytes = w.numel() * 4 + wp.numel() + 4 * o
    row = dict(channels=[i, o], size=h, padding=p, batch=SERVE_BATCH,
               routed_by_int8_gate=modulated_conv._int8_gate(x.shape, w.shape),
               g_ops=ops / 1e9, mbytes=moved / 1e6,
               tile_rows=k3.plan_tile_rows(size),
               tile_idle_share=k3.tile_idle_share(size, size))
    for name, t in timed.items():
        row[name + "_ms"], row[name + "_ms_spread"] = t["ms"], [t["lo"], t["hi"]]
    row.update(
        quantize_x_plain_ms=cuda_median_ms(
            lambda: k3.quantize_pack_activations_plain(xb, p), repeats=3, warmup=1),
        quantize_x_bound_ms=1e3 * (xb.numel() * 2 + out_x) / HBM_BYTES_PER_S,
        quantize_x_two_read_bound_ms=1e3 * (xb.numel() * 4 + out_x) / HBM_BYTES_PER_S,
        quantize_w_plain_ms=cuda_median_ms(
            lambda: k3.quantize_pack_weights_plain(w), repeats=3, warmup=1),
        quantize_w_bound_ms=1e3 * qw_bytes / HBM_BYTES_PER_S,
        plain_ms=cuda_median_ms(
            lambda: k3.int8_conv_plain(xq, wq, scale, p), repeats=3, warmup=1),
        bound_ms=least[0], bound_by=least[1])
    row["k3_top_per_s"] = ops / row["k3_ms"] / 1e9
    if comodgan:
        row["quantize_x_fp32_plain_ms"] = cuda_median_ms(
            lambda: k3.quantize_pack_activations_plain(x, p), repeats=3, warmup=1)
        row["quantize_x_fp32_bound_ms"] = 1e3 * (x.numel() * 4 + out_x) / HBM_BYTES_PER_S
        row["quantize_x_fp32_two_read_bound_ms"] = \
            1e3 * (x.numel() * 8 + out_x) / HBM_BYTES_PER_S
        # the CoModGAN generator's float conv: fp32, TF32 as its config sets
        set_matmul_precision("bfloat16")
        tf32 = time_windows({"tf32": lambda: conv2d_gradfix.conv2d(x, w, padding=p)},
                            "cuda")["tf32"]
        row["float_conv_tf32_ms"], row["float_conv_tf32_ms_spread"] = \
            tf32["ms"], [tf32["lo"], tf32["hi"]]
        set_matmul_precision("float32")
    return row, least


def add_conv_sums(sums, row, least, x_dtype="bf16"):
    """Add a routed shape's K3 and quantizer times to the kernels line's
    sums; the activation quantizer's of x in ``x_dtype``."""
    for key in ("ms", "plain_ms", "library_ms"):
        sums[key] += row["k3_ms" if key == "ms" else key]
    sums["bound"] = add_bound(sums["bound"], least)
    qx = "quantize_x_" + x_dtype
    plain = "quantize_x_plain" if x_dtype == "bf16" else qx + "_plain"
    bound = "quantize_x" if x_dtype == "bf16" else qx
    for key, src in (("qx_ms", qx + "_ms"), ("qx_plain_ms", plain + "_ms"),
                     ("qx_bound_ms", bound + "_bound_ms"),
                     ("qx_two_read_bound_ms", bound + "_two_read_bound_ms"),
                     ("qx_amax_library_ms", "quantize_x_amax_library"
                      + ("" if x_dtype == "bf16" else "_fp32") + "_ms"),
                     ("qw_ms", "quantize_w_ms"), ("qw_plain_ms", "quantize_w_plain_ms"),
                     ("qw_bound_ms", "quantize_w_bound_ms")):
        sums[key] += row[src]
    for key, src in (("qx", qx), ("qw", "quantize_w")):
        lo, hi = row[src + "_ms_spread"]
        sums[key + "_spread"] = [sums[key + "_spread"][0] + lo, sums[key + "_spread"][1] + hi]


def conv_sums():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=(0.0, "operations", 0.0),
                qx_ms=0.0, qx_plain_ms=0.0, qx_bound_ms=0.0, qx_two_read_bound_ms=0.0,
                qx_amax_library_ms=0.0, qx_spread=[0.0, 0.0],
                qw_ms=0.0, qw_plain_ms=0.0, qw_bound_ms=0.0, qw_spread=[0.0, 0.0])


def time_conv_int8():
    """Phase 8b: every distinct conv shape of the shipped generator at batch
    16. Returns K3's sums over the shapes mode 'int8' routes (the serving
    path's)."""
    synthesis = shipped_model("bfloat16").generator_ema.synthesis
    sums = conv_sums()
    gated = 0
    for idx, ((i, o, h, p), count) in enumerate(conv3x3_shapes(synthesis).items()):
        row, least = conv_shape_row(i, o, h, p, SEED + 30 + idx)
        phase("8b conv shapes", layers=count, **row)
        if row["routed_by_int8_gate"]:
            gated += count
            add_conv_sums(sums, row, least)
        torch.cuda.empty_cache()
    if gated != INT8_ROUTED:
        raise AssertionError(f"the gate takes {gated} convs of the layout, want {INT8_ROUTED}")
    return sums


def time_comodgan_convs():
    """Phase 12b: the CoModGAN path's routed conv shapes (512 -> 512 at
    10^2, 18^2 and 34^2, padding 0; 3 layers each) at batch 16, as phase 8b
    times its shapes, with the TF32 conv the float leg runs there. Returns
    the sums over the three shapes."""
    sums = conv_sums()
    for idx, h in enumerate(COMOD_INT8_SIZES):
        row, least = conv_shape_row(512, 512, h, 0, SEED + 70 + idx)
        phase("12b CoModGAN conv shapes", layers=3, **row)
        add_conv_sums(sums, row, least, x_dtype="fp32")
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
        before = {**ps.launches, **p8.launches}
        got = fn(*args)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in {**ps.launches, **p8.launches}.items()
                    if v != before[k]}
        want = plain(*args)
        unequal, err = unequal_elements(got, want)
        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=0) if size == "full" else None
        phase("9a probe kernel vs plain", kernel=kernel, size=size,
              **({"note": note} if note else {}), out=list(got.shape),
              unequal_elements=unequal, max_abs_err=err, launches=launched.get(kernel, 0),
              plain_ms=plain_ms)
        if unequal or launched != {kernel: 1}:
            raise AssertionError(f"{kernel} ({size}): {unequal} elements differ from the "
                                 f"plain version, launches {launched}")
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
        lib = unequal_elements(fir_roofline.library_wr4x(x), ps.stream_wr4x_plain(x))
        phase("9a library call vs plain", kernel="wr4x", size=size,
              library="x.unsqueeze(1) * s", unequal_elements=lib[0], max_abs_err=lib[1])
        if lib[0]:
            raise AssertionError(f"wr4x's library call differs from the plain version in "
                                 f"{lib[0]} elements")
        hold("chain", size, ps.stream_chain, ps.stream_chain_plain, x)
        del x
        x4 = probes.randn_bf16((shape[0], 4) + shape[1:], device, gen)
        hold("rd4x", size, ps.stream_rd4x, ps.stream_rd4x_plain, x4)
        phase("9a library call vs plain", kernel="rd4x", size=size, library="x4.sum(1)",
              max_units=fir_roofline.rd4x_units(fir_roofline.library_rd4x(x4),
                                                ps.stream_rd4x_plain(x4), x4),
              units="bf16 units of the largest addend (rounds once, not bit-equal)")
        del x4
    # the copies at every cb and br of stream_diag, and a view 2 bytes off a
    # 16-byte boundary (small: the bulk copy's head, body and tail)
    for size, shape, cbs, cols, brs in (
            ("small", (8, 9, 276), (2,), 72, (5,)),
            ("small", (5, 7, 9), (1,), 3, (2,)),
            ("full", stream_diag.SHAPES[0][1:], stream_diag.CBS, stream_diag.FLAT_COLS,
             stream_diag.BRS)):
        x = probes.randn_bf16(shape, device, gen)
        for off2 in (False, True) if size == "small" else (False,):
            if off2:
                buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=device)
                x = buf[1:1 + x.numel()].view(x.shape).copy_(x)
            label = ", 2 bytes off 16" if off2 else ""
            for cb in cbs:
                hold("copy3d", size, lambda t: ps.copy3d(t, cb), ps.stream_copy_plain, x,
                     note=f"cb={cb}{label}")
            flat = x.view(-1, cols)
            for br in brs:
                hold("copy2d", size, lambda t: ps.copy2d(t, br), ps.stream_copy_plain, flat,
                     note=f"br={br}, {flat.shape[0]} rows{label}")
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
            kernel = "slice_sum" if mode == "sliceonly" else "nine_tap"
            hold(kernel, size if mode in ("slices", "sliceonly") or size == "small"
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
        library = {"copy": "Tensor.copy_", "wr4x": "x.unsqueeze(1) * s",
                   "rd4x": "x4.sum(1)"}.get(kernel)
        more = {} if library is None else dict(
            ms_spread=fir[f"{kernel}_ms_spread"],
            library_ms_spread=fir[f"library_{kernel}_ms_spread"])
        if kernel == "rd4x":        # one rounding from float32, not rd4x's three
            more["library_max_units"] = fir["library_rd4x_units"]
        entry(f"probe_stream_{kernel}", kernel, src, f"scripts/probe_fir_roofline.py:{line}",
              fir[f"{kernel}_ms"], 1e3 * nb / hbm, "bytes",
              fir[f"library_{kernel}_ms"] if library else None, library, shape,
              gbps=fir[f"{kernel}_gbps"], **more)
    first = stream_diag.SHAPES[0][0]
    for kernel, key, line in (("copy3d", (first, "copy3d", "cb=8"), 39),
                              ("copy2d", ("flat", "copy2d", "br=4096"), 49)):
        row, lib = diag[key], diag[(key[0], "library-copy_", "")]
        entry(f"probe_stream_{kernel}", kernel, src, f"scripts/probe_stream_diag.py:{line}",
              row["ms"], 1e3 * row["bytes"] / hbm, "bytes", lib["ms"], "Tensor.copy_",
              f"{key[0]} {key[2]}, {row['bytes'] / 2e6:.0f} MB bf16", gbps=row["gbps"],
              ms_spread=[row["ms_lo"], row["ms_hi"]],
              library_ms_spread=[lib["ms_lo"], lib["ms_hi"]])
    entry("probe_stream_windows", "windows", src, "scripts/probe_element_windows.py:41",
          win["ms"], 1e3 * win["moved_bytes"] / hbm, "bytes", None, None,
          f"the fused kernel's windows at {win['variant']}: {win['tiles']} windows of "
          f"{win['window']}^2 per plane, {win['planes']} planes of {win['in_size']}^2 fp32",
          gbps=win["moved_gbps"], window_read_gbps=win["read_gbps"], ms_spread=win["ms_spread"])
    entry("probe_int8_stacked_matmul", "stacked_matmul", "afcm_tpu_torch/csrc/probe_int8.cu",
          "scripts/bench_int8_matmul.py:37", mm["kernel_ms"], mm["bound_ms"], mm["bound_by"],
          mm["int_mm_ms"] if mm["int_mm_ms"] is not None else mm["bf16_ms"],
          "torch._int_mm per k" if mm["int_mm_ms"] is not None else
          "torch.matmul in bf16 (this torch has no _int_mm for the shape)",
          f"[{mm['o']},{mm['i']}] @ [{mm['k']},{mm['i']},{mm['l']}] int8 -> int32",
          tops=mm["kernel_tops"], kli_ms=mm["kernel_kli_ms"], bf16_matmul_ms=mm["bf16_ms"],
          ms_spread=mm["kernel_ms_spread"],
          library_ms_spread=mm["int_mm_ms_spread"] if mm["int_mm_ms"] is not None
          else mm["bf16_ms_spread"])
    sl = taps["slices"]
    offs = p8.tap_offsets("slices", int8_kernel.WP)
    reach = max(offs) + int8_kernel.COLS - min(offs)   # the bytes of an x row a mode reads
    nbytes = 9 * int8_kernel.O * int8_kernel.I + int8_kernel.STEPS * (
        int8_kernel.I * reach + 2 * int8_kernel.O * int8_kernel.COLS)
    by_ops, by_bytes = 1e3 * sl["ops"] / probes.INT8_OP_PER_S, 1e3 * nbytes / hbm
    entry("probe_int8_nine_tap", "nine_tap", "afcm_tpu_torch/csrc/probe_int8.cu",
          "scripts/diag_int8_kernel.py:38", sl["ms"], max(by_ops, by_bytes),
          "operations" if by_ops >= by_bytes else "bytes", None, None,
          f"mode slices: w9 [9,{int8_kernel.O},{int8_kernel.I}], x [{int8_kernel.STEPS},"
          f"{int8_kernel.I},{int8_kernel.window(int8_kernel.COLS, int8_kernel.WP)}] int8 "
          "-> bf16", tops=sl["tops"],
          modes_ms={mode: taps[mode]["ms"] for mode in ("dot1", "aligned", "slices")},
          ms_spread=sl["ms_spread"],
          dot1_library_ms=taps["dot1"]["library_ms"],
          dot1_library="torch._int_mm per step (int32 out)")
    so = taps["sliceonly"]     # the same offsets and reach as mode slices
    so_bytes = int8_kernel.STEPS * (int8_kernel.I * reach + 2 * int8_kernel.O * int8_kernel.COLS)
    entry("probe_int8_slice_sum", "slice_sum", "afcm_tpu_torch/csrc/probe_int8.cu",
          "scripts/diag_int8_kernel.py:38", so["ms"], 1e3 * so_bytes / hbm, "bytes", None,
          None, f"mode sliceonly: x [{int8_kernel.STEPS},{int8_kernel.I},"
          f"{int8_kernel.window(int8_kernel.COLS, int8_kernel.WP)}] int8 -> bf16 "
          f"[{int8_kernel.STEPS},{int8_kernel.O},{int8_kernel.COLS}], rows from "
          f"{int8_kernel.I} zero", gbps=so_bytes / so["ms"] / 1e6, ms_spread=so["ms_spread"])
    for e in entries:
        phase("9c probe kernel", kernel=e["name"], **{k: e[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed_at")}, rate=e.get("gbps", e.get("tops")),
            rate_unit="GB/s" if "gbps" in e else "TOP/s",
            **{k: e[k] for k in ("ms_spread", "library_ms_spread") if k in e})
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


# A fresh process that imports only the port: loading the artifact needs
# the custom operators, which importing afcm_tpu_torch's ops registers.
SERVE_ARTIFACT = """
import json, sys
import numpy as np
from afcm_tpu_torch import serve
from afcm_tpu_torch.data.demo import phantom_test_loader
from afcm_tpu_torch.evaluate import set_matmul_precision
from afcm_tpu_torch.infer.export import serving_forward
from afcm_tpu_torch.ops.cuda import conv_int8 as k3, filtered_lrelu as k1
path, out, dtype, seed, batch = sys.argv[1:6]
set_matmul_precision(dtype)
loader = phantom_test_loader(depth=24, size=256, batch_size=int(batch), seed=int(seed))
forward = serving_forward(path, seed=int(seed))
k1.launches = k3.launches = 0
result = serve.serve_subjects(forward, [loader], out + "_heads", keep_volumes=True)
(volume,) = result["volumes"].values()
np.save(out, volume)
print(json.dumps({"k1_launches": k1.launches, "k3_launches": k3.launches,
                  "batches": len(loader), "patches_per_s": result["patches_per_s"],
                  "jax_or_afcm_tpu_loaded": sorted(m for m in sys.modules if m.split(".")[0]
                                                   in ("jax", "flax", "optax", "afcm_tpu"))}))
"""


def release_cached_memory():
    """Hand what this process's allocator caches back to the card before a
    fresh process needs it: under PyTorch's default cuDNN planning a float32
    conv's workspace is sized by the free memory (51 GiB at phase 6's fp32
    b16 leg), and the allocator keeps it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_artifact_in_fresh_process(path, out_dir, compute_dtype):
    """The artifact served over the phantom by serve.serve_subjects in a new
    Python process; returns its volume and what it counted."""
    out = os.path.join(out_dir, "served.npy")
    release_cached_memory()
    proc = subprocess.run([sys.executable, "-c", SERVE_ARTIFACT, path, out, compute_dtype,
                           str(SEED), str(SERVE_BATCH)], cwd=REPO, capture_output=True,
                          text=True, timeout=600, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"serving the artifact in a fresh process failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    if info["jax_or_afcm_tpu_loaded"]:
        raise AssertionError(f"the serving process loaded {info['jax_or_afcm_tpu_loaded']}")
    return np.load(out), info


def served_volume(forward):
    """The phantom's stitched volume through serve.serve_subjects."""
    loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH, seed=SEED)
    with tempfile.TemporaryDirectory() as out_dir:
        result = serve.serve_subjects(forward, [loader], out_dir, keep_volumes=True)
    (volume,) = result["volumes"].values()
    return volume, len(loader)


def volume_psnr(got, want):
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    return 10 * np.log10(float(want.max() - want.min()) ** 2 / max(mse, 1e-30))


def check_artifact(model, compute_dtype, out_dir, label, want_k1):
    """Export ``model`` (uint8 ingest, batch 16), serve the phantom from the
    saved artifact in a fresh process and hold the volume to the in-process
    one (same seed) within 1e-4 * max|in-process|; returns the artifact's
    path, the exported program and the row."""
    set_matmul_precision(compute_dtype)
    norm_range = PHANTOM_RANGE
    live, _ = served_volume(make_forward_fn(model, "cuda", seed=SEED, norm_range=norm_range))
    t0 = time.perf_counter()
    exported = export.export_eval(model, SERVE_BATCH, COND_SHAPE, norm_range=norm_range)
    export_s = time.perf_counter() - t0
    path = export.save_exported(exported, os.path.join(out_dir, f"{label}.pt2"))
    got, info = serve_artifact_in_fresh_process(path, out_dir, compute_dtype)
    diff = float(np.abs(got - live).max())
    bound = 1e-4 * float(np.abs(live).max())
    row = dict(artifact_mb=os.path.getsize(path) / 1e6, export_s=export_s,
               filtered_lrelu_nodes=export.count_nodes(exported), batches=info["batches"],
               fresh_process_k1_launches=info["k1_launches"],
               fresh_process_k3_launches=info["k3_launches"],
               fresh_process_patches_per_s=info["patches_per_s"],
               volume=list(got.shape), max_abs_diff_vs_in_process=diff, bound=bound,
               bit_equal=bool(np.array_equal(got, live)),
               finite=bool(np.isfinite(got).all()))
    if row["filtered_lrelu_nodes"] != want_k1 or \
            info["k1_launches"] != want_k1 * info["batches"] or info["k3_launches"]:
        raise AssertionError(f"{label}: {row['filtered_lrelu_nodes']} filtered_lrelu nodes and "
                             f"{info['k1_launches']} K1 launches for {info['batches']} batches "
                             f"(want {want_k1} each per batch, no K3)")
    if not (row["finite"] and got.shape == live.shape == PHANTOM_SHAPE and diff <= bound):
        raise AssertionError(f"{label}: the artifact's volume {got.shape} differs from the "
                             f"in-process one by {diff} > {bound}")
    return path, exported, row


def time_callable(fn, batch, iters=10, windows=3):
    """Median slices/s of ``windows`` windows of ``iters`` calls, and the spread."""
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        rates.append(batch * iters / (time.perf_counter() - t0))
    return float(np.median(rates)), sorted(rates)


def dispatch_cost(forward_ms):
    """Phase 11a: the host's cost of a filtered_lrelu call, on one plane of
    layer A (K1 takes ~10 µs there, so the host sets the pace): µs a call
    through the dispatching function, through the operator with its
    arguments made ahead, through the operator's CUDA implementation called
    directly, and of K1's launch alone with its plan made ahead. The
    operator's dispatch is the operator minus its implementation; 28 of it
    are read against 2% of the bf16 b16 forward. With autograd (training)
    the operator is timed too."""
    label = "A up2/down2 (L12_276_64)"
    x, b, kw, _, _ = variant_case(label, "cuda", SEED + 9)
    x, b = x[:1, :1].contiguous(), b[:1].contiguous()
    dispatch = importlib.import_module("afcm_tpu_torch.ops.filtered_lrelu")
    plan = k1._Plan(x, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"], False)
    fu, fd, *pad = k1.op_arguments(kw["fu"], kw["fd"], kw["padding"], False)
    args = (fu, fd, kw["up"], kw["down"], *pad, float(kw["gain"]), float(kw["slope"]),
            float(kw["clamp"]))
    calls = 3000

    def per_call_us(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / calls
    with torch.inference_mode():
        us = dict(path_us=per_call_us(lambda: dispatch.filtered_lrelu(x, b=b, **kw)),
                  operator_us=per_call_us(lambda: k1.filtered_lrelu_op(x, b, *args)),
                  implementation_us=per_call_us(lambda: k1._fwd_k1(x, b, *args)),
                  launch_only_us=per_call_us(lambda: k1._launch_fwd(x, b, plan)))
    xg = x.clone().requires_grad_(True)
    us["operator_autograd_us"] = per_call_us(lambda: k1.filtered_lrelu_op(xg, b, *args))
    us["kernel_device_us"] = 1e3 * cuda_ms(lambda: k1._launch_fwd(x, b, plan), iters=200)
    extra_ms = LAYERS_WITH_KERNEL * (us["operator_us"] - us["implementation_us"]) / 1e3
    phase("11a dispatch cost", x=list(x.shape), binding="torch.library.Library define/impl",
          **us, dispatch_ms_per_forward=extra_ms, forward_ms=forward_ms,
          share_of_forward=extra_ms / forward_ms,
          over_two_percent=bool(extra_ms > 0.02 * forward_ms))


def export_shipped(device, forward_ms):
    """Phase 11: the serving export of the shipped CMSR EMA generator (bf16,
    batch 16, uint8 ingest) served from a fresh process equal to in-process,
    its K1 nodes and launches; the bf16 fetch, the symbolic batch, bf16
    weights; the artifact's forward timed beside the in-process forward.
    Returns the K1 launches of the served artifact."""
    dispatch_cost(forward_ms)
    model = shipped_model("bfloat16")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        path, exported, row = check_artifact(model, "bfloat16", out_dir, "cmsr",
                                             LAYERS_WITH_KERNEL)
        phase("11 export", model="CMSR_ADNI_G", compute_dtype="bfloat16",
              batch=SERVE_BATCH, **row)
        norm_range = PHANTOM_RANGE
        full, _ = served_volume(export.serving_forward(exported, seed=SEED))
        fetched, _ = served_volume(export.serving_forward(export.export_eval(
            model, SERVE_BATCH, COND_SHAPE, norm_range=norm_range,
            fetch_dtype="bfloat16"), seed=SEED))
        fetch_db = volume_psnr(fetched, full)

        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        a = torch.randint(0, 256, (SERVE_BATCH, *COND_SHAPE), generator=gen, device=device,
                          dtype=torch.uint8)
        s = torch.rand((SERVE_BATCH, 1), generator=gen, device=device)
        z = torch.randn((SERVE_BATCH, model.z_dim), generator=gen, device=device)
        symbolic = export.export_eval(model, None, COND_SHAPE, norm_range=norm_range)
        shapes = {}
        for n in (1, SERVE_BATCH):
            with torch.no_grad():
                out = symbolic.module()(a[:n], s[:n], z[:n])
            shapes[n] = list(out.shape)
            if tuple(out.shape) != (n, 1, *PHANTOM_SHAPE[1:]) or not torch.isfinite(out).all():
                raise AssertionError(f"symbolic-batch artifact at batch {n}: {shapes[n]}")
        half_path = export.save_exported(export.export_eval(
            model, SERVE_BATCH, COND_SHAPE, norm_range=norm_range,
            weights_dtype="bfloat16"), os.path.join(out_dir, "bf16_weights.pt2"))
        half = export.load_exported(half_path)[0].module()
        module = export.load_exported(path)[0].module()
        with torch.no_grad():
            weights_db = psnr(half(a, s, z), module(a, s, z))
        size_ratio = os.path.getsize(half_path) / os.path.getsize(path)

        set_matmul_precision("bfloat16")
        with torch.no_grad():
            artifact_rate, artifact_spread = time_callable(lambda: module(a, s, z), SERVE_BATCH)
        live_rate, live_spread = time_callable(
            lambda: model.eval_step(normalize_uint8(a, *norm_range), s, z=z), SERVE_BATCH)
        phase("11 export variants", bf16_fetch_psnr_db=fetch_db, symbolic_batch_shapes=shapes,
              bf16_weights_size_ratio=size_ratio, bf16_weights_psnr_db=weights_db,
              artifact_slices_per_s=artifact_rate, artifact_spread=artifact_spread,
              in_process_slices_per_s=live_rate, in_process_spread=live_spread)
        if not fetch_db >= 50:
            raise AssertionError(f"bf16-fetched artifact {fetch_db:.2f} dB from the float32 one")
        if not (size_ratio < 0.65 and weights_db > 40):
            raise AssertionError(f"bf16-weights artifact: {size_ratio:.3f} of the size, "
                                 f"{weights_db:.2f} dB")
        return row["fresh_process_k1_launches"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def ccsr_config(*opts):
    from afcm_tpu_torch.config import default_argument_parser
    return default_argument_parser(["--config-file", CCSR_CONFIG, "tpu.compute_dtype",
                                    "bfloat16", *opts])


@functools.lru_cache(maxsize=None)
def comodgan_model():
    """The CoModGAN baseline's EMA generator (ccsr.yml; float32 whatever the
    compute dtype), random weights from SEED, on the card."""
    model = build_eval_model(dict(ccsr_config().model.G), compute_dtype="bfloat16",
                             generator=torch.Generator().manual_seed(SEED))
    model.generator_ema.to("cuda")
    return model


def comodgan_serving(device, trace_dir=None):
    """Phases 12a and 12c: the CoModGAN phantom served under the config's
    numerics through serve_and_score (no K1) and timed, then under
    tpu.conv_int8 True (K3 and each quantizer 9 times a batch, >= 30 dB from
    the float volume). Returns the int8 path's launches."""
    model = comodgan_model()
    try:
        configure_numerics(ccsr_config())
        loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH, seed=SEED)
        forward = make_forward_fn(model, device, seed=SEED, norm_range=loader.norm_range)
        k1.launches = k3.launches = 0                 # the CoModGAN path's run starts here
        with tempfile.TemporaryDirectory() as out_dir:
            scores = serve_and_score(forward, [loader], out_dir, "t1_hr4sr")
        (subject,) = scores["subjects"].values()
        float_launches = (k1.launches, k3.launches)
        float_vol, batches = served_volume(make_forward_fn(model, device, seed=SEED,
                                                           norm_range=loader.norm_range))
        cond, c, z = forward_inputs(SERVE_BATCH, device)
        torch.cuda.reset_peak_memory_stats()
        rate, spread = time_callable(lambda: model.eval_step(cond, c, z=z), SERVE_BATCH)
        metrics = [scores[k] for k in ("psnr", "ssim", "psnr_slice", "ssim_slice")]
        phase("12a CoModGAN serve", config=os.path.relpath(CCSR_CONFIG, REPO),
              compute_dtype="bfloat16", generator_dtype=str(
                  next(model.generator_ema.parameters()).dtype).split(".")[1],
              batch=SERVE_BATCH, batches=batches, volume=list(subject["shape"]),
              finite=subject["finite"], psnr=metrics[0], ssim=metrics[1],
              k1_launches=float_launches[0], k3_launches=float_launches[1],
              slices_per_s=rate, spread=spread, ms_per_batch=1e3 * SERVE_BATCH / rate,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if float_launches != (0, 0):
            raise AssertionError(f"the float CoModGAN path launched {float_launches} K1/K3")
        if not (subject["finite"] and subject["shape"] == PHANTOM_SHAPE
                and np.isfinite(metrics).all()):
            raise AssertionError(f"bad CoModGAN volume {subject} or metrics")
        if trace_dir is not None:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("traced_forwards"):
                    for _ in range(5):
                        model.eval_step(cond, c, z=z)
                    torch.cuda.synchronize()
            summarize_trace(prof, "comodgan_bfloat16_b16", "traced_forwards", 5, trace_dir,
                            layers=None, phase_name="12 trace", unit="forward")

        configure_numerics(ccsr_config("tpu.conv_int8", "True"))
        if get_conv_impl() != "int8":
            raise AssertionError(f"configure_numerics left conv impl {get_conv_impl()}")
        k1.launches = k3.launches = 0                 # the CoModGAN int8 path's run
        k3.quantize_launches = k3.weight_quantize_launches = 0
        int8_vol, batches = served_volume(make_forward_fn(model, device, seed=SEED,
                                                          norm_range=loader.norm_range))
        launches = (k1.launches, k3.launches, k3.quantize_launches,
                    k3.weight_quantize_launches)
        int8_rate, int8_spread = time_callable(lambda: model.eval_step(cond, c, z=z),
                                               SERVE_BATCH)
    finally:
        set_conv_impl("xla")
    db = volume_psnr(int8_vol, float_vol)
    phase("12c CoModGAN int8", batches=batches, k1=launches[0], k3=launches[1],
          quantize_activations=launches[2], quantize_weights=launches[3],
          per_batch=COMOD_INT8_ROUTED, psnr_vs_float_db=db,
          finite=bool(np.isfinite(int8_vol).all()), slices_per_s=int8_rate,
          spread=int8_spread)
    if launches != (0,) + (COMOD_INT8_ROUTED * batches,) * 3:
        raise AssertionError(f"{launches} K1/K3/quantizer launches for {batches} CoModGAN int8 "
                             f"batches; want no K1 and {COMOD_INT8_ROUTED} of each other per batch")
    if not (np.isfinite(int8_vol).all() and db >= 30):
        raise AssertionError(f"CoModGAN int8 volume {db:.2f} dB from the float one, < 30")
    return launches


def comodgan_train(device):
    """Phase 12d: the train CLI's loop on the CCSR config over a phantom, bf16
    b16: finite losses, no K1 or K2, w_avg moved from its zero init in G
    and G_ema, median ms/step and img/s of 3 windows, peak memory."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_comodgan_")
    never = str(10 ** 9)
    cfg = ccsr_config("checkpoints_dir", out_dir, "name", "smoke_comodgan",
                      "trainer.display_freq", never, "trainer.print_freq", never,
                      "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never)
    loaders = phantom_train_loaders(depth=4 * TRAIN_BATCH, size=256, batch_size=TRAIN_BATCH,
                                    seed=SEED)
    warm, window, windows = 2, 3, 3
    bounds = [warm + i * window for i in range(windows + 1)]
    monitor = StepMonitor(bounds)
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.bwd_launches = 0
    t0 = time.perf_counter()
    val = train_cli.train(cfg, max_iters=TRAIN_BATCH * bounds[-1], loaders=loaders,
                          device=device, on_step=monitor)
    seconds = time.perf_counter() - t0
    ms = [1e3 * (monitor.times[b] - monitor.times[a]) / window
          for a, b in zip(bounds, bounds[1:])]
    run_dir = os.path.join(out_dir, cfg.name)
    w_avg = {name: float(torch.load(os.path.join(run_dir, f"latest_net_{name}.pth"),
                                    weights_only=True)["mapping.w_avg"].abs().max())
             for name in ("G", "G_ema")}
    shutil.rmtree(out_dir, ignore_errors=True)
    finite = monitor.losses_finite()
    phase("12d CoModGAN train bf16 b16", config=os.path.relpath(CCSR_CONFIG, REPO),
          batch=TRAIN_BATCH, shared_g_fwd=bool(cfg.tpu.shared_g_fwd),
          steps=len(monitor.counts), ms_per_step=float(np.median(ms)), spread_ms=sorted(ms),
          img_per_s=1e3 * TRAIN_BATCH / float(np.median(ms)),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          launches_per_step=sorted(set(monitor.counts)), losses_finite=finite,
          last_losses={k: float(v) for k, v in monitor.metrics[-1].items()},
          w_avg_max_abs=w_avg, val=val, seconds=seconds)
    if not finite:
        raise AssertionError("non-finite losses in the CoModGAN train steps")
    if sorted(set(monitor.counts)) != [(0, 0)]:
        raise AssertionError(f"the CoModGAN train step launched K1/K2: {monitor.counts}")
    if not min(w_avg.values()) > 0:
        raise AssertionError(f"w_avg did not move from its init: {w_avg}")
    torch.cuda.empty_cache()


def comodgan_export():
    """Phase 12e: the CoModGAN EMA generator exported (no filtered_lrelu
    node) and served from a fresh process equal to in-process."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        configure_numerics(ccsr_config())
        _, _, row = check_artifact(comodgan_model(), "bfloat16", out_dir, "comodgan", 0)
        phase("12e CoModGAN export", batch=SERVE_BATCH, **row)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def rel_errors(got, want):
    """max|got - want| / max|want| of each tensor of two dicts."""
    return {k: float((got[k].double().cpu() - want[k].double().cpu()).abs().max()) /
            max(float(want[k].abs().max()), 1e-30) for k in want}


def card_against_cpu(name, fn, nets, inputs, device, bound=1e-3, **fields):
    """``fn(nets, inputs)`` -> dict of tensors, run on the card (float32,
    TF32 off) and on the CPU with the same weights and inputs. Each forward
    tensor (output, statistics) within ``bound`` · max|CPU|. The gradients
    ("<net>.grad.<parameter>") are held per net: ||card - CPU|| / ||CPU||
    over all of them within ``bound``, or within 10x the rounding floor
    where that is larger: how far two CPU runs move from the CPU's own
    result when every weight and input is nudged by a relative 2^-24 (half
    an ulp). Float32 cannot hold every gradient tensor to ``bound``: one
    summed from terms that cancel (a noise strength's over the image, a
    bias's) or through few-sample batch norms moves by up to ~1e-1 of its
    maximum under such a nudge, on either device; each tensor's error and
    floor are printed. Nets under "info." are printed, not held."""
    nudge = torch.Generator().manual_seed(SEED + 16)

    def copies(dev, eps=0.0):
        out = []
        for net in nets:
            net = copy.deepcopy(net).to(dev)
            with torch.no_grad():
                for v in [*net.parameters(), *net.buffers()]:
                    if eps and v.is_floating_point():
                        v.mul_(1 + eps * torch.randn(v.shape, generator=nudge))
            out.append(net)
        return out, [(x * (1 + eps * torch.randn(x.shape, generator=nudge))
                      if eps and x.is_floating_point() else x).to(dev) for x in inputs]

    set_matmul_precision("float32")
    # every run starts from its own copy: fn moves the nets' statistics
    on_cpu, nudged = copies("cpu"), [copies("cpu", 2.0 ** -24) for _ in range(2)]
    card = fn(*copies(device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = fn(*on_cpu)
    cpu_s = time.perf_counter() - t0
    runs = [fn(*run) for run in nudged]
    cross, nets_err = rel_errors(card, cpu), grad_errors(card, cpu)
    floors = [(rel_errors(run, cpu), grad_errors(run, cpu)) for run in runs]
    floor = {k: max(f[k] for f, _ in floors) for k in cross}
    nets_floor = {n: max(f[n] for _, f in floors) for n in nets_err}
    forward = [k for k in cross if ".grad." not in k]
    held = [n for n in nets_err if not n.startswith("info.")]
    allowed = {n: max(bound, 10 * nets_floor[n]) for n in held}
    grads = sorted((k for k in cross if ".grad." in k), key=cross.get)
    finite = all(bool(torch.isfinite(v).all()) for v in card.values())
    phase(name, forward_tensors=len(forward), forward_max_rel_err=max(cross[k] for k in forward),
          forward_worst=max(forward, key=cross.get), bound_rel=bound,
          grad_tensors=len(grads), grad_rel_l2_err=nets_err, grad_rel_l2_floor=nets_floor,
          grad_allowed=allowed, grad_tensors_over_bound=sum(cross[k] > bound for k in grads),
          grad_largest={k: [cross[k], floor[k]] for k in grads[-4:]},
          finite=finite, cpu_seconds=cpu_s, **fields)
    if not (finite and max(cross[k] for k in forward) <= bound):
        worst = max(forward, key=cross.get)
        raise AssertionError(f"{name}: {worst} max|card - CPU| / max|CPU| {cross[worst]} > "
                             f"{bound}")
    for n in held:
        if nets_err[n] > allowed[n]:
            raise AssertionError(f"{name}: {n}'s gradients ||card - CPU|| / ||CPU|| "
                                 f"{nets_err[n]} > {allowed[n]}")


def pix2pix_config(out_dir="checkpoints", *opts):
    """configs/adni/base.yml with the channel counts that fit the 4-slice
    window, its periodic display, printing and saving turned off."""
    from afcm_tpu_torch.config import default_argument_parser
    never = str(10 ** 9)
    return default_argument_parser([
        "--config-file", PIX2PIX_CONFIG, *PIX2PIX_CHANNELS, "checkpoints_dir", out_dir,
        "name", "smoke_pix2pix", "trainer.display_freq", never, "trainer.print_freq", never,
        "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never, *opts])


def unet_dropout_masks(net, batch, size, seed):
    """Keep masks (p 0.5) for the UNet's dropout levels at a size^2 input:
    level k of ``net.levels`` works at size / 2^k."""
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.rand((batch, getattr(net, name).up_w.shape[1],
                              size >> net.levels.index(name), size >> net.levels.index(name)),
                             generator=gen) < 0.5
            for name in net.dropout_blocks}


def pix2pix_gradients(nets, inputs):
    """From G, D and [A, B, the keep masks of G's dropout levels]: the
    gradients of a step's D and G losses (vanilla objective) with both nets
    in eval mode (running statistics); then a train-mode step's tensors
    without its update: G's output, the statistics G and D move (D's on the
    fake, then the real batch), and, under "info.", its gradients through
    the batch statistics, which the 8-sample batch norms of the UNet's 1-4²
    levels at batch 2 make jump at float32 resolution (a 2^-24 nudge of the
    inputs moved one tensor's by 1e-1 on the CPU)."""
    gen, disc = nets
    a, b, *keep = inputs
    out = {}
    for prefix, train in (("", False), ("info.", True)):
        fake = gen(a, train=train, dropout_masks=dict(zip(gen.dropout_blocks, keep)))
        real_ab, fake_ab = torch.cat([a, b], 1), torch.cat([a, fake], 1)
        loss_d = (gan_loss("vanilla", disc(fake_ab.detach(), train=train), False) +
                  gan_loss("vanilla", disc(real_ab, train=train), True)) * 0.5
        loss_g = gan_loss("vanilla", disc(fake_ab, train=train, update_stats=False), True) + \
            l1_loss(fake, b) * 100
        for net, tag, loss in ((disc, "D", loss_d), (gen, "G", loss_g)):
            names, params = zip(*net.named_parameters())
            out.update({f"{prefix}{tag}.grad.{n}": g for n, g in zip(
                names, torch.autograd.grad(loss, params, retain_graph=True))})
    out["fake"] = fake.detach()
    for tag, net in (("G", gen), ("D", disc)):
        out.update({f"{tag}.{n}": v.detach().clone() for n, v in net.named_buffers()})
    return out


def check_pix2pix(device):
    """Phase 13a: the full-width pix2pix G and D at batch 2 on the card
    against the same modules on the CPU, same weights and dropout masks: a
    step's output, statistics and gradients (``card_against_cpu``)."""
    model = build_model(pix2pix_config(), generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED + 13)
    a = torch.from_numpy(rng.randn(2, 4, 256, 256).clip(-1, 1).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 1, 256, 256).clip(-1, 1).astype(np.float32))
    masks = unet_dropout_masks(model.generator, 2, 256, SEED)
    launches = (k1.launches, k1.bwd_launches, k3.launches)
    card_against_cpu("13a pix2pix card vs CPU", pix2pix_gradients,
                     [model.generator, model.discriminator], [a, b, *masks.values()], device,
                     batch=2, dropout_levels=list(masks),
                     parameters={n: sum(p.numel() for p in net.parameters()) for n, net in
                                 (("G", model.generator), ("D", model.discriminator))})
    if (k1.launches, k1.bwd_launches, k3.launches) != launches:
        raise AssertionError("the pix2pix nets launched a kernel of the port")


@contextlib.contextmanager
def built_models():
    """The models the train CLI builds inside the block, in a list."""
    built = []
    real = train_cli.build_model

    def build(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    train_cli.build_model = build
    try:
        yield built
    finally:
        train_cli.build_model = real


def train_pix2pix(device):
    """Phases 13b and 13c: the train CLI's loop on the pix2pix config at b32
    over a phantom subject, fp32 with TF32 off (the config's compute dtype):
    finite losses, G's and D's statistics moved, median ms/step and img/s
    over 3 windows with the spread, peak memory, no launch of a kernel of
    the port; then the saved latest_net_G.pth in a freshly built model
    against the live model on a val batch."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pix2pix_")
    cfg = pix2pix_config(out_dir)
    loaders = phantom_train_loaders(depth=4 * PIX2PIX_BATCH, size=256,
                                    batch_size=PIX2PIX_BATCH, seed=SEED)
    warm, window, windows = 2, 3, 3
    bounds = [warm + i * window for i in range(windows + 1)]
    monitor = StepMonitor(bounds)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.bwd_launches = k3.launches = 0    # the pix2pix path's run starts here
    t0 = time.perf_counter()
    with built_models() as built:
        val = train_cli.train(cfg, max_iters=PIX2PIX_BATCH * bounds[-1], loaders=loaders,
                              device=device, on_step=monitor)
    seconds = time.perf_counter() - t0
    launches = {"filtered_lrelu": k1.launches, "filtered_lrelu_bwd": k1.bwd_launches,
                "conv_int8": k3.launches}
    ms = [1e3 * (monitor.times[b] - monitor.times[a]) / window
          for a, b in zip(bounds, bounds[1:])]
    (model,) = built
    moved = {name: sum(not torch.equal(v, torch.zeros_like(v) if n.endswith("mean")
                                       else torch.ones_like(v))
                       for n, v in net.named_buffers())
             for name, net in (("G", model.generator), ("D", model.discriminator))}
    stats = {name: sum(1 for _ in net.buffers())
             for name, net in (("G", model.generator), ("D", model.discriminator))}
    finite = monitor.losses_finite()
    phase("13b pix2pix train fp32 b32", config=os.path.relpath(PIX2PIX_CONFIG, REPO),
          overrides=list(PIX2PIX_CHANNELS), batch=PIX2PIX_BATCH, tf32=False,
          steps=len(monitor.counts), ms_per_step=float(np.median(ms)), spread_ms=sorted(ms),
          img_per_s=1e3 * PIX2PIX_BATCH / float(np.median(ms)),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          statistics_moved=moved, statistics=stats, launches=launches,
          losses_finite=finite,
          last_losses={k: float(v) for k, v in monitor.metrics[-1].items()},
          val=val, seconds=seconds)
    if not finite:
        raise AssertionError("non-finite losses in the pix2pix train steps")
    if moved != stats:
        raise AssertionError(f"pix2pix statistics that did not move: {moved} of {stats}")
    if any(launches.values()):
        raise AssertionError(f"the pix2pix train step launched {launches}")

    run_dir = os.path.join(out_dir, cfg.name)
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(SEED + 99))
    fresh.generator.load_state_dict(torch.load(os.path.join(run_dir, "latest_net_G.pth"),
                                               weights_only=True), strict=True)
    fresh.to(device)
    a = torch.from_numpy(next(iter(loaders["val"]))["A"]).to(device)
    # cuDNN's default transposed-conv algorithms may round differently from
    # call to call; its deterministic ones make two equal models agree
    torch.backends.cudnn.deterministic = True
    try:
        live, loaded = model.eval_step(a), fresh.eval_step(a)
    finally:
        torch.backends.cudnn.deterministic = False
    err = float((live - loaded).abs().max())
    files = sorted(os.listdir(run_dir))
    shutil.rmtree(out_dir, ignore_errors=True)
    phase("13c pix2pix reload latest_net_G.pth", batch=list(a.shape),
          bit_equal=bool(torch.equal(live, loaded)), max_abs_diff=err,
          finite=bool(torch.isfinite(loaded).all()),
          files=[n for n in files if n.startswith("latest")])
    if not (torch.equal(live, loaded) and torch.isfinite(loaded).all()):
        raise AssertionError(f"the reloaded pix2pix G differs from the live one by {err}")
    torch.cuda.empty_cache()


def styleganv_tensors(nets, inputs):
    """G's eval-mode output (const noise) and D's logits on it beside the
    other frames, and every parameter's gradient of one scalar of both."""
    gen, disc = nets
    z, c, t, delta_t, cond, motion_z, frames, weight = inputs
    img = gen(z, c, t, delta_t, cond, motion_z=motion_z, noise_mode="const")
    logits = disc(torch.cat([frames, img], 1), c, delta_t)
    loss = (img * weight).sum() + logits.sum()
    out = {"G.out": img.detach(), "D.out": logits.detach()}
    for prefix, net in (("G", gen), ("D", disc)):
        names, params = zip(*net.named_parameters())
        out.update({f"{prefix}.grad.{n}": g for n, g in zip(
            names, torch.autograd.grad(loss, params, retain_graph=True))})
    return out


def check_motion(device):
    """Phase 14: StyleGANVGenerator and StyleGANVDiscriminator at 256^2 and
    the CCSR config's widths, batch 4, card against the CPU, forward and
    gradients (``card_against_cpu``); then
    grid_sample against F.grid_sample within 1e-5 on a warp of a b32
    discriminator input, both timed, and its backward."""
    gen = motion.StyleGANVGenerator(**STYLEGANV_G,
                                    generator=torch.Generator().manual_seed(SEED))
    disc = motion.StyleGANVDiscriminator(**STYLEGANV_D,
                                         generator=torch.Generator().manual_seed(SEED + 1))
    rng = np.random.RandomState(SEED + 14)
    n, frames, res = MOTION_BATCH, STYLEGANV_D["num_frames"], STYLEGANV_G["img_resolution"]
    traj, last = gen.motion_mapping.max_traj_len(), STYLEGANV_G["max_num_frames"] - 1
    inputs = [torch.from_numpy(np.asarray(v, np.float32)) for v in (
        rng.randn(n, STYLEGANV_G["z_dim"]), rng.rand(n, 1), rng.randint(0, last, (n, 1)),
        rng.randint(0, last, (n, 1)), rng.randn(n, 4, res, res).clip(-1, 1),
        rng.randn(n, traj, gen.motion_mapping.motion_z_dim),
        rng.randn(n, frames - 1, res, res).clip(-1, 1), rng.randn(n, 1, res, res))]
    params = {"G": sum(p.numel() for p in gen.parameters()),
              "D": sum(p.numel() for p in disc.parameters())}
    card_against_cpu("14 StyleGAN-V card vs CPU", styleganv_tensors, [gen, disc], inputs,
                     device, batch=n, parameters=params, max_traj_len=traj)

    draw = torch.Generator(device=device).manual_seed(SEED + 15)
    x = torch.randn((32, 5, 256, 256), generator=draw, device=device)
    angle = (torch.rand((32,), generator=draw, device=device) - 0.5) * 0.5
    scale = 1 + (torch.rand((32,), generator=draw, device=device) - 0.5) * 0.4
    theta = torch.stack([torch.stack([scale * torch.cos(angle), -scale * torch.sin(angle),
                                      torch.zeros_like(angle)], 1),
                         torch.stack([scale * torch.sin(angle), scale * torch.cos(angle),
                                      torch.zeros_like(angle)], 1)], 1)
    grid = torch.nn.functional.affine_grid(theta, list(x.shape), align_corners=False)
    ours = grid_sample(x, grid)
    library = torch.nn.functional.grid_sample(x, grid, mode="bilinear",
                                              padding_mode="zeros", align_corners=False)
    err = float((ours - library).abs().max())
    xg = x.clone().requires_grad_(True)
    weight = torch.randn(ours.shape, generator=draw, device=device)
    phase("14 grid_sample", x=list(x.shape), grid=list(grid.shape), max_abs_err=err,
          bound=1e-5, ms=cuda_median_ms(lambda: grid_sample(x, grid)),
          library_ms=cuda_median_ms(lambda: torch.nn.functional.grid_sample(
              x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
          backward_ms=cuda_median_ms(lambda: torch.autograd.grad(
              (grid_sample(xg, grid) * weight).sum(), xg)))
    if not err <= 1e-5:
        raise AssertionError(f"grid_sample max|diff| {err} from F.grid_sample > 1e-5")
    torch.cuda.empty_cache()


# -- phase 15: data parallelism ----------------------------------------------------

DP_WORLD = 2                   # 15b: two gloo ranks sharing the card
# 16: remat off, at the layers that reach 148^2 (16 of 29, 15 of them with
# K1) and at every layer
REMAT_SIZES = (None, 148, 0)


def train_process_group(device, reference):
    """Phase 15a: the train CLI's loop on the shipped config at bf16 b16 as
    the one rank of an NCCL process group (world size 1): every collective
    of the data-parallel path runs. Its losses step by step against phase
    7c's one-process run from the same seed; ms/step beside 7c's."""
    loaders = phantom_train_loaders(depth=6 * TRAIN_BATCH, size=256,
                                    batch_size=TRAIN_BATCH, seed=SEED)
    steps = WARM_STEPS + WINDOW_STEPS
    monitor = StepMonitor(boundaries=(WARM_STEPS, steps))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    cfg = train_config(out_dir, "bfloat16")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            parallel.group.init_process_group("nccl", "file://" + os.path.join(tmp, "store"),
                                              0, 1, timeout_s=600)
            try:
                k1.launches = k1.bwd_launches = 0     # this path's run starts here
                train_cli.train(cfg, max_iters=TRAIN_BATCH * steps, loaders=loaders,
                                device=device, on_step=monitor)
                launches = {"filtered_lrelu": k1.launches, "filtered_lrelu_bwd": k1.bwd_launches}
            finally:
                torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    got, want = monitor.metrics, reference["metrics"]
    bit_equal = all(torch.equal(a[k].cpu(), b[k].cpu()) for a, b in zip(got, want) for k in b)
    rel = max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-12)
              for a, b in zip(got, want) for k in b)
    ms = 1e3 * (monitor.times[steps] - monitor.times[WARM_STEPS]) / WINDOW_STEPS
    per_step = sorted(set(monitor.counts))
    phase("15a train over NCCL, world 1", backend="nccl", world=1, batch=TRAIN_BATCH,
          compute_dtype="bfloat16", steps=len(got), losses_bit_equal_to_7c=bit_equal,
          max_rel_loss_diff_vs_7c=rel, ms_per_step=ms, ms_per_step_7c=reference["ms_per_step"],
          launches_per_step=per_step, launches=launches, losses_finite=monitor.losses_finite())
    if per_step != [(LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL)] or not monitor.losses_finite():
        raise AssertionError(f"15a: K1/K2 launches per step {per_step}, finite "
                             f"{monitor.losses_finite()}")
    if len(got) != steps or rel > 1e-3:
        raise AssertionError(f"15a: {len(got)} steps, losses {rel} from 7c's (> 1e-3)")
    return launches


def shipped_train_step(device, group=None, nudge_seed=None):
    """One train step of the shipped config at fp32 (TF32 off) on the
    phantom's first global batch of 16 (``parallel.check.train_step_check``:
    this rank's slice with a ``group``; every weight and input nudged by the
    rounding floor with ``nudge_seed``)."""
    batch = next(iter(phantom_train_loaders(depth=6 * TRAIN_BATCH, size=256,
                                            batch_size=TRAIN_BATCH, seed=SEED)["train"]))
    return train_step_check(train_config(tempfile.gettempdir(), "float32"), batch, device,
                            seed=SEED, draw_seed=SEED + 15, group=group,
                            nudge_seed=nudge_seed)


def data_parallel_rank(rank, world, out_dir, device):
    """A rank of phase 15b (started by ``parallel.spawn``)."""
    torch.save(shipped_train_step(device, parallel.DataGroup.current()),
               os.path.join(out_dir, f"rank{rank}.pt"))


def check_data_parallel(device):
    """Phase 15b: two gloo ranks sharing the card take one fp32 step of the
    shipped config, each on its half of the global batch of 16, against one
    process on the whole batch from the same seed and weights: the losses
    within rtol 1e-4, each net's all-reduced gradient within 1e-4 in
    ||ranks - one|| / ||one||, or within 10x the float32 rounding floor where
    that is larger (two more one-process steps with every weight and input
    nudged by a relative 2^-24, as card_against_cpu measures it); the
    collective census per step and K1/K2 launches per rank printed. This
    process gives its cached memory back before the ranks start: its fp32
    steps leave tens of GiB in the allocator's cache, and a rank that plans
    its convs beside them runs out of memory."""
    want = shipped_train_step(device)
    floors = [grad_errors(shipped_train_step(device, nudge_seed=SEED + 16 + i)["grads"],
                          want["grads"]) for i in range(2)]
    floor = {net: max(f[net] for f in floors) for net in floors[0]}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(data_parallel_rank, DP_WORLD, (tmp, device), backend="gloo",
                       init_file=os.path.join(tmp, "store"), device_type=device.type,
                       timeout_s=900)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    got = ranks[0]
    loss_rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in want["metrics"].items()}
    err = grad_errors(got["grads"], want["grads"])
    allowed = {net: max(1e-4, 10 * floor[net]) for net in err}
    ranks_agree = all(torch.equal(ranks[1]["grads"][k], g) for k, g in got["grads"].items())
    phase("15b two gloo ranks on one card", backend="gloo", world=DP_WORLD,
          global_batch=TRAIN_BATCH, compute_dtype="float32", tf32=False,
          loss_rel_err=loss_rel, grad_rel_l2_err=err, grad_rel_l2_floor=floor,
          grad_allowed=allowed, ranks_hold_equal_gradients=ranks_agree,
          census_per_step=got["census"],
          launches_per_rank=[list(r["launches"]) for r in ranks],
          one_process_launches=list(want["launches"]), one_process_step_ms=want["ms"],
          rank_step_ms=[r["ms"] for r in ranks], spawn_s=spawn_s)
    if max(loss_rel.values()) > 1e-4 or any(err[n] > allowed[n] for n in err):
        raise AssertionError(f"15b: losses {loss_rel}, gradients {err} (allowed {allowed})")
    if not ranks_agree or any(tuple(r["launches"]) != (LAYERS_WITH_KERNEL,) * 2
                              for r in ranks):
        raise AssertionError(f"15b: ranks agree {ranks_agree}, launches "
                             f"{[r['launches'] for r in ranks]}")
    return [list(r["launches"]) for r in ranks]


def serve_over_mesh(device):
    """Phase 15c: the phantom served at fp32 (TF32 off) over the mesh
    [cuda:0, cuda:0] (two replicas, each batch split in two) against one
    device; the artifact exported over that mesh served over it within
    1e-4 * max of the in-process mesh volume."""
    set_matmul_precision("float32")
    model = shipped_model("float32")
    mesh = parallel.make_mesh((2, 1), [device, device])
    one, batches = served_volume(make_forward_fn(model, device, seed=SEED,
                                                 norm_range=PHANTOM_RANGE))
    k1.launches = 0                           # this path's run starts here
    two, _ = served_volume(make_forward_fn(model, device, seed=SEED,
                                           norm_range=PHANTOM_RANGE, mesh=mesh))
    launches = k1.launches
    exported = export.export_eval(model, SERVE_BATCH, COND_SHAPE, norm_range=PHANTOM_RANGE,
                                  mesh=mesh)
    served, _ = served_volume(export.serving_forward(exported, seed=SEED, mesh=mesh))
    diff = float(np.abs(two - one).max())
    art_diff = float(np.abs(served - two).max())
    bound = 1e-4 * float(np.abs(two).max())
    phase("15c serve over a mesh of two replicas", mesh=[str(d) for d in mesh.data_devices],
          compute_dtype="float32", batches=batches, volume=list(two.shape),
          bit_equal_to_one_device=bool(np.array_equal(two, one)),
          max_abs_diff_vs_one_device=diff, artifact_devices=export.mesh_devices(exported),
          artifact_max_abs_diff=art_diff, bound=bound, k1_launches=launches)
    if not (np.isfinite(two).all() and two.shape == PHANTOM_SHAPE and diff <= bound
            and art_diff <= bound):
        raise AssertionError(f"15c: mesh volume {diff} from one device's, the artifact's "
                             f"{art_diff} from the mesh's (bound {bound})")
    if launches != LAYERS_WITH_KERNEL * 2 * batches:
        raise AssertionError(f"15c: {launches} K1 launches for {batches} batches over "
                             "two replicas")
    return launches


# Phase 16 runs each (dtype, workspace policy, remat) in a fresh process:
# what an earlier setting left allocated, and the cuDNN plans it cached,
# would move the peak. Under PyTorch's default cuDNN planning ("plain") a
# conv's plan is chosen at its first use with a workspace of up to the free
# memory (at fp32 with TF32 off an FFT plan of 48 GiB for the 362-channel
# 148^2 conv), so the fp32 peak measured the plans more than the
# activations and remat raised it (ROADMAP C12). "train" is the train
# path's policy (train.bound_conv_workspace, set before the process's first
# conv): a 4 GiB cap at fp32, the default planning at bf16. The plain runs
# at fp32 are the repair's "before", at remat off and 0.
WORKSPACE_POLICIES = {"bfloat16": (("train", REMAT_SIZES),),
                      "float32": (("plain", (None, 0)), ("train", REMAT_SIZES))}
# remat's first-step gradients from remat off, per policy (times max): the
# train policy's planning is fixed, so remat changes no algorithm; under
# the plain one each fresh process plans by its own free memory, and two
# algorithms are held as phase 7b holds two implementations of the step
REMAT_GRAD_BOUND = {"train": 1e-5, "plain": 1e-3}
REMAT_SETTING = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
size = None if sys.argv[4] == "off" else int(sys.argv[4])
print(json.dumps(chip_smoke.remat_setting(sys.argv[2], sys.argv[3], size, sys.argv[5])))
"""
REMAT_STEPS = 3


def run_setting(dtype, policy, size, grads_dir):
    """``remat_setting`` in a fresh ``python -c`` process; its row."""
    release_cached_memory()
    proc = subprocess.run(
        [sys.executable, "-c", REMAT_SETTING, REPO, dtype, policy,
         "off" if size is None else str(size), grads_dir],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"the {dtype} {policy} remat {size} process failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def first_step_grads(model):
    """The gradients each net's optimizer steps on first, kept on the host
    (a pre-hook on both optimizers; the step's scrubbed, averaged gradient)."""
    grads = {}
    for net, opt in (("G", model.opt_G), ("D", model.opt_D)):
        opt.register_step_pre_hook(lambda o, a, kw, net=net: None if net in grads else
                                   grads.update({net: [p.grad.detach().cpu() for g in
                                                       o.param_groups
                                                       for p in g["params"]]}))
    return grads


def grad_max_rel_err(got, want):
    """Per net, max |got - want| over max |want|."""
    return {net: max(float((a - b).abs().max()) for a, b in zip(got[net], want[net]))
            / max(float(b.abs().max()) for b in want[net]) for net in want}


def remat_setting(dtype, policy, size, grads_dir):
    """Phase 16 (and 7c's fp32 leg), one setting in this (fresh) process:
    REMAT_STEPS train steps of the shipped config at b16 from SEED through
    the train CLI's entry (``train.main``, the phantom in place of the h5
    data) with remat off (``size`` None) or at ``remat_min_size`` ``size``,
    under the entry's workspace policy ("train": ``bound_conv_workspace``)
    or with it replaced by nothing ("plain": PyTorch's default planning).
    The peak is read over the second step (reset after the first),
    ms/step is the median of the second and third. The first step's
    gradients go to ``grads_dir`` at remat off and are held against them
    otherwise, and the two policies' remat-off gradients against each
    other once both ran."""
    from afcm_tpu_torch.config import pop_flag  # noqa: F401  (yaml, as the CLI)
    if policy == "plain":
        train_cli.bound_conv_workspace = lambda device, compute_dtype: False
    train_cli.get_train_loaders = lambda cfg, seed=0: phantom_train_loaders(
        depth=6 * TRAIN_BATCH, size=256, batch_size=TRAIN_BATCH, seed=seed)
    built = {}
    build = train_cli.build_model

    def build_model(cfg, generator=None):
        built["model"] = model = build(cfg, generator=generator)
        built["grads"] = first_step_grads(model)
        return model

    counts, times, finite = [], [], []
    row = dict(compute_dtype=dtype, batch=TRAIN_BATCH, workspace_policy=policy,
               remat=size is not None, remat_min_size=size)

    def on_step(step, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        counts.append((k1.launches - sum(c[0] for c in counts),
                       k1.bwd_launches - sum(c[1] for c in counts)))
        finite.append(all(bool(torch.isfinite(v).all()) for v in metrics.values()))
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        elif step == 2:
            row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    train = train_cli.train
    train_cli.build_model = build_model
    train_cli.train = lambda cfg, **kw: train(cfg, max_iters=REMAT_STEPS * TRAIN_BATCH,
                                              on_step=on_step, **kw)
    opts = [] if size is None else ["tpu.remat", "True", "tpu.remat_min_size", str(size)]
    k1.launches = k1.bwd_launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            train_cli.main(["--device", "cuda", *train_argv(out_dir, dtype, *opts)])
        except torch.cuda.OutOfMemoryError as exc:
            row.update(fits=False, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       error=str(exc).splitlines()[0])
            return row
    synthesis = built["model"].generator.synthesis
    rematted = sum(layer.remat and not layer.spec.is_torgb
                   for layer in synthesis.encoders + synthesis.decoders)
    cap = os.environ.get("CUDNN_CONV_WSCAP_DBG")
    row.update(fits=True, workspace_cap_mib=int(cap) if cap else None,
               rematted_k1_layers=rematted, ms_per_step=1e3 * float(np.median(np.diff(times))),
               step_end_s=times, launches_per_step=sorted(set(counts)),
               launches=[sum(c[0] for c in counts), sum(c[1] for c in counts)],
               want_k1_per_step=LAYERS_WITH_KERNEL + rematted, losses_finite=all(finite))
    grads = built["grads"]
    off = os.path.join(grads_dir, f"{dtype}_{policy}_off.pt")
    if size is None:
        torch.save(grads, off)
        other = os.path.join(grads_dir, f"{dtype}_{'plain' if policy == 'train' else 'train'}"
                             "_off.pt")
        if os.path.exists(other):
            train_grads, plain_grads = ((grads, torch.load(other)) if policy == "train"
                                        else (torch.load(other), grads))
            row["grad_max_rel_err_train_vs_plain"] = grad_max_rel_err(train_grads,
                                                                      plain_grads)
    else:
        base = torch.load(off)
        row["grad_max_rel_err_vs_off"] = grad_max_rel_err(grads, base)
        row["grads_bit_equal_to_off"] = all(
            torch.equal(a, b) for net in base for a, b in zip(grads[net], base[net]))
    return row


def check_remat(device, grads_dir, reused):
    """Phase 16: the shipped config's train step at bf16 b16 and fp32 b16,
    each (dtype, workspace policy, remat setting) in a fresh process
    (``remat_setting``, through the train CLI's entry): at fp32 the plain
    policy at remat off and 0 and the train path's at off, 148 and 0; at
    bf16 the train path's, which is the default planning there. ``reused``
    maps a setting (dtype, policy, size) to the row of a process an earlier
    phase ran (7c's fp32 leg), whose gradients are in ``grads_dir``. Holds,
    under the train path's policy at both dtypes: one step's gradients
    within 1e-5 * max of remat off (bit equality printed), a peak that falls
    from remat off to 148 to 0, K1 launches per step 28 + the rematted
    layers that launch K1 (28 K2); and at fp32 its remat-off gradients
    within 1e-3 * max per net of the plain policy's (other cuDNN
    algorithms; phase 7b's bound for two implementations of the same step),
    as the plain policy's remat-0 gradients of its remat-off ones
    (REMAT_GRAD_BOUND). Prints per setting the peak, the ms/step and the
    policy in force. Removes ``grads_dir``."""
    launches = [0, 0]
    try:
        for dtype, policies in WORKSPACE_POLICIES.items():
            peaks, compared = {}, False
            for policy, sizes in policies:
                for size in sizes:
                    row = reused.get((dtype, policy, size))
                    if row is None:
                        row = run_setting(dtype, policy, size, grads_dir)
                        phase("16 remat", **row)
                    else:
                        phase("16 remat", reused="7c train fp32 b16", **row)
                    if not row["fits"]:
                        continue
                    peaks[policy, size] = row["peak_mem_gib"]
                    launches[0] += row["launches"][0]
                    launches[1] += row["launches"][1]
                    want = [[LAYERS_WITH_KERNEL + row["rematted_k1_layers"], LAYERS_WITH_KERNEL]]
                    if row["launches_per_step"] != want:
                        raise AssertionError(f"16: K1/K2 launches per step "
                                             f"{row['launches_per_step']}, want {want}")
                    err, bound = row.get("grad_max_rel_err_vs_off", {}), REMAT_GRAD_BOUND[policy]
                    if err and max(err.values()) > bound:
                        raise AssertionError(f"16: remat {size} at {dtype} under the {policy} "
                                             f"policy: gradients {err} from remat off "
                                             f"(> {bound} * max)")
                    err = row.get("grad_max_rel_err_train_vs_plain", {})
                    compared |= bool(err)
                    if err and max(err.values()) > 1e-3:
                        raise AssertionError(f"16: the train path's workspace policy's "
                                             f"gradients at {dtype} {err} from the plain "
                                             "one's (> 1e-3 * max)")
            if {("plain", None), ("train", None)} <= set(peaks) and not compared:
                raise AssertionError(f"16: the two policies' gradients at {dtype} were "
                                     "not compared")
            train = [peaks.get(("train", size), float("nan")) for size in REMAT_SIZES]
            if not train[2] < train[1] < train[0]:
                raise AssertionError(f"16: at {dtype} under the train path's workspace policy "
                                     f"the peak does not fall with remat (GiB, off / 148 / "
                                     f"0): {train}")
    finally:
        shutil.rmtree(grads_dir, ignore_errors=True)
    return {"filtered_lrelu": launches[0], "filtered_lrelu_bwd": launches[1]}


# -- phases 17 and 18: style mixing and the int8 train step ----------------------

MIX_PROB = 0.9           # tests/test_train_step.py:127
MIX_CUTOFF = 7           # of the shipped G's 16 ws
TRAIN_TIMED_STEPS = 3    # after one warm step


def timed_steps(model, batches, device, seed, **step_kwargs):
    """One warm step and TRAIN_TIMED_STEPS more, from a generator seeded
    ``seed``: the steps' ms (the median of the timed ones), the peak over
    the timed ones, and the K1/K2/K3/quantizer launches of each step."""
    draws = torch.Generator(device=device).manual_seed(seed)
    times, counts, metrics = [], [], []
    for i, batch in enumerate(batches[:1 + TRAIN_TIMED_STEPS]):
        counters = (k1.launches, k1.bwd_launches, k3.launches, k3.quantize_launches,
                    k3.weight_quantize_launches)
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics.append(model.train_step(batch, float(TRAIN_BATCH * (i + 1)), generator=draws,
                                        **step_kwargs))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts.append(tuple(now - was for now, was in zip(
            (k1.launches, k1.bwd_launches, k3.launches, k3.quantize_launches,
             k3.weight_quantize_launches), counters)))
    finite = all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())
    return dict(ms_per_step=float(np.median(times[1:])), step_ms=times,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches_per_step=sorted(set(counts)), losses_finite=finite), counts


def train_pair(device, dtype="bfloat16"):
    """Two equal models of the shipped training config (G, G_ema, D and
    their optimizers from SEED) on the device, and b16 phantom batches."""
    model = build_model(train_config(tempfile.gettempdir(), dtype),
                        generator=torch.Generator().manual_seed(SEED))
    twin = copy.deepcopy(model)
    loaders = phantom_train_loaders(depth=6 * TRAIN_BATCH, size=256,
                                    batch_size=TRAIN_BATCH, seed=SEED)
    batches = [train_cli.to_device(b, device)
               for _, b in zip(range(1 + TRAIN_TIMED_STEPS), loaders["train"])]
    return model.to(device), twin.to(device), batches


def check_style_mixing(device):
    """Phase 17: style mixing (style_mixing_prob 0.9) in the shipped
    config's train step at bf16 b16 (shared G forward): (a) with the coin
    false, given draws, one step equals the unmixed step from the same
    state and generator seed: losses and each net's gradients within
    1e-5 * max; (b) with the coin true the styles the synthesis gets are
    those of z before the cutoff and of the second latent's mapping from it
    on (within 1e-6 * max); (c) the mixed step drawing its own (z2, cutoff,
    coin): finite losses, 28 K1 and 28 K2 launches per step as the unmixed
    step, ms/step and peak beside the unmixed step's."""
    set_matmul_precision("bfloat16")
    plain, mixed, batches = train_pair(device)
    mixed.config = dataclasses.replace(mixed.config, style_mixing_prob=MIX_PROB)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    z = torch.randn((TRAIN_BATCH, plain.z_dim), generator=gen, device=device)
    z2 = torch.randn((TRAIN_BATCH, plain.z_dim), generator=gen, device=device)
    c = mixed._cond(batches[0])
    seen = []
    hook = mixed.generator.synthesis.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()) if not seen else None)
    try:
        out = {}
        for name, model, mix in (("plain", plain, None),
                                 ("mixed", mixed, StyleMix(z2, MIX_CUTOFF, False))):
            grads = first_step_grads(model)
            draws = torch.Generator(device=device).manual_seed(SEED + 170)
            metrics = model.train_step(batches[0], float(TRAIN_BATCH), z=z, generator=draws,
                                       mix=mix)
            out[name] = (grads, {k: float(v) for k, v in metrics.items()})
        loss_err = max(abs(out["mixed"][1][k] - v) / max(abs(v), 1e-12)
                       for k, v in out["plain"][1].items())
        grad_err = grad_max_rel_err(out["mixed"][0], out["plain"][0])
        # coin true: the hook reads the styles of the next step's forward
        seen.clear()
        with torch.no_grad():
            num_ws = mixed.generator.synthesis.num_ws
            want_ws = torch.where(torch.arange(num_ws, device=device)[None, :, None] >= MIX_CUTOFF,
                                  mixed.generator.mapping(z2, c), mixed.generator.mapping(z, c))
        mixed.train_step(batches[0], float(2 * TRAIN_BATCH), z=z,
                         generator=torch.Generator(device=device).manual_seed(SEED + 171),
                         mix=StyleMix(z2, MIX_CUTOFF, True))
        ws_err = float((seen[0] - want_ws).abs().max() / want_ws.abs().max())
    finally:
        hook.remove()
    timing_plain, _ = timed_steps(plain, batches, device, SEED + 172)
    k1.launches = k1.bwd_launches = 0    # the mixed path's run
    timing_mixed, _ = timed_steps(mixed, batches, device, SEED + 172)
    launches = {"filtered_lrelu": k1.launches, "filtered_lrelu_bwd": k1.bwd_launches}
    phase("17 style mixing", style_mixing_prob=MIX_PROB, cutoff=MIX_CUTOFF, batch=TRAIN_BATCH,
          coin_false_loss_max_rel_err=loss_err, coin_false_grad_max_rel_err=grad_err,
          coin_true_ws_max_rel_err=ws_err, mixed=timing_mixed, unmixed=timing_plain)
    if loss_err > 1e-5 or max(grad_err.values()) > 1e-5:
        raise AssertionError(f"17: the unmixed-by-coin step's losses ({loss_err}) or "
                             f"gradients ({grad_err}) from the unmixed step's (> 1e-5 * max)")
    if not ws_err <= 1e-6:
        raise AssertionError(f"17: the mixed styles {ws_err} from the two mappings' (> 1e-6)")
    want = [(LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL, 0, 0, 0)]
    if timing_mixed["launches_per_step"] != want or not timing_mixed["losses_finite"]:
        raise AssertionError(f"17: launches per step {timing_mixed['launches_per_step']} "
                             f"(want {want}), losses finite {timing_mixed['losses_finite']}")
    del plain, mixed
    torch.cuda.empty_cache()
    return launches


def routed_convs():
    """Count the convs ``_try_conv_int8`` routes to K3 (a wrapper around
    it, removed by the returned function's ``restore``)."""
    original = modulated_conv._try_conv_int8
    count = [0]

    def wrapped(x, w, padding):
        y = original(x, w, padding)
        count[0] += y is not None
        return y
    modulated_conv._try_conv_int8 = wrapped

    def restore():
        modulated_conv._try_conv_int8 = original
    return count, restore


# K4's backward in a step against the fp32 conv adjoint at its own inputs:
# the relative L2 bound per dx and dw (phase 18)
STE_BOUND = 1e-4


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


@contextlib.contextmanager
def ste_backward_audit():
    """Within the block every backward of K4 (``conv3x3_int8_ste``) is held
    against what its straight-through rule says it is: the fp32 conv
    adjoint (``torch.nn.grad``, under the same backend flags) at the
    unquantized x and w it saved and the dy it was given, rounded to the
    dtypes of x and w. Yields a list that gets, per call, whether it is the
    first backward of its forward (R1's gradient and the loss's backward
    both cross D's forward on real images) and
    the relative L2 error of dx and of dw (None where not asked for)."""
    ste = k3._Conv3x3Int8STE
    original = ste.backward
    errors = []

    def audited(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, rest = original(ctx, dy)
        first, ctx.audited = not getattr(ctx, "audited", False), True
        with torch.no_grad():
            g, p = dy.float(), ctx.padding
            dx_err = None if dx is None else rel_l2(dx, torch.nn.grad.conv2d_input(
                x.shape, w.float(), g, padding=p).to(x.dtype))
            dw_err = None if dw is None else rel_l2(dw, torch.nn.grad.conv2d_weight(
                x.float(), w.shape, g, padding=p).to(w.dtype))
        errors.append((first, dx_err, dw_err))
        return dx, dw, rest
    ste.backward = staticmethod(audited)
    try:
        yield errors
    finally:
        ste.backward = staticmethod(original)


def check_int8_train(device):
    """Phase 18: the shipped config's train step at bf16 b16 under conv impl
    'int8' (K4: K3 and its quantizers forward, the fp32 conv adjoint
    backward, also inside R1's double backward where D's gated convs are
    routed): finite losses; K3 and each quantizer launched once per routed
    conv of each step; in the first step every routed conv's backward, dx
    and dw, within STE_BOUND in relative L2 of the fp32 conv adjoint at its
    own inputs (``ste_backward_audit``), and G's gradients >= 30 dB from
    the float step's from the same state and draws (the STE bound,
    tests/test_conv_int8.py:139-159; D's, and each net's relative L2,
    printed); ms/step and peak beside the float step's."""
    set_matmul_precision("bfloat16")
    plain, quant, batches = train_pair(device)
    z = torch.randn((TRAIN_BATCH, plain.z_dim), device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED + 18))
    grads = {}
    for name, model, impl in (("float", plain, "xla"), ("int8", quant, "int8")):
        grads[name] = first_step_grads(model)
        with conv_impl(impl), ste_backward_audit() as ste_errors:
            routed, restore = routed_convs()
            try:
                model.train_step(batches[0], float(TRAIN_BATCH), z=z,
                                 generator=torch.Generator(device=device).manual_seed(
                                     SEED + 180))
            finally:
                restore()
    flat = {name: {net: torch.cat([t.reshape(-1) for t in grads[name][net]])
                   for net in ("G", "D")} for name in grads}
    g_psnr = {net: psnr(flat["int8"][net], flat["float"][net]) for net in ("G", "D")}
    g_rel_l2 = {net: rel_l2(flat["int8"][net], flat["float"][net]) for net in ("G", "D")}
    ste = {kind: max((e[i] for e in ste_errors if e[i] is not None), default=None)
           for i, kind in ((1, "dx"), (2, "dw"))}
    ste_calls, ste_forwards = len(ste_errors), sum(e[0] for e in ste_errors)
    first_routed = routed[0]
    timing_float, _ = timed_steps(plain, batches, device, SEED + 181)
    k1.launches = k1.bwd_launches = k3.launches = 0    # the int8 train path's run
    k3.quantize_launches = k3.weight_quantize_launches = 0
    routed, restore = routed_convs()
    try:
        with conv_impl("int8"):
            timing_int8, counts = timed_steps(quant, batches, device, SEED + 181)
    finally:
        restore()
    per_step = routed[0] // len(counts)
    launches = {"filtered_lrelu": k1.launches, "filtered_lrelu_bwd": k1.bwd_launches,
                "conv_int8": k3.launches, "quantize_int8": k3.quantize_launches,
                "quantize_weights_int8": k3.weight_quantize_launches}
    phase("18 int8 train", batch=TRAIN_BATCH, conv_impl="int8", routed_convs_per_step=per_step,
          ste_backward_calls=ste_calls, ste_backward_forwards=ste_forwards,
          ste_backward_max_rel_l2=ste, ste_bound=STE_BOUND,
          grad_psnr_db_vs_float=g_psnr, grad_rel_l2_vs_float=g_rel_l2, int8=timing_int8,
          float=timing_float)
    want = [(LAYERS_WITH_KERNEL, LAYERS_WITH_KERNEL, per_step, per_step, per_step)]
    if routed[0] != per_step * len(counts) or timing_int8["launches_per_step"] != want \
            or not per_step or not timing_int8["losses_finite"]:
        raise AssertionError(f"18: launches per step {timing_int8['launches_per_step']}, "
                             f"routed convs {routed[0]} in {len(counts)} steps, losses finite "
                             f"{timing_int8['losses_finite']}")
    if ste_forwards != first_routed or first_routed != per_step or None in ste.values() \
            or not max(ste.values()) <= STE_BOUND:
        raise AssertionError(f"18: K4's backward in the step: {ste_calls} calls on "
                             f"{ste_forwards} of {first_routed} routed convs, dx/dw relative "
                             f"L2 {ste} from the "
                             f"fp32 conv adjoint at its inputs (> {STE_BOUND})")
    if not g_psnr["G"] >= 30:
        raise AssertionError(f"18: G's int8 gradients {g_psnr['G']} dB from the float "
                             "step's (< 30)")
    del plain, quant
    torch.cuda.empty_cache()
    return launches


# -- phase 20: the model axis -------------------------------------------------------

TP_WORLD = 2                   # two gloo ranks sharing the card: mesh (1, 2)
TP_BATCH = 4
TP_FORWARDS = 3
TP_DTYPES = ("float32", "bfloat16")


def tensor_parallel_batch():
    """Phase 20's global train batch: the phantom's first batch of 4."""
    return next(iter(phantom_train_loaders(depth=6 * TP_BATCH, size=256,
                                           batch_size=TP_BATCH, seed=SEED)["train"]))


def tensor_parallel_step(device, dtype, group=None, model_group=None, nudge_seed=None):
    """One b4 train step of the shipped config at ``dtype``
    (``train_step_check``), over the groups when given."""
    cfg = train_config(tempfile.gettempdir(), dtype, "loaders.batch_size", str(TP_BATCH))
    return train_step_check(cfg, tensor_parallel_batch(), device, seed=SEED,
                            draw_seed=SEED + 20, group=group, model_group=model_group,
                            nudge_seed=nudge_seed)


def tensor_parallel_forward(model, device, timed=0):
    """G_ema's forward on phase 6's seeded b4 inputs, the K1 launches, and
    ``timed`` more forwards' ms on the host clock around a synchronize."""
    inputs = forward_inputs(TP_BATCH, device)
    k1.launches = 0
    with torch.no_grad():
        out = model.eval_step(inputs[0], inputs[1], z=inputs[2])
        launches = k1.launches
        times = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.eval_step(inputs[0], inputs[1], z=inputs[2])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return out.float().cpu(), launches, times


def ccsr_tp_step(device, group=None, model_group=None, nudge_seed=None):
    """One fp32 b4 train step of the CCSR CoModGAN config with R1
    (``train_step_check``) on phase 20's batch, over the groups when given:
    the synthesis noise and the co-modulation dropout come from the step's
    generator, which every rank of a data row seeds alike."""
    cfg = ccsr_config("tpu.compute_dtype", "float32", "loaders.batch_size", str(TP_BATCH))
    return train_step_check(cfg, tensor_parallel_batch(), device, seed=SEED,
                            draw_seed=SEED + 20, group=group, model_group=model_group,
                            nudge_seed=nudge_seed)


def ccsr_tp_forwards(model, device, nudge_seed=None):
    """The CCSR G_ema's forward on phase 6's seeded b4 inputs at fp32, then
    under the int8 conv: that forward's K3 and quantizer launches, the
    routed weights' shapes and, over every K3 call, the elements unequal to
    K3's plain version on the same inputs. With ``nudge_seed`` the
    conditioning image is first nudged by a relative 2^-24 (the floor)."""
    cond, c, z = forward_inputs(TP_BATCH, device)
    if nudge_seed is not None:
        gen = torch.Generator(device=device).manual_seed(nudge_seed)
        cond = cond * (1 + 2.0 ** -24 * torch.randn(cond.shape, generator=gen, device=device))
    with torch.no_grad():
        out = model.eval_step(cond, c, z=z).float().cpu()
    calls = []
    real = k3.conv3x3_int8_cuda

    def record(x, w, padding=1, extra_scale=None):
        y = real(x, w, padding, extra_scale)
        calls.append((x, w, padding, y))
        return y

    before = (k3.launches, k3.quantize_launches, k3.weight_quantize_launches)
    k3.conv3x3_int8_cuda = record
    try:
        with conv_impl("int8"), torch.no_grad():
            int8_out = model.eval_step(cond, c, z=z).float().cpu()
    finally:
        k3.conv3x3_int8_cuda = real
    launches = [a - b for a, b in zip((k3.launches, k3.quantize_launches,
                                       k3.weight_quantize_launches), before)]
    unequal = sum(int((k3.conv3x3_int8_plain(x, w, p) != y).sum()) for x, w, p, y in calls)
    return {"out": out, "int8_out": int8_out, "int8_launches": launches,
            "k3_unequal_vs_plain": unequal,
            "k3_weights": sorted({tuple(w.shape) for _, w, _, _ in calls})}


def tensor_parallel_rank(rank, world, out_dir, device):
    """A rank of phase 20 (started by ``parallel.spawn``): at each dtype the
    shipped G_ema sharded over the model group and its forward (timed at
    bf16), then at each dtype one train step; then the CCSR CoModGAN's
    sharded G_ema forward (fp32 and int8) and one fp32 step."""
    group, model_group = parallel.make_groups(world)
    result = {}
    for dtype in TP_DTYPES:
        set_matmul_precision(dtype)
        model = build_eval_model(CMSR_ADNI_G, compute_dtype=dtype,
                                 generator=torch.Generator().manual_seed(SEED))
        model.generator_ema.to(device)
        parallel.shard_module(model.generator_ema, model_group)
        out, launches, times = tensor_parallel_forward(
            model, device, TP_FORWARDS if dtype == "bfloat16" else 0)
        result[dtype] = {"out": out, "k1_launches": launches, "forward_ms": times,
                         "forward_census": model_group.take_census()}
        del model
        torch.cuda.empty_cache()
    for dtype in TP_DTYPES:
        result[dtype]["step"] = tensor_parallel_step(device, dtype, group, model_group)
    set_matmul_precision("float32")
    model = build_eval_model(dict(ccsr_config().model.G), compute_dtype="bfloat16",
                             generator=torch.Generator().manual_seed(SEED))
    model.generator_ema.to(device)
    parallel.shard_module(model.generator_ema, model_group)
    result["ccsr"] = ccsr_tp_forwards(model, device)
    result["ccsr"]["forward_census"] = model_group.take_census()
    del model
    torch.cuda.empty_cache()
    result["ccsr"]["step"] = ccsr_tp_step(device, group, model_group)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def check_tensor_parallel(device):
    """Phase 20: two gloo ranks sharing the card at mesh (1, 2) on the
    shipped CMSR config at full width (parallel.tensor), each at fp32 (TF32
    off) and at bf16, b4. (a) The sharded G_ema forward against the
    unsharded one in this process: at fp32 within 1e-3 * max (7b's bound),
    with K1's launches per rank (every layer runs K1 on its channel slice
    or, replicated, on all channels); (b) one train step against one
    process at the same inputs and draws: at fp32 the losses within rtol
    1e-4 and each net's gradient (whole again) within 1e-4 in relative L2,
    or 10x the rounding floor where that is larger (a one-process step with
    every weight and input nudged by 2^-24), as 15b; the census per purpose
    and each rank's peak; (c) the times at bf16. bf16 is the timed leg: its
    own floor at b4 moves the losses by percents and the gradients by ~10%
    in L2 (this phase's first chip runs: 0.55-9.6% and 9.0-12.1%), so its
    errors are printed beside one process's, not held. Then the CCSR
    CoModGAN on the same ranks (``ccsr_tp_forwards``, ``ccsr_tp_step``):
    (d) its sharded fp32 forward within 1e-3 * max of one process's and
    (f) its sharded int8 forward, with 9 K3 and quantizer launches per rank
    and K3 bit-equal to its plain version on every slice; (e) its
    fp32 step held as (b), against its own floor. The int8 forward is held
    to 8d's 1e-2 * max, or 10x the floor of one process's int8 forward with
    its input nudged by 2^-24 where that is larger, not to 1e-3: the
    sharded convs' float results differ from the whole convs' in the last
    bits (another cuDNN plan per shape), which moves single quantization
    steps (this phase's first chip run: 6.7e-2 of a max of 7.63, the fp32
    forward 1.8e-5 apart).
    Returns each rank's K1/K2 launches and each rank's CCSR int8 launches
    (K3, quantizers)."""
    started = time.perf_counter()
    want = {}
    set_matmul_precision("float32")
    one = tensor_parallel_step(device, "float32")
    nudged = tensor_parallel_step(device, "float32", nudge_seed=SEED + 21)
    loss_floor = max(abs(nudged["metrics"][k] - v) / max(abs(v), 1e-30)
                     for k, v in one["metrics"].items())
    grad_floor = grad_errors(nudged["grads"], one["grads"])
    ccsr_one = ccsr_tp_step(device)
    ccsr_nudged = ccsr_tp_step(device, nudge_seed=SEED + 21)
    ccsr_loss_floor = max(abs(ccsr_nudged["metrics"][k] - v) / max(abs(v), 1e-30)
                          for k, v in ccsr_one["metrics"].items())
    ccsr_grad_floor = grad_errors(ccsr_nudged["grads"], ccsr_one["grads"])
    del ccsr_nudged
    ccsr_want = ccsr_tp_forwards(comodgan_model(), device)
    ccsr_nudged = ccsr_tp_forwards(comodgan_model(), device, nudge_seed=SEED + 22)
    for dtype in TP_DTYPES:
        set_matmul_precision(dtype)
        if dtype != "float32":
            one = tensor_parallel_step(device, dtype)
        want[dtype] = (*tensor_parallel_forward(
            shipped_model(dtype), device, TP_FORWARDS if dtype == "bfloat16" else 0), one)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(tensor_parallel_rank, TP_WORLD, (tmp, device), backend="gloo",
                       init_file=os.path.join(tmp, "store"), device_type=device.type,
                       timeout_s=600)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP_WORLD)]
    rows, failures = {}, []
    for dtype in TP_DTYPES:
        out, launches, times, one = want[dtype]
        got = [r[dtype] for r in ranks]
        out_err = max(float((g["out"] - out).abs().max()) for g in got)
        step = got[0]["step"]
        loss_rel = {k: abs(step["metrics"][k] - v) / max(abs(v), 1e-30)
                    for k, v in one["metrics"].items()}
        err = grad_errors(step["grads"], one["grads"])
        agree = all(torch.equal(got[1]["step"]["grads"][k], g)
                    for k, g in step["grads"].items())
        held = dtype == "float32"
        allowed = {net: max(1e-4, 10 * grad_floor[net]) for net in err} if held else None
        out_bound = 1e-3 * float(out.abs().max()) if held else None
        rows[dtype] = dict(
            forward_max_abs_err=out_err, forward_bound=out_bound,
            forward_max=float(out.abs().max()),
            forward_k1_launches_per_rank=[g["k1_launches"] for g in got],
            forward_census=got[0]["forward_census"], loss_rel_err=loss_rel,
            loss_rel_floor=loss_floor if held else None, loss_bound=1e-4 if held else None,
            grad_rel_l2_err=err, grad_rel_l2_floor=grad_floor if held else None,
            grad_allowed=allowed,
            ranks_hold_equal_gradients=agree, census_per_step=step["census"],
            step_launches_per_rank=[list(g["step"]["launches"]) for g in got],
            one_process_launches=list(one["launches"]),
            peak_gib_per_rank=[g["step"]["peak_bytes"] / 2 ** 30 for g in got],
            one_process_peak_gib=one["peak_bytes"] / 2 ** 30,
            step_ms_per_rank=[g["step"]["ms"] for g in got], one_process_step_ms=one["ms"],
            forward_ms_per_rank=[g["forward_ms"] for g in got], one_process_forward_ms=times)
        if held and not out_err <= out_bound:
            failures.append(f"20a {dtype}: sharded forward {out_err} from one process's "
                            f"(bound {out_bound})")
        if held and (max(loss_rel.values()) > 1e-4 or any(err[n] > allowed[n] for n in err)):
            failures.append(f"20b {dtype}: losses {loss_rel} (bound 1e-4), "
                            f"gradients {err} (allowed {allowed})")
        if not all(np.isfinite(v) for v in step["metrics"].values()):
            failures.append(f"20b {dtype}: losses {step['metrics']}")
        if not agree or launches != LAYERS_WITH_KERNEL \
                or any(g["k1_launches"] != LAYERS_WITH_KERNEL for g in got) \
                or any(tuple(g["step"]["launches"]) != (LAYERS_WITH_KERNEL,) * 2 for g in got):
            failures.append(f"20 {dtype}: ranks agree {agree}, K1 launches "
                            f"{[g['k1_launches'] for g in got]}, step "
                            f"{[g['step']['launches'] for g in got]}")
        if not step["census"].get("tp_gather", {}).get("count"):
            failures.append(f"20b {dtype}: no channel gather in {step['census']}")
    got = [r["ccsr"] for r in ranks]
    step = got[0]["step"]
    ccsr = dict(config=os.path.relpath(CCSR_CONFIG, REPO), batch=TP_BATCH,
                compute_dtype="float32")
    # under int8 a last-bit difference upstream (the sliced convs' cuDNN
    # plans) moves single quantization steps: 8d's 1e-2 * max, or 10x the
    # floor (one process's int8 forward with its input nudged by 2^-24)
    for leg, key, rel in (("forward", "out", 1e-3), ("int8_forward", "int8_out", 1e-2)):
        floor = float((ccsr_nudged[key] - ccsr_want[key]).abs().max())
        bound = rel * float(ccsr_want[key].abs().max())
        if leg == "int8_forward":
            bound = max(bound, 10 * floor)
        err = max(float((g[key] - ccsr_want[key]).abs().max()) for g in got)
        ccsr[leg] = dict(max_abs_err=err, bound=bound, max=float(ccsr_want[key].abs().max()),
                         floor=floor, finite=all(bool(torch.isfinite(g[key]).all())
                                                 for g in got))
        if not (ccsr[leg]["finite"] and err <= bound):
            failures.append(f"20{'d' if leg == 'forward' else 'f'} CCSR {leg}: {err} from one "
                            f"process's (bound {bound})")
    loss_rel = {k: abs(step["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in ccsr_one["metrics"].items()}
    err = grad_errors(step["grads"], ccsr_one["grads"])
    allowed = {net: max(1e-4, 10 * ccsr_grad_floor[net]) for net in err}
    agree = all(torch.equal(got[1]["step"]["grads"][k], g) for k, g in step["grads"].items())
    ccsr.update(
        loss_rel_err=loss_rel, loss_rel_floor=ccsr_loss_floor, loss_bound=1e-4,
        grad_rel_l2_err=err, grad_rel_l2_floor=ccsr_grad_floor, grad_allowed=allowed,
        ranks_hold_equal_gradients=agree, census_per_step=step["census"],
        forward_census=got[0]["forward_census"],
        peak_gib_per_rank=[g["step"]["peak_bytes"] / 2 ** 30 for g in got],
        one_process_peak_gib=ccsr_one["peak_bytes"] / 2 ** 30,
        step_ms_per_rank=[g["step"]["ms"] for g in got], one_process_step_ms=ccsr_one["ms"],
        step_k1_k2_launches_per_rank=[list(g["step"]["launches"]) for g in got],
        int8_launches_per_rank=[g["int8_launches"] for g in got],
        one_process_int8_launches=ccsr_want["int8_launches"],
        k3_weights_per_rank=[g["k3_weights"] for g in got],
        one_process_k3_weights=ccsr_want["k3_weights"],
        k3_unequal_vs_plain_per_rank=[g["k3_unequal_vs_plain"] for g in got])
    if max(loss_rel.values()) > 1e-4 or any(err[n] > allowed[n] for n in err) or not agree:
        failures.append(f"20e CCSR step: losses {loss_rel} (bound 1e-4), gradients {err} "
                        f"(allowed {allowed}), ranks agree {agree}")
    if not all(np.isfinite(v) for v in step["metrics"].values()):
        failures.append(f"20e CCSR step: losses {step['metrics']}")
    sliced = [(o // TP_WORLD, *rest) for o, *rest in ccsr_want["k3_weights"]]
    if any(g["int8_launches"] != [COMOD_INT8_ROUTED] * 3 or g["k3_unequal_vs_plain"]
           or g["k3_weights"] != sliced for g in got) \
            or ccsr_want["int8_launches"] != [COMOD_INT8_ROUTED] * 3:
        failures.append(f"20f CCSR int8: launches {ccsr['int8_launches_per_rank']} (want "
                        f"{COMOD_INT8_ROUTED} of K3 and each quantizer), K3 weights "
                        f"{ccsr['k3_weights_per_rank']} (want {sliced}), unequal to plain "
                        f"{ccsr['k3_unequal_vs_plain_per_rank']}")
    if any(tuple(g["step"]["launches"]) != (0, 0) for g in got) \
            or not step["census"].get("tp_styles", {}).get("count"):
        failures.append(f"20e CCSR step: K1/K2 {ccsr['step_k1_k2_launches_per_rank']}, "
                        f"census {step['census']}")
    phase("20 the model axis on one card", backend="gloo", mesh=[1, TP_WORLD],
          batch=TP_BATCH, spawn_s=spawn_s, seconds=time.perf_counter() - started,
          **rows, ccsr=ccsr)
    if failures:
        raise AssertionError("; ".join(failures))
    return ([[sum(r[d]["k1_launches"] + r[d]["step"]["launches"][0] for d in TP_DTYPES),
              sum(r[d]["step"]["launches"][1] for d in TP_DTYPES)] for r in ranks],
            [g["int8_launches"] for g in got])


# -- phase 19: reference checkpoints -----------------------------------------------

REFERENCE_TAG = "50"               # the reference's {epoch}_net_G_ema.pth


def reference_style(module):
    """A reference AFCM state_dict of the port's ``module`` (on the CPU):
    its own state_dict plus the construction-time buffers the reference
    registers and the port computes (``utils.port.DROP_LEAVES``): each
    alias-free layer's 1-D up/down taps (toRGB has none), each resample
    filter at [4, 4]. Returns the dict and the added keys."""
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    added = []
    for name, mod in module.named_modules():
        for leaf in sorted(DROP_LEAVES):
            value = getattr(mod, leaf, None)
            if value is not None:
                added.append(f"{name}.{leaf}")
                state[added[-1]] = torch.as_tensor(np.asarray(value, np.float32))
    return state, added


def convert_reference(model, g_cfg, out_dir, label):
    """Write ``model``'s G_ema (of the config ``g_cfg``) as a reference
    file, show the strict load (``evaluate.load_generator_ema``) refusing
    it, convert it with ``python -m afcm_tpu_torch.utils.port`` in a
    subprocess into a run directory, and return that directory and the
    phase fields."""
    state, added = reference_style(model.generator_ema)
    ref_dir, run_dir = os.path.join(out_dir, f"{label}_ref"), os.path.join(out_dir, label)
    os.makedirs(ref_dir)
    os.makedirs(run_dir)
    src = os.path.join(ref_dir, f"{REFERENCE_TAG}_net_G_ema.pth")
    torch.save(state, src)
    fresh = build_eval_model(g_cfg, compute_dtype="bfloat16")
    try:
        load_generator_ema(fresh, ref_dir, REFERENCE_TAG)
    except RuntimeError as exc:
        named = [k for k in added if f'"{k}"' in str(exc)]
    else:
        raise AssertionError(f"19: the strict load took the raw {label} reference file")
    if named != added:
        raise AssertionError(f"19: the strict load named {len(named)} of the {len(added)} "
                             f"construction-time buffers of the {label} reference file")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "afcm_tpu_torch.utils.port", src,
         os.path.join(run_dir, f"{REFERENCE_TAG}_net_G_ema.pth")],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"19: the converter failed on the {label} file:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return run_dir, dict(reference_keys=len(state), construction_buffers=len(added),
                         strict_load_refused=named[:4] + ["..."],
                         converter=proc.stdout.strip().splitlines()[-1],
                         converter_s=time.perf_counter() - t0)


def served_predictions(forward, out_dir):
    """The phantom through serve_and_score at b16; the stitched volume it
    writes (``_predictions0.nii.gz``), the scores and the batches."""
    loader = phantom_test_loader(depth=24, size=256, batch_size=SERVE_BATCH, seed=SEED)
    os.makedirs(out_dir)
    scores = serve_and_score(forward, [loader], out_dir, "t1_hr4sr")
    (subject,) = scores["subjects"]
    volume, _ = read_nifti(os.path.join(out_dir, f"{subject}_predictions0.nii.gz"))
    return volume, scores, len(loader)


def net_tensors(nets, inputs):
    """One net's output and every parameter's gradient of a weighted sum of
    it (phase 19c, for ``card_against_cpu``)."""
    (net,) = nets
    *args, weight = inputs
    out = net(*args)
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad((out * weight).sum(), params)
    return {"net.out": out.detach(), **{f"net.grad.{n}": g for n, g in zip(names, grads)}}


def check_reference_checkpoints(device):
    """Phase 19 (ROADMAP A14, A15): (a) the shipped CMSR G_ema (seed 0)
    written as a reference AFCM ``50_net_G_ema.pth``, refused by the strict
    load with its construction-time buffers named, converted by ``python -m
    afcm_tpu_torch.utils.port`` and loaded by ``evaluate.load_generator_ema``
    into a model of other random weights: the phantom through
    serve_and_score at bf16 b16 equals, bit for bit, the volume of the
    weights loaded directly, with 28 K1 launches a batch; (b) the same for
    the CCSR CoModGAN G (configs/adni/comodgan/ccsr.yml with channel
    attention, so the CALayer ``conv_du`` keys are in the file): one
    batch's output bit-equal, no K1; (c) A15's modules on the card against
    the CPU (``card_against_cpu``, fp32, TF32 off): SynthesisInput at
    w_dim 512, 512 channels, 36^2; the StyleGAN-V D at ``orig``, CCSR
    widths, b4; the CCSR D with ``block_kwargs`` resample_filter [1, 2, 1],
    b4. Returns K1's launches on the served path."""
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        direct = shipped_model("bfloat16")
        run_dir, fields = convert_reference(direct, CMSR_ADNI_G, out_dir, "cmsr")
        loaded = build_eval_model(CMSR_ADNI_G, compute_dtype="bfloat16",
                                  generator=torch.Generator().manual_seed(SEED + 19))
        load_generator_ema(loaded, run_dir, REFERENCE_TAG)
        loaded.generator_ema.to(device)
        set_matmul_precision("bfloat16")
        want, _, _ = served_predictions(make_forward_fn(direct, device, seed=SEED,
                                                        norm_range=PHANTOM_RANGE),
                                        os.path.join(out_dir, "direct"))
        k1.launches = 0                          # phase 19's served path starts here
        got, scores, batches = served_predictions(
            make_forward_fn(loaded, device, seed=SEED, norm_range=PHANTOM_RANGE),
            os.path.join(out_dir, "converted"))
        launches = k1.launches
        equal = bool(np.array_equal(got, want))
        phase("19a reference checkpoint CMSR", model="CMSR_ADNI_G", compute_dtype="bfloat16",
              batch=SERVE_BATCH, batches=batches, volume=list(got.shape),
              bit_equal_to_direct=equal, max_abs_diff=float(np.abs(got - want).max()),
              psnr=scores["psnr"], ssim=scores["ssim"], k1_launches=launches, **fields)
        if not equal:
            raise AssertionError("19a: the converted reference checkpoint's volume differs "
                                 "from the directly loaded weights'")
        if launches != LAYERS_WITH_KERNEL * batches:
            raise AssertionError(f"19a: {launches} K1 launches for {batches} batches")
        del direct, loaded

        g_cfg = dict(ccsr_config().model.G)
        g_cfg["synthesis_kwargs"] = dict(g_cfg["synthesis_kwargs"], channel_attention=True)
        direct = build_eval_model(g_cfg, compute_dtype="bfloat16",
                                  generator=torch.Generator().manual_seed(SEED))
        conv_du = sum(".conv_du." in k for k in direct.generator_ema.state_dict())
        run_dir, fields = convert_reference(direct, g_cfg, out_dir, "ccsr")
        loaded = build_eval_model(g_cfg, compute_dtype="bfloat16",
                                  generator=torch.Generator().manual_seed(SEED + 19))
        load_generator_ema(loaded, run_dir, REFERENCE_TAG)
        cond, c, z = forward_inputs(SERVE_BATCH, device)
        k1.launches = 0
        outs = []
        for model in (direct, loaded):
            model.generator_ema.to(device)
            outs.append(model.eval_step(cond, c, z=z))
        equal = torch.equal(*outs)
        phase("19b reference checkpoint CCSR", config=os.path.relpath(CCSR_CONFIG, REPO),
              channel_attention=True, conv_du_keys=conv_du, batch=SERVE_BATCH,
              bit_equal_to_direct=equal, k1_launches=k1.launches, **fields)
        if not (equal and conv_du and k1.launches == 0):
            raise AssertionError("19b: the converted CCSR checkpoint's batch differs from "
                                 f"the direct one's ({equal}, {conv_du} conv_du keys, "
                                 f"{k1.launches} K1)")
        del direct, loaded, outs
    torch.cuda.empty_cache()

    draw = torch.Generator().manual_seed(SEED + 19)
    n = MOTION_BATCH
    synthesis_input = SynthesisInput(w_dim=512, channels=512, size=36, sampling_rate=16,
                                     bandwidth=2, generator=draw)
    with torch.no_grad():                        # a rotation and a translation
        synthesis_input.affine.weight.normal_(generator=draw)
    card_against_cpu("19c SynthesisInput card vs CPU", net_tensors, [synthesis_input],
                     [torch.randn((n, 512), generator=draw),
                      torch.randn((n, 512, 36, 36), generator=draw)], device, batch=n)
    disc = motion.StyleGANVDiscriminator(**STYLEGANV_D, architecture="orig", generator=draw)
    frames, res = STYLEGANV_D["num_frames"], STYLEGANV_D["img_resolution"]
    card_against_cpu("19c StyleGAN-V D orig card vs CPU", net_tensors, [disc],
                     [torch.randn((n, frames, res, res), generator=draw),
                      torch.rand((n, 1), generator=draw),
                      torch.randint(0, STYLEGANV_D["max_num_frames"] - 1, (n, 1),
                                    generator=draw).float(),
                      torch.randn((n, 1), generator=draw)], device, batch=n)
    d_cfg = dict(ccsr_config().model.D)
    block_kwargs = dict(resample_filter=[1, 2, 1])
    disc = CoModDiscriminator(
        c_dim=d_cfg["c_dim"], img_resolution=d_cfg["img_resolution"],
        img_channels=d_cfg["img_channels"], channel_base=d_cfg["channel_base"],
        channel_max=d_cfg["channel_max"], mapping_kwargs=dict(d_cfg["mapping_kwargs"]),
        epilogue_kwargs=dict(d_cfg["epilogue_kwargs"]), block_kwargs=block_kwargs,
        generator=draw)
    card_against_cpu("19c CoModDiscriminator block_kwargs card vs CPU", net_tensors, [disc],
                     [torch.randn((n, d_cfg["img_channels"], d_cfg["img_resolution"],
                                   d_cfg["img_resolution"]), generator=draw),
                      torch.rand((n, d_cfg["c_dim"]), generator=draw),
                      torch.randn((n, 1), generator=draw)], device, batch=n,
                     block_kwargs=block_kwargs)
    phase("19 reference checkpoints", seconds=time.perf_counter() - started)
    torch.cuda.empty_cache()
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", metavar="DIR",
                        help="also trace each leg of phase 6, one train step "
                             "of phase 7 and the CoModGAN forward of phase 12 into DIR")
    args = parser.parse_args(argv)
    started = time.perf_counter()
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
    legs = time_forward(device, args.trace)

    bwd_worst, bwd_ms, bwd_plain_ms, bwd_bound = check_backward_variants(device)
    check_generator_backward(device)
    run_dir, train_launches, train_reference = train_shipped(device, args.trace)
    grads_dir = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    fp32_train = train_fp32(grads_dir)
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
    export_launches = export_shipped(device, 1e3 * SERVE_BATCH / legs["bfloat16_b16"])
    comodgan_int8 = comodgan_serving(device, args.trace)
    comodgan_sums = time_comodgan_convs()
    comodgan_train(device)
    comodgan_export()
    check_pix2pix(device)
    train_pix2pix(device)
    check_motion(device)
    pg_launches = train_process_group(device, train_reference)
    dp_launches = check_data_parallel(device)
    mesh_launches = serve_over_mesh(device)
    remat_launches = check_remat(device, grads_dir,
                                 {("float32", "train", None): fp32_train})
    mix_launches = check_style_mixing(device)
    int8_train_launches = check_int8_train(device)
    reference_launches = check_reference_checkpoints(device)
    tp_launches, tp_int8_launches = check_tensor_parallel(device)
    phase("launches by path", serve={"filtered_lrelu": serve_launches[0],
                                     "filtered_lrelu_bwd": serve_launches[1],
                                     "conv_int8": serve_launches[2]},
          train=train_launches,
          serve_int8={"filtered_lrelu": int8_launches[0],
                      "conv_int8": int8_launches[1],
                      "quantize_int8": int8_launches[2],
                      "quantize_weights_int8": int8_launches[3]},
          probes={e["name"]: e["launches"] for e in probe_entries},
          serve_entry_point={"filtered_lrelu": cli_serve_launches},
          export_artifact={"filtered_lrelu": export_launches},
          comodgan_int8={"filtered_lrelu": comodgan_int8[0], "conv_int8": comodgan_int8[1],
                         "quantize_int8": comodgan_int8[2],
                         "quantize_weights_int8": comodgan_int8[3]},
          train_process_group=pg_launches,
          train_two_ranks={f"rank{r}": {"filtered_lrelu": k, "filtered_lrelu_bwd": b}
                           for r, (k, b) in enumerate(dp_launches)},
          serve_mesh={"filtered_lrelu": mesh_launches}, train_remat=remat_launches,
          train_style_mixing=mix_launches, train_int8=int8_train_launches,
          serve_reference_checkpoint={"filtered_lrelu": reference_launches},
          model_axis_two_ranks={f"rank{r}": {"filtered_lrelu": k, "filtered_lrelu_bwd": b}
                                for r, (k, b) in enumerate(tp_launches)},
          model_axis_ccsr_int8={f"rank{r}": {"conv_int8": k, "quantize_int8": q,
                                             "quantize_weights_int8": w}
                                for r, (k, q, w) in enumerate(tp_int8_launches)})
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

    phase("total", seconds=time.perf_counter() - started)
    comodgan_timed = "the CoModGAN path's three conv shapes (512 -> 512 at 10^2, 18^2, 34^2 p0)"
    print(json.dumps({"kernels": [
        {"name": "filtered_lrelu", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:273",
         "binding": "torch.library operator afcm_tpu_torch::filtered_lrelu",
         "launches": serve_launches[0] + train_launches["filtered_lrelu"]
         + int8_launches[0] + cli_serve_launches + export_launches
         + pg_launches["filtered_lrelu"] + mesh_launches + remat_launches["filtered_lrelu"]
         + mix_launches["filtered_lrelu"] + int8_train_launches["filtered_lrelu"]
         + reference_launches + sum(k for k, _ in tp_launches),
         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
         "timed_at": "the four filter variants' layer shapes, batch 2, fp32, summed"},
        {"name": "filtered_lrelu_bwd", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/filtered_lrelu_bwd.cu",
         "replaces": "afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:292",
         "binding": "torch.library operator afcm_tpu_torch::filtered_lrelu_bwd",
         "launches": train_launches["filtered_lrelu_bwd"] + pg_launches["filtered_lrelu_bwd"]
         + remat_launches["filtered_lrelu_bwd"] + mix_launches["filtered_lrelu_bwd"]
         + int8_train_launches["filtered_lrelu_bwd"] + sum(b for _, b in tp_launches),
         "max_abs_err": bwd_worst, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None,
         "timed_at": "the four filter variants' layer shapes, batch 2, fp32, summed"},
        {"name": "conv_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/conv_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:129",
         "launches": int8_launches[1] + comodgan_int8[1] + int8_train_launches["conv_int8"]
         + sum(k for k, _, _ in tp_int8_launches),
         "max_abs_err": int8_worst, "unequal_elements": unequal,
         "ms": int8_sums["ms"], "plain_ms": int8_sums["plain_ms"],
         "bound_ms": int8_sums["bound"][0], "bound_by": int8_sums["bound"][1],
         "library_ms": int8_sums["library_ms"],
         "library": "cuDNN's bf16 conv (F.conv2d) of the same quantized integers",
         "timed_at": "the int8 path's three conv shapes (512 -> 512 at 36^2 and "
                     "52^2 p2, 38^2 p0), batch 16, device time of one call each "
                     "(median of 5 windows of 10), summed",
         "comodgan": {"timed_at": comodgan_timed + ", batch 16, device time of one call "
                                  "each, summed",
                      "ms": comodgan_sums["ms"], "plain_ms": comodgan_sums["plain_ms"],
                      "bound_ms": comodgan_sums["bound"][0],
                      "bound_by": comodgan_sums["bound"][1],
                      "library_ms": comodgan_sums["library_ms"]},
         "autograd": "K4 = conv3x3_int8_ste: K3 forward, fp32 conv adjoint backward; "
                     "its launches in training are phase 18's"},
        {"name": "quantize_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/quantize_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:258-262",
         "launches": int8_launches[2] + comodgan_int8[2]
         + int8_train_launches["quantize_int8"] + sum(q for _, q, _ in tp_int8_launches),
         "max_abs_err": quantizer_worst["activations"],
         "unequal_elements": quantizer_unequal["activations"],
         "ms": int8_sums["qx_ms"], "ms_spread": int8_sums["qx_spread"],
         "plain_ms": int8_sums["qx_plain_ms"],
         "bound_ms": int8_sums["qx_bound_ms"], "bound_by": "bytes",
         "two_read_bound_ms": int8_sums["qx_two_read_bound_ms"], "library_ms": None,
         "amax_library_ms": int8_sums["qx_amax_library_ms"],
         "amax_library": "torch.linalg.vector_norm(x, inf, dim=(1, 2, 3)): the amax "
                         "half alone, not the same function",
         "timed_at": "the int8 path's three conv inputs (512 channels at 36^2 and 52^2 "
                     "p2, 38^2 p0), batch 16, bf16, device time of one call each (one "
                     "kernel after a memset of its scratch; median of 5 windows of 10, "
                     "the spread the sums of the fastest and the slowest windows), "
                     "summed; bound: x read once, two_read_bound: x read twice",
         "comodgan": {"ms": comodgan_sums["qx_ms"], "ms_spread": comodgan_sums["qx_spread"],
                      "plain_ms": comodgan_sums["qx_plain_ms"],
                      "bound_ms": comodgan_sums["qx_bound_ms"], "bound_by": "bytes",
                      "two_read_bound_ms": comodgan_sums["qx_two_read_bound_ms"],
                      "amax_library_ms": comodgan_sums["qx_amax_library_ms"],
                      "timed_at": comodgan_timed + " inputs, batch 16, float32 (the "
                                  "x that path quantizes)"}},
        {"name": "quantize_weights_int8", "route": "cuda",
         "source": "afcm_tpu_torch/csrc/quantize_int8.cu",
         "replaces": "afcm_tpu/ops/pallas/conv_int8.py:276-280",
         "launches": int8_launches[3] + comodgan_int8[3]
         + int8_train_launches["quantize_weights_int8"]
         + sum(w for _, _, w in tp_int8_launches),
         "max_abs_err": quantizer_worst["weights"],
         "unequal_elements": quantizer_unequal["weights"],
         "ms": int8_sums["qw_ms"], "ms_spread": int8_sums["qw_spread"],
         "plain_ms": int8_sums["qw_plain_ms"],
         "bound_ms": int8_sums["qw_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "timed_at": "the int8 path's 512 -> 512 3x3 weights, float32, device time of "
                     "one call per routed shape (median of 5 windows of 10), summed",
         "comodgan": {"ms": comodgan_sums["qw_ms"], "ms_spread": comodgan_sums["qw_spread"],
                      "plain_ms": comodgan_sums["qw_plain_ms"],
                      "bound_ms": comodgan_sums["qw_bound_ms"], "bound_by": "bytes",
                      "timed_at": comodgan_timed + " weights, float32"}},
        *probe_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
