"""The yardstick: the card's published peaks, the operations a model needs
(counted on the reference networks on the meta device, so they read the
same work whatever implements it) and the least time kernel K1 or K2 could
take for a call (``chip_smoke.py:filtered_lrelu_bound_ms`` at commit
9498692, computed from the reference's frozen layout)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

_aten = torch.ops.aten


def peak_of(dtype: torch.dtype, tf32: bool) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if tf32 else "fp32"


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs of dense convolutions and matrix products (2 per
    multiply-add) by the peak their dtype runs at. Depthwise convolutions,
    the plain path's FIR filters over zero-stuffed images, are counted
    apart (``depthwise``) and are not the algorithm's need."""

    def __init__(self, tf32: bool):
        super().__init__()
        self.tf32 = tf32
        self.flops: Dict[str, float] = {}
        self.conv3x3 = 0.0
        self.depthwise = 0.0

    def _add(self, dtype, flops):
        key = peak_of(dtype, self.tf32)
        self.flops[key] = self.flops.get(key, 0.0) + flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "overloadpacket", None)
        if packet is _aten.convolution:
            x, w = args[0], args[1]
            groups = args[8]
            y = out
            flops = 2.0 * y.numel() * (w.shape[1] * w.shape[2] * w.shape[3])
            if groups > 1 and w.shape[1] == 1:
                self.depthwise += flops
            else:
                self._add(x.dtype, flops)
                if w.shape[2] == 3 and w.shape[3] == 3:
                    self.conv3x3 += flops
        elif packet is _aten.convolution_backward:
            dy, x, w = args[0], args[1], args[2]
            groups = args[9]
            mask = args[10]
            per = 2.0 * dy.numel() * (w.shape[1] * w.shape[2] * w.shape[3])
            if groups > 1 and w.shape[1] == 1:
                self.depthwise += per * sum(bool(m) for m in mask[:2])
            else:
                self._add(x.dtype, per * sum(bool(m) for m in mask[:2]))
        elif packet in (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm):
            a, b = (args[1], args[2]) if packet in (_aten.addmm, _aten.baddbmm) \
                else (args[0], args[1])
            flops = 2.0 * a.numel() * b.shape[-1]
            self._add(a.dtype, flops)
        return out


def least_seconds(flops: Dict[str, float]) -> float:
    """The least time at the peaks: sum over precisions of FLOPs / peak."""
    return sum(f / PEAK_FLOPS[k] for k, f in flops.items())


def fir_fmas(n: int, c: int, in_size: int, out_size: int, up: int, down: int,
             ntu: int, ntd: int, backward: bool = False) -> float:
    """The FMAs of one filtered_lrelu call in the separable polyphase form:
    per plane the up-FIR touches ceil(ntu / up) taps per sample (W pass over
    the input rows, H pass over the mid window the output needs), the
    down-FIR ntd taps (H then W pass); the backward recomputes the up
    passes and runs both transposed."""
    mid = (out_size - 1) * down + ntd
    up_fmas = (in_size * mid + mid * mid) * -(-ntu // up)
    down_fmas = (out_size * mid + out_size * out_size) * ntd
    return n * c * ((2 * up_fmas + down_fmas) if backward else (up_fmas + down_fmas))


def k1_layers(synthesis):
    """(in_size, out_size, channels, up, down, ntu, ntd) of every layer of
    a reference StyleGAN3 synthesis network that runs filtered_lrelu with
    filters (all but toRGB), in call order."""
    out = []
    for layer in list(synthesis.encoders) + list(synthesis.decoders):
        if layer.spec.is_torgb:
            continue
        ntu = 1 if layer.up_filter is None else len(layer.up_filter)
        ntd = 1 if layer.down_filter is None else len(layer.down_filter)
        out.append((layer.spec.in_size + 2, layer.spec.out_size, layer.spec.out_channels,
                    layer.up, layer.down, ntu, ntd))
    return out


def filtered_lrelu_bound_s(n: int, layer, element_size: int,
                           backward: bool = False) -> float:
    """The least time of one call (or its backward) on a batch of ``n``:
    the larger of the bytes it must move (x and the bias read, y written;
    backward: x and dy read, dx written) over the HBM rate and its FMAs
    over the fp32 rate."""
    in_size, out_size, c, up, down, ntu, ntd = layer
    fmas = fir_fmas(n, c, in_size, out_size, up, down, ntu, ntd, backward)
    x_bytes = n * c * in_size * in_size * element_size
    y_bytes = n * c * out_size * out_size * element_size
    nbytes = (2 * x_bytes + y_bytes) if backward else (x_bytes + c * element_size + y_bytes)
    return max(nbytes / HBM_BYTES_PER_S, 2 * fmas / PEAK_FLOPS["fp32"])


def forward_k1_bound_s(synthesis, n: int, element_size: int,
                       backward: bool = False) -> float:
    """Sum of K1's (or K2's) bounds over one forward's launches."""
    return sum(filtered_lrelu_bound_s(n, layer, element_size, backward)
               for layer in k1_layers(synthesis))


def fir_flops_fp32(synthesis, n: int, backward: bool = False) -> float:
    """The FIR FLOPs of the K1 layers, which the kernels run in fp32."""
    return sum(2.0 * fir_fmas(n, c, i, o, up, down, ntu, ntd, backward)
               for i, o, c, up, down, ntu, ntd in k1_layers(synthesis))


def _meta_gan(cfg: dict):
    from ..reference.gan import GAN, build_discriminator, build_generator
    dtype = cfg["tpu"]["compute_dtype"]
    with torch.device("meta"):
        g = build_generator(cfg["model"]["G"], compute_dtype=dtype)
        d = build_discriminator(cfg["model"]["D"], compute_dtype=dtype)
    return GAN(cfg, g, d)


def serve_work(cfg: dict) -> Dict[str, float]:
    """FLOPs of one served slice by peak, with the K1 layers' FIRs at their
    polyphase need (fp32) and the plain path's depthwise FIRs left out."""
    from ..reference.gan import build_generator, eval_forward
    dtype = cfg["tpu"]["compute_dtype"]
    tf32 = dtype != "float32"
    g_cfg = cfg["model"]["G"]
    with torch.device("meta"):
        g = build_generator(g_cfg, compute_dtype=dtype)
        res = g_cfg["img_resolution"]
        cond = torch.empty((1, g_cfg["img_channels_in"], res, res))
        s = torch.empty((1, 1))
        z = torch.empty((1, g_cfg["z_dim"]))
    counter = OpCounter(tf32)
    with torch.no_grad(), counter:
        eval_forward(g, g_cfg["c_dim"], cond, s, z)
    flops = dict(counter.flops)
    if g_cfg["netG"] == "stylegan3":
        flops["fp32"] = flops.get("fp32", 0.0) + fir_flops_fp32(g.synthesis, 1)
    flops["conv3x3"] = counter.conv3x3
    return flops


def train_work(cfg: dict) -> Dict[str, float]:
    """FLOPs of one training step of the configuration's batch, by peak:
    the reference step on the meta device (D phase with R1, G phase, both
    backward passes), with the K1 layers' FIRs at their polyphase need for
    the one G forward and its backward."""
    gan = _meta_gan(cfg)
    n = cfg["loaders"]["batch_size"]
    g_cfg = cfg["model"]["G"]
    res = g_cfg["img_resolution"]
    with torch.device("meta"):
        batch = {"A": torch.empty((n, g_cfg["img_channels_in"], res, res)),
                 "B": torch.empty((n, g_cfg["img_channels_out"], res, res)),
                 "slice_idx": torch.empty((n, 1))}
    gan._step = lambda optimizer, params, loss: torch.autograd.grad(
        loss, params, allow_unused=True)
    counter = OpCounter(cfg["tpu"]["compute_dtype"] != "float32")
    with counter:
        gan.train_step(batch, cur_nimg=float(n), with_r1=True, generator=None)
    flops = dict(counter.flops)
    if g_cfg["netG"] == "stylegan3":
        forwards = 1 if cfg["tpu"].get("shared_g_fwd", False) else 2
        synthesis = gan.generator.synthesis
        flops["fp32"] = flops.get("fp32", 0.0) + forwards * fir_flops_fp32(synthesis, n) \
            + fir_flops_fp32(synthesis, n, backward=True)
    return flops


def mfu(flops: Dict[str, float], items_per_s: float, items: int = 1) -> Optional[float]:
    """The share (%) of the peaks that ``flops`` of ``items`` items at
    ``items_per_s`` reach: the least time of an item at the peaks over the
    measured time of an item."""
    if not items_per_s or items_per_s <= 0 or math.isnan(items_per_s):
        return None
    least = least_seconds({k: v for k, v in flops.items() if k in PEAK_FLOPS}) / items
    return 100.0 * least * items_per_s
