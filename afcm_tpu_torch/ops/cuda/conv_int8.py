"""Kernels K3 and K4: the int8 3x3 convolution with a dequantizing epilogue,
CUDA C++ for Hopper, and its straight-through autograd Function.

``conv3x3_int8`` is the port of ``afcm_tpu/ops/pallas/conv_int8.py:222-291``:
x is quantized per sample and w per output channel (plain torch, as they are
plain XLA ops around the ``pallas_call`` there), then a CUDA tensor runs
``csrc/conv_int8.cu`` (K3, the port of the kernel body ``:129-156``): nine
shifted int8 x int8 products accumulated in int32 and dequantized to bf16
in one kernel. ``launches`` counts K3's launches. ``conv3x3_int8_plain``
beside it is the plain PyTorch version K3 must reproduce bit for bit: the CPU
path and the oracle of the card's checks. ``conv3x3_int8_ste`` (K4,
``:310-343``) has K3 as its forward and the exact fp32 conv adjoint at the
unquantized x and w as its backward; it has no kernel of its own.

The TPU kernel's memory planning (``plan_blocks``, ``plan_wp``), its
flattened-rows buffer with junk columns, its 128-multiple channel pad and its
``dots`` / ``im2col`` variants are layout devices of that machine and have no
counterpart here; the routing predicates keep their answers on every shape
the generator has (tests/test_torch_int8.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import conv2d_gradfix

# Launches of K3 in this process (tests and chip_smoke.py read and reset it).
launches = 0

_K_ALIGN = 32       # AFCM_C8_KC in csrc/conv_int8.cu: one MMA's K
_M_ALIGN = 128      # AFCM_C8_BM: output channels per CTA


def int8_supported(x_shape, w_shape) -> bool:
    """Shape gate: 3x3, at least 32 channels each way, square input of at
    least 8 pixels (``afcm_tpu/ops/pallas/conv_int8.py:209-219``)."""
    if len(w_shape) != 4 or w_shape[2] != 3 or w_shape[3] != 3:
        return False
    o, i = int(w_shape[0]), int(w_shape[1])
    if o < 32 or i < 32:
        return False
    h, w = int(x_shape[2]), int(x_shape[3])
    return h >= 8 and w >= 8 and h == w


def int8_routable(x_shape, w_shape, padding) -> bool:
    """Full static routing check (``:294-307`` without the TPU's memory
    plan): the shape gate, an integer padding of 0..2 and an output of at
    least 4 pixels."""
    if not int8_supported(x_shape, w_shape):
        return False
    if not isinstance(padding, (int, np.integer)) or not 0 <= padding <= 2:
        return False
    p = int(padding)
    return int(x_shape[2]) + 2 * p - 2 >= 4 and int(x_shape[3]) + 2 * p - 2 >= 4


def quantize_activations(x):
    """Per-sample symmetric int8: ``(xq, x_scale)`` with xq the integer
    values in float32, ``[N,I,H,W]``, and x_scale ``[N]`` (``:258-262``).
    Divides by the scale and rounds half to even, as the JAX package does."""
    xf = x.float()
    x_scale = xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    xq = torch.round(xf / x_scale[:, None, None, None]).clamp_(-127, 127)
    return xq, x_scale


def quantize_weights(w):
    """Per-output-channel symmetric int8: ``(wq, w_scale)`` with wq the
    integer values in float32, ``[O,I,3,3]``, and w_scale ``[O]``
    (``:276-280``)."""
    wf = w.float()
    w_scale = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    wq = torch.round(wf / w_scale[:, None, None, None]).clamp_(-127, 127)
    return wq, w_scale


def dequant_scale(x_scale, w_scale, extra_scale=None):
    """``scale[n,o] = x_scale[n] * w_scale[o] (* extra_scale[n,o])``."""
    scale = x_scale[:, None] * w_scale[None, :]
    if extra_scale is not None:
        scale = scale * extra_scale.float()
    return scale.contiguous()


def int8_conv_plain(xq, wq, scale, padding: int):
    """The plain version of K3 on quantized inputs: the conv of the
    integer-valued xq ``[N,I,H,W]`` and wq ``[O,I,3,3]`` in float64 (exact:
    |acc| < 2^53; an integer or fp32 conv is not, on either device), cast to
    int32, then ``float(acc) * scale[n,o]`` rounded to bf16."""
    acc = F.conv2d(xq.double(), wq.double(), padding=int(padding)).to(torch.int32)
    return (acc.float() * scale[:, :, None, None]).to(torch.bfloat16)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_activations(xq, padding: int):
    """xq ``[N,I,H,W]`` -> K3's input: int8 NHWC ``[N, H+2p, W+2p, I']`` with
    a zero halo of ``padding`` pixels and I' = I rounded up to 32 with
    zeros, so that the kernel's K is contiguous and unmasked."""
    n, i, h, w = xq.shape
    p = int(padding)
    out = torch.zeros((n, h + 2 * p, w + 2 * p, _rup(i, _K_ALIGN)),
                      dtype=torch.int8, device=xq.device)
    out[:, p:p + h, p:p + w, :i] = xq.permute(0, 2, 3, 1)
    return out


def pack_weights(wq):
    """wq ``[O,I,3,3]`` -> K3's weights: int8 ``[9, O', I']``, tap
    ``dy * 3 + dx`` major, O' = O rounded up to 128 and I' to 32 with
    zeros."""
    o, i = wq.shape[:2]
    out = torch.zeros((9, _rup(o, _M_ALIGN), _rup(i, _K_ALIGN)),
                      dtype=torch.int8, device=wq.device)
    out[:, :o, :i] = wq.permute(2, 3, 0, 1).reshape(9, o, i)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of K3, built at first use."""
    from ._build import load_library
    i, p = ctypes.c_int, ctypes.c_void_p
    fn = load_library("conv_int8")[0].afcm_conv3x3_int8
    fn.argtypes = [p, p, p, p,              # x, w, scale, y
                   i, i, i, i, i, i,        # n, o, o', i', h + 2p, w + 2p
                   p]                       # stream
    fn.restype = ctypes.c_int
    return fn


def int8_conv_cuda(x_packed, w_packed, scale, out_channels: int):
    """Kernel K3 on packed CUDA tensors (``pack_activations``,
    ``pack_weights``, ``dequant_scale``): bf16 ``[N, O, Hp-2, Wp-2]``."""
    global launches
    n, hp, wp, ip = x_packed.shape
    taps, op, ip_w = w_packed.shape
    for name, t, dtype in (("x", x_packed, torch.int8), ("w", w_packed, torch.int8),
                           ("scale", scale, torch.float32)):
        if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
                and t.device == x_packed.device):
            raise ValueError(f"int8_conv_cuda needs a contiguous CUDA {dtype} "
                             f"{name}, got {t.dtype} on {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if (taps != 9 or ip_w != ip or ip % _K_ALIGN or op % _M_ALIGN
            or not 1 <= out_channels <= op or hp < 3 or wp < 3
            or tuple(scale.shape) != (n, out_channels)):
        raise ValueError(f"int8_conv_cuda: x {tuple(x_packed.shape)}, w "
                         f"{tuple(w_packed.shape)}, scale {tuple(scale.shape)} "
                         f"for {out_channels} output channels")
    y = torch.empty((n, out_channels, hp - 2, wp - 2), dtype=torch.bfloat16,
                    device=x_packed.device)
    with torch.cuda.device(x_packed.device):    # the launch goes to the current device
        err = _kernel()(x_packed.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                        y.data_ptr(), n, out_channels, op, ip, hp, wp,
                        torch.cuda.current_stream(x_packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _check(x, w, padding):
    if x.ndim != 4 or w.ndim != 4 or x.shape[1] != w.shape[1] or \
            not int8_routable(x.shape, w.shape, padding):
        raise ValueError(f"conv3x3_int8 does not take x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, padding {padding!r} (int8_routable)")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not (x.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"conv3x3_int8 needs float tensors, got {x.dtype}, {w.dtype}")


def conv3x3_int8_plain(x, w, padding: int = 1, extra_scale=None):
    """The plain PyTorch version of ``conv3x3_int8`` on any device: the
    same quantizers, then ``int8_conv_plain``."""
    _check(x, w, padding)
    xq, x_scale = quantize_activations(x)
    wq, w_scale = quantize_weights(w)
    return int8_conv_plain(xq, wq, dequant_scale(x_scale, w_scale, extra_scale),
                           padding)


def conv3x3_int8_cuda(x, w, padding: int = 1, extra_scale=None):
    """``conv3x3_int8`` through kernel K3, on CUDA tensors only."""
    _check(x, w, padding)
    if not x.is_cuda:
        raise ValueError("conv3x3_int8_cuda needs CUDA tensors")
    xq, x_scale = quantize_activations(x)
    wq, w_scale = quantize_weights(w)
    return int8_conv_cuda(pack_activations(xq, padding), pack_weights(wq),
                          dequant_scale(x_scale, w_scale, extra_scale),
                          w.shape[0])


def conv3x3_int8(x, w, padding: int = 1, extra_scale=None):
    """Quantized 3x3 conv: ``y = conv(x, w)``, NCHW, stride 1, symmetric pad.

    Args:
      x: [N, I, H, W] float (bf16/fp32), quantized per sample dynamically.
      w: [O, I, 3, 3] float, quantized per output channel.
      padding: symmetric spatial padding, 0..2 (2 is the full conv of the
        alias-free layers, output H+2 x W+2).
      extra_scale: optional [N, O] factor folded into the dequantization.
    Returns bf16 [N, O, H+2p-2, W+2p-2]. A CPU tensor takes the plain
    version, a CUDA tensor kernel K3; shapes outside ``int8_routable``
    raise."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, w, padding, extra_scale)
    return conv3x3_int8_cuda(x, w, padding, extra_scale)


class _Conv3x3Int8STE(torch.autograd.Function):
    """K4: int8 forward, straight-through fp32 conv backward. First order
    only."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = int(padding)
        return conv3x3_int8(x, w, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        conf = ((1, 1), (ctx.padding, ctx.padding), 1)
        xf, wf, g = x.float(), w.float(), dy.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_gradfix._InputGrad.apply(g, wf, xf.shape, *conf).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv2d_gradfix._WeightGrad.apply(g, xf, wf.shape, *conf).to(w.dtype)
        return dx, dw, None


def conv3x3_int8_ste(x, w, padding: int):
    """``conv3x3_int8`` whose gradients ignore the quantization rounding and
    flow through the exact fp32 conv adjoint at the unquantized x and w, so
    the op is safe under autograd while inference takes the int8 kernel.
    Callers gate on ``int8_routable`` first."""
    return _Conv3x3Int8STE.apply(x, w, padding)
