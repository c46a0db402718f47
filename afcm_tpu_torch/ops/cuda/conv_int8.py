"""Kernels K3 and K4: the int8 3x3 convolution with a dequantizing epilogue,
CUDA C++ for Hopper, and its straight-through autograd Function.

``conv3x3_int8`` is the port of ``afcm_tpu/ops/pallas/conv_int8.py:222-291``:
x is quantized per sample and w per output channel, then
``csrc/conv_int8.cu`` (K3, the port of the kernel body ``:129-156``) runs nine
shifted int8 x int8 products accumulated in int32 and dequantized to bf16
in one kernel. The quantizers are plain XLA ops around the ``pallas_call``
there (``:258-262``, ``:276-280``) that the compiler fuses; on a CUDA tensor
they are the two kernels of ``csrc/quantize_int8.cu``, which also write
K3's packed layouts (``quantize_pack_activations_cuda``: one persistent
kernel whose CTAs take each sample's maximum and then its quantize tiles in
the order of tickets, after one memset of its scratch;
``quantize_pack_weights_cuda``: one kernel writing 16-byte runs).
``plan_quantize_activations`` and ``plan_quantize_weights`` mirror the
plans the C side computes (``kernel_activation_plan`` and
``kernel_weight_plan`` read those on the card). ``launches`` counts K3's
launches, ``quantize_launches`` and ``weight_quantize_launches`` the
quantizers'.
``conv3x3_int8_plain`` beside it is the plain PyTorch version K3 must
reproduce bit for bit, and ``quantize_pack_*_plain`` the quantizers': the
CPU path and the oracles of the card's checks. ``conv3x3_int8_ste`` (K4,
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import conv2d_gradfix

# Launches in this process (tests and chip_smoke.py read and reset them): K3,
# the activation quantizer and the weight quantizer (one kernel each).
launches = 0
quantize_launches = 0
weight_quantize_launches = 0

_K_ALIGN = 32       # AFCM_C8_KC in csrc/conv_int8.cu: one product's K
_M_ALIGN = 128      # AFCM_C8_M_ALIGN: the packed weights' channel pad
_M_TILE = 64        # AFCM_C8_BM: output channels per CTA and per weight block
_TILE_COLS = 8      # AFCM_C8_TW: K3's pixel tile is 8 columns wide
_TILE_ROWS = (18, 20)   # ... and 18 or 20 rows high (wgmma N = 144 or 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/quantize_int8.cu's constants
_Q8_THREADS = 256           # AFCM_Q8_THREADS
_Q8_WARPS = _Q8_THREADS // 32
_Q8_CTAS_PER_SM = 3         # AFCM_Q8_CTAS_PER_SM
_Q8_GROUP = 64              # AFCM_Q8_GROUP: channels of a quantize tile
_Q8_A_VECS = 8              # AFCM_Q8_A_VECS: 16-byte loads a thread makes in an amax tile
_Q8_W_BAR = 16              # W_BAR_BYTES: the weight kernel's mbarrier, padded
SMEM_LIMIT = 232448         # a CTA's shared memory on sm_90
H100_SMS = 132


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


def _over_127(amax):
    """``amax / 127`` as a true division on every device. The divisor is a
    tensor: on a CUDA tensor PyTorch turns a division by a Python scalar into
    a product with its reciprocal, which rounds some scales one unit away
    from the CPU's, the JAX package's and the quantizer kernels'."""
    return amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device)


def quantize_activations(x):
    """Per-sample symmetric int8: ``(xq, x_scale)`` with xq the integer
    values in float32, ``[N,I,H,W]``, and x_scale ``[N]`` (``:258-262``).
    Divides by the scale and rounds half to even, as the JAX package does."""
    xf = x.float()
    x_scale = _over_127(xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8))
    xq = torch.round(xf / x_scale[:, None, None, None]).clamp_(-127, 127)
    return xq, x_scale


def quantize_weights(w):
    """Per-output-channel symmetric int8: ``(wq, w_scale)`` with wq the
    integer values in float32, ``[O,I,3,3]``, and w_scale ``[O]``
    (``:276-280``)."""
    wf = w.float()
    w_scale = _over_127(wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12))
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
    """wq ``[O,I,3,3]`` -> K3's weights: int8 ``[O'/64, I'/32, 9, 2, 64,
    16]``, O' = O rounded up to 128 and I' to 32 with zeros. One contiguous
    block of 18 KB per (64 output channels, 32 input channels), inside it
    tap ``dy * 3 + dx``, K chunk of 16 input channels, output channel,
    input channel: the order the kernel's shared memory holds a step's
    weights in, so that a step is one bulk copy."""
    o, i = wq.shape[:2]
    op, ip = _rup(o, _M_ALIGN), _rup(i, _K_ALIGN)
    flat = torch.zeros((9, op, ip), dtype=torch.int8, device=wq.device)
    flat[:, :o, :i] = wq.permute(2, 3, 0, 1).reshape(9, o, i)
    return flat.reshape(9, op // _M_TILE, _M_TILE, ip // _K_ALIGN, 2, 16) \
        .permute(1, 3, 0, 4, 2, 5).contiguous()


def unpack_weights(w_packed):
    """K3's weights back as int8 ``[9, O', I']``, tap-major: the inverse of
    ``pack_weights``' tiling."""
    mb, kb = w_packed.shape[:2]
    return w_packed.permute(2, 0, 4, 1, 3, 5).reshape(9, mb * _M_TILE, kb * _K_ALIGN)


def quantize_pack_activations_plain(x, padding: int):
    """The plain version of the activation quantizer kernel:
    ``(pack_activations(xq, padding), x_scale)`` of ``quantize_activations``."""
    xq, x_scale = quantize_activations(x)
    return pack_activations(xq, padding), x_scale


def quantize_pack_weights_plain(w):
    """The plain version of the weight quantizer kernel:
    ``(pack_weights(wq), w_scale)`` of ``quantize_weights``."""
    wq, w_scale = quantize_weights(w)
    return pack_weights(wq), w_scale


def plan_tile_rows(out_h: int) -> int:
    """The height of K3's pixel tile for an output of ``out_h`` rows: 18 or
    20, whichever covers the rows with less idle work (18 on a tie)."""
    return min(_TILE_ROWS, key=lambda r: (-(-out_h // r) * r, r))


def tile_idle_share(out_h: int, out_w: int) -> float:
    """Share of K3's products that fall on pixels outside the output: its
    tiles of 8 columns x ``plan_tile_rows`` rows cover more than the image."""
    r = plan_tile_rows(out_h)
    covered = -(-out_h // r) * r * -(-out_w // _TILE_COLS) * _TILE_COLS
    return 1.0 - out_h * out_w / covered


def _static_smem(nbytes: int) -> int:
    """A kernel's static shared memory of ``nbytes`` as compiled for sm_90:
    rounded up to 16 bytes."""
    return _rup(nbytes, 16)


class ActivationPlan(NamedTuple):
    """``plan_activations`` of ``csrc/quantize_int8.cu``."""
    n: int
    i: int
    ip: int
    h: int
    w: int
    p: int
    vec: int            # pixels a lane loads at once (V)
    chunks: int         # quantize tiles along the plane ...
    groups: int         # ... x channel groups of 64
    halo: int           # zero pixels of a padded plane
    halo_share: int     # ... a chunk's share
    count: int          # elements of a sample
    a_elems: int        # elements of an amax tile
    ta: int             # amax tiles a sample
    tq: int             # quantize tiles a sample
    lag: int            # L: A(0..L-1) come before Q(0)
    grid: int           # persistent CTAs
    tickets: int
    smem: int           # static shared memory of a CTA


def plan_quantize_activations(n: int, i: int, h: int, w: int, p: int, itemsize: int,
                              address: int = 0, sms: int = H100_SMS) -> ActivationPlan:
    """The activation kernel's plan for x ``[n, i, h, w]`` of ``itemsize``
    bytes an element at device ``address`` (only its remainder mod 16
    matters) on a card of ``sms`` SMs."""
    ip, hw = _rup(i, _K_ALIGN), h * w
    vec = next((v for v in (16 // itemsize, 8 // itemsize, 4 // itemsize)
                if v > 1 and hw % v == 0 and address % (v * itemsize) == 0), 1)
    passes = -(-hw // (4 * vec))
    chunks, groups = -(-passes // _Q8_WARPS), -(-ip // _Q8_GROUP)
    halo = (h + 2 * p) * (w + 2 * p) - hw
    count, a_elems = i * hw, _Q8_THREADS * _Q8_A_VECS * 16 // itemsize
    ta, tq = -(-count // a_elems), chunks * groups
    tickets = n * (ta + tq)
    grid = min(tickets, sms * _Q8_CTAS_PER_SM)
    lag = min(n, -(-grid // ta) + 1)
    return ActivationPlan(n, i, ip, h, w, p, vec, chunks, groups, halo, -(-halo // chunks),
                          count, a_elems, ta, tq, lag, grid, tickets,
                          smem=_static_smem(2 * 8 + 4 + 4))


class WeightPlan(NamedTuple):
    """``plan_weights`` of ``csrc/quantize_int8.cu``: one CTA an output
    channel of O'."""
    o: int
    op: int
    i: int
    ip: int
    smem: int           # dynamic (the mbarrier, the row) + static shared memory
    bulk: int           # the row comes by a bulk copy


def plan_quantize_weights(o: int, i: int, itemsize: int, address: int = 0) -> WeightPlan:
    """The weight kernel's plan for w ``[o, i, 3, 3]`` of ``itemsize`` bytes
    an element at device ``address``. Raises where the kernel refuses (a
    row larger than a CTA's shared memory)."""
    op, ip = _rup(o, _M_ALIGN), _rup(i, _K_ALIGN)
    row = i * 9 * itemsize
    smem = _Q8_W_BAR + row + _static_smem(4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"quantize_pack_weights_cuda: {i} input channels: a row of {row} "
                         f"bytes does not fit a CTA's shared memory")
    return WeightPlan(o, op, i, ip, smem, int(row % 16 == 0 and address % 16 == 0))


def kernel_activation_plan(n: int, i: int, h: int, w: int, p: int, itemsize: int,
                           address: int = 0) -> ActivationPlan:
    """The C side's plan (``afcm_quantize_activations_plan``) on the current
    card, with the kernel's static shared memory as compiled, to hold
    ``plan_quantize_activations`` to."""
    from ._build import load_library
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    info = (ctypes.c_longlong * len(ActivationPlan._fields))()
    c = ctypes.c_int
    err = load_library("quantize_int8")[0].afcm_quantize_activations_plan(
        c(n), c(i), c(_rup(i, _K_ALIGN)), c(h), c(w), c(p), c(itemsize),
        ctypes.c_longlong(address), c(sms), info)
    if err != 0:
        raise RuntimeError(f"afcm_quantize_activations_plan: CUDA error {err}")
    return ActivationPlan(*info)


def kernel_weight_plan(o: int, i: int, itemsize: int, address: int = 0) -> WeightPlan:
    """The C side's plan (``afcm_quantize_weights_plan``), with the kernel's
    static shared memory as compiled, to hold ``plan_quantize_weights``
    to."""
    from ._build import load_library
    info = (ctypes.c_int * len(WeightPlan._fields))()
    err = load_library("quantize_int8")[0].afcm_quantize_weights_plan(
        o, _rup(o, _M_ALIGN), i, _rup(i, _K_ALIGN), itemsize, ctypes.c_longlong(address), info)
    if err != 0:
        raise RuntimeError(f"afcm_quantize_weights_plan: CUDA error {err}")
    return WeightPlan(*info)


@functools.lru_cache(maxsize=None)
def _kernel(name: str = "conv"):
    """A C entry point, built at first use: K3 ("conv"), the activation
    quantizer ("activations") or the weight quantizer ("weights")."""
    from ._build import load_library
    i, p = ctypes.c_int, ctypes.c_void_p
    if name == "conv":
        fn = load_library("conv_int8")[0].afcm_conv3x3_int8
        fn.argtypes = [p, p, p, p,              # x, w, scale, y
                       i, i, i, i, i, i,        # n, o, o', i', h + 2p, w + 2p
                       i, p]                    # tile rows, stream
    elif name == "activations":
        fn = load_library("quantize_int8")[0].afcm_quantize_activations
        fn.argtypes = [p, p, p, p,              # x, scratch, x_scale, out
                       i, i, i, i, i, i, i,     # dtype, n, i, i', h, w, padding
                       p]                       # stream
    else:
        fn = load_library("quantize_int8")[0].afcm_quantize_weights
        fn.argtypes = [p, p, p,                 # w, w_scale, out
                       i, i, i, i, i,           # dtype, o, o', i, i'
                       p]                       # stream
    fn.restype = ctypes.c_int
    return fn


def _check_quantizer_input(name, t):
    if not (isinstance(t, torch.Tensor) and t.is_cuda and t.ndim == 4
            and t.dtype in _DTYPES and t.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous 4-D float32 or bfloat16 CUDA "
                         f"tensor, got {tuple(t.shape)} {t.dtype} on {t.device} "
                         f"contiguous={t.is_contiguous()}")


def quantize_pack_activations_cuda(x, padding: int):
    """The activation quantizer kernel on a CUDA tensor x ``[N,I,H,W]``:
    ``(int8 [N, H+2p, W+2p, I'], x_scale [N])``, bit for bit what
    ``quantize_pack_activations_plain`` gives."""
    global quantize_launches
    _check_quantizer_input("quantize_pack_activations_cuda", x)
    p = int(padding)
    n, i, h, w = x.shape
    if p < 0:
        raise ValueError(f"quantize_pack_activations_cuda: padding {padding}")
    ip = _rup(i, _K_ALIGN)
    out = torch.empty((n, h + 2 * p, w + 2 * p, ip), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    # the ticket counter, done[n], amax[n], the published scales: each call its own
    scratch = torch.empty((3 * n + 1,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):           # the launch goes to the current device
        err = _kernel("activations")(
            x.data_ptr(), scratch.data_ptr(), x_scale.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], n, i, ip, h, w, p,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 activation kernel failed: CUDA error {err}")
    quantize_launches += 1
    return out, x_scale


def quantize_pack_weights_cuda(w):
    """The weight quantizer kernel on a CUDA tensor w ``[O,I,3,3]``:
    ``(int8 [O'/64, I'/32, 9, 2, 64, 16], w_scale [O])``, bit for bit what
    ``quantize_pack_weights_plain`` gives."""
    global weight_quantize_launches
    _check_quantizer_input("quantize_pack_weights_cuda", w)
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"quantize_pack_weights_cuda needs 3x3 weights, got {tuple(w.shape)}")
    o, i = w.shape[:2]
    op, ip = _rup(o, _M_ALIGN), _rup(i, _K_ALIGN)
    out = torch.empty((op // _M_TILE, ip // _K_ALIGN, 9, 2, _M_TILE, 16),
                      dtype=torch.int8, device=w.device)
    w_scale = torch.empty((o,), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _kernel("weights")(
            w.data_ptr(), w_scale.data_ptr(), out.data_ptr(), _DTYPES[w.dtype],
            o, op, i, ip, torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 weight kernel failed: CUDA error {err}")
    weight_quantize_launches += 1
    return out, w_scale


def int8_conv_cuda(x_packed, w_packed, scale, out_channels: int):
    """Kernel K3 on packed CUDA tensors (``pack_activations``,
    ``pack_weights``, ``dequant_scale``): bf16 ``[N, O, Hp-2, Wp-2]``."""
    global launches
    n, hp, wp, ip = x_packed.shape
    for name, t, dtype in (("x", x_packed, torch.int8), ("w", w_packed, torch.int8),
                           ("scale", scale, torch.float32)):
        if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
                and t.device == x_packed.device):
            raise ValueError(f"int8_conv_cuda needs a contiguous CUDA {dtype} "
                             f"{name}, got {t.dtype} on {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if w_packed.ndim != 6 or tuple(w_packed.shape[2:]) != (9, 2, _M_TILE, 16):
        raise ValueError(f"int8_conv_cuda: w {tuple(w_packed.shape)} is not "
                         "pack_weights' [O'/64, I'/32, 9, 2, 64, 16]")
    op, ip_w = w_packed.shape[0] * _M_TILE, w_packed.shape[1] * _K_ALIGN
    if (ip_w != ip or ip % _K_ALIGN or op % _M_ALIGN
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
                        plan_tile_rows(hp - 2),
                        torch.cuda.current_stream(x_packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _kernel_takes(x_shape, w_shape, padding) -> bool:
    """What K3 and its plain version take: a conv ``int8_routable`` passes
    but for its floor of 32 output channels, which belongs to the routing:
    the kernel masks the output channels it computes past O, so the slice
    of a conv sharded over the model axis runs (``ops/modulated_conv.py``
    decides the routing on the whole conv)."""
    return int8_routable(x_shape, (max(int(w_shape[0]), 32), *w_shape[1:]), padding)


def _check(x, w, padding):
    if x.ndim != 4 or w.ndim != 4 or x.shape[1] != w.shape[1] or \
            not _kernel_takes(x.shape, w.shape, padding):
        raise ValueError(f"conv3x3_int8 does not take x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, padding {padding!r} (int8_routable)")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not (x.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"conv3x3_int8 needs float tensors, got {x.dtype}, {w.dtype}")


def _quantizable(t):
    """t as the quantizer kernels read it: float32 or bfloat16, contiguous
    (other float types go through float32, as the plain version's
    ``.float()``)."""
    if t.dtype not in _DTYPES:
        t = t.float()
    return t.contiguous()


def conv3x3_int8_plain(x, w, padding: int = 1, extra_scale=None):
    """The plain PyTorch version of ``conv3x3_int8`` on any device: the
    same quantizers, then ``int8_conv_plain``."""
    _check(x, w, padding)
    xq, x_scale = quantize_activations(x)
    wq, w_scale = quantize_weights(w)
    return int8_conv_plain(xq, wq, dequant_scale(x_scale, w_scale, extra_scale),
                           padding)


def conv3x3_int8_cuda(x, w, padding: int = 1, extra_scale=None):
    """``conv3x3_int8`` through the quantizer kernels and kernel K3, on CUDA
    tensors only (float32 or bfloat16; non-contiguous ones are copied)."""
    _check(x, w, padding)
    if not x.is_cuda:
        raise ValueError("conv3x3_int8_cuda needs CUDA tensors")
    x_packed, x_scale = quantize_pack_activations_cuda(_quantizable(x), padding)
    w_packed, w_scale = quantize_pack_weights_cuda(_quantizable(w))
    return int8_conv_cuda(x_packed, w_packed,
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
    """K4: int8 forward, straight-through fp32 conv backward. The backward
    is made of ``conv2d_gradfix``'s differentiable adjoints, so a second
    derivative (R1 through a routed discriminator conv) is that of the fp32
    conv, as JAX differentiates the ``custom_vjp``'s backward rule."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = int(padding)
        return conv3x3_int8(x, w, padding)

    @staticmethod
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
