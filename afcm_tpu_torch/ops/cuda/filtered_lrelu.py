"""Kernels K1 and K2: the fused filtered leaky ReLU, forward and backward,
CUDA C++ for Hopper.

``filtered_lrelu_cuda`` runs ``csrc/filtered_lrelu.cu`` (K1, the port of
``afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:414-500``, kernel ``:273-290``)
as the forward of an autograd Function whose backward is
``csrc/filtered_lrelu_bwd.cu`` (K2, the port of ``bwd_kernel``,
``:292-323``, behind the ``custom_vjp`` at ``:485-495``). The forward saves
only its input and the bias; K2 recomputes the pre-activation from them.
``launches`` and ``bwd_launches`` count the launches of K1 and K2.
``filtered_lrelu_plain`` and ``filtered_lrelu_bwd_plain`` beside them are
the plain PyTorch versions the kernels must reproduce: the CPU path of
``ops.filtered_lrelu`` and the oracles the card's checks compare against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..bias_act import bias_act
from ..upfirdn2d import parse_padding, upfirdn2d

# Launches of the CUDA kernels in this process (tests and chip_smoke.py read
# and reset them): K1, the forward, and K2, the backward.
launches = 0
bwd_launches = 0

_MAX_TAPS = 64          # AFCM_MAX_TAPS in csrc/filtered_lrelu{,_bwd}.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def filtered_lrelu_plain(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                         gain=np.sqrt(2), slope=0.2, clamp=None,
                         flip_filter=False):
    """bias -> upfirdn(fu, up, pad, gain=up²) -> lrelu(slope)·gain, clamp ->
    upfirdn(fd, down): ``afcm_tpu/ops/filtered_lrelu.py:146-151``."""
    px0, px1, py0, py1 = parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


def filtered_lrelu_bwd_plain(x, dy, fu=None, fd=None, b=None, up=1, down=1,
                             padding=0, gain=np.sqrt(2), slope=0.2, clamp=None,
                             flip_filter=False):
    """(dx, db) of ``filtered_lrelu_plain`` at (x, b) for the output
    gradient ``dy``, by autograd; db is None when b is None."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(True)]
        if b is not None:
            inputs.append(b.detach().requires_grad_(True))
        y = filtered_lrelu_plain(inputs[0], fu, fd, inputs[1] if b is not None
                                 else None, up, down, padding, gain, slope,
                                 clamp, flip_filter)
        grads = torch.autograd.grad(y, inputs, dy)
    return grads[0], (grads[1] if b is not None else None)


def slope_ambiguous(x, fu=None, b=None, up=1, padding=0, gain=np.sqrt(2),
                    slope=0.2, clamp=None, flip_filter=False, rtol=1e-5):
    """Bool mask over x: the pixels whose gradient passes through a
    pre-activation within ``rtol * max|pre-activation|`` of the leaky ReLU's
    kink at 0 or of ±clamp. There the slope (or the clamp's cut) is decided
    by rounding, so two correct backward passes whose pre-activations differ
    in the last bits may differ by up to (1 - slope)·gain·|dL/d(act)| per
    up tap. Checks of a backward against another hold it to a bound
    elsewhere and count these pixels."""
    px0, px1, py0, py1 = parse_padding(padding)
    pad = [px0, px1, py0, py1]
    with torch.no_grad():
        pre = upfirdn2d(bias_act(x.float(), None if b is None else b.float()),
                        fu, up=up, padding=pad, gain=up ** 2,
                        flip_filter=flip_filter)
        tol = rtol * float(pre.abs().max())
        near = pre.abs() <= tol
        if clamp is not None:
            act = torch.where(pre > 0, pre, pre * slope).abs() * gain
            near |= (act - clamp).abs() <= tol * gain
    with torch.enable_grad():
        # which inputs the up-FIR carries to those samples: its transpose,
        # with every tap made positive
        z = torch.zeros(x.shape, device=x.device, requires_grad=True)
        mid = upfirdn2d(z, None if fu is None else np.abs(fu), up=up,
                        padding=pad, gain=up ** 2, flip_filter=flip_filter)
        (reach,) = torch.autograd.grad(mid, z, near.float())
    return reach > 0


@functools.lru_cache(maxsize=None)
def _kernel(direction: str):
    """The C entry point of K1 ("fwd") or K2 ("bwd"), built at first use."""
    from ._build import load_library
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    if direction == "fwd":
        fn = load_library("filtered_lrelu")[0].afcm_filtered_lrelu_fwd
        tensors = [p, p, p]                       # x, bias, y
    else:
        fn = load_library("filtered_lrelu_bwd")[0].afcm_filtered_lrelu_bwd
        tensors = [p, p, p, p]                    # x, bias, dy, dx
    fn.argtypes = tensors + [
        i,                                        # dtype
        i, i, i, i, i, i,                         # n, c, in_h, in_w, out_h, out_w
        p, i, p, i,                               # fu, ntu, fd, ntd
        i, i, i, i,                               # up, down, px0, py0
        f, f, f, i,                               # gain, slope, clamp, has_clamp
        p]                                        # stream
    fn.restype = ctypes.c_int
    return fn


def _correlation_taps(f, scale: float, flip_filter: bool) -> np.ndarray:
    """Taps in the kernel's correlation order (flipped unless flip_filter),
    times the per-axis gain; None is the 1-tap identity filter."""
    if f is None:
        return np.asarray([scale], np.float32)
    f = np.asarray(f, np.float32)
    if f.ndim != 1:
        raise NotImplementedError(
            "the filtered_lrelu kernels take separable (1-D) filters only; "
            "radial 2-D filters are used by no shipped config")
    if not 1 <= len(f) <= _MAX_TAPS:
        raise ValueError(f"filter of {len(f)} taps; the kernels take 1..{_MAX_TAPS}")
    f = f if flip_filter else f[::-1]
    return np.ascontiguousarray(f * np.float32(scale), np.float32)


class _Plan:
    """The static arguments of one call, checked and in the kernels' form."""

    def __init__(self, x, fu, fd, up, down, padding, gain, slope, clamp,
                 flip_filter):
        self.up, self.down = int(up), int(down)
        if self.up < 1 or self.down < 1:
            raise ValueError(f"up={up}, down={down}")
        self.px0, px1, self.py0, py1 = parse_padding(padding)
        self.gu = _correlation_taps(fu, self.up, flip_filter)
        self.gd = _correlation_taps(fd, 1.0, flip_filter)
        self.n, self.c, self.in_h, self.in_w = map(int, x.shape)
        taps = (len(self.gu) - 1) + (len(self.gd) - 1)
        self.out_w = (self.in_w * self.up + self.px0 + px1 - taps + self.down - 1) // self.down
        self.out_h = (self.in_h * self.up + self.py0 + py1 - taps + self.down - 1) // self.down
        if self.out_h < 1 or self.out_w < 1:
            raise ValueError(f"empty output {self.out_h}x{self.out_w} for input "
                             f"{self.in_h}x{self.in_w} and padding {padding}")
        self.gain, self.slope = float(gain), float(slope)
        self.has_clamp = clamp is not None
        self.clamp = float(clamp) if self.has_clamp else 0.0

    def scalars(self, dtype):
        return (_DTYPES[dtype], self.n, self.c, self.in_h, self.in_w,
                self.out_h, self.out_w, self.gu.ctypes.data, len(self.gu),
                self.gd.ctypes.data, len(self.gd), self.up, self.down,
                self.px0, self.py0, self.gain, self.slope, self.clamp,
                int(self.has_clamp))


def _check_input(name, x, b):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous 4-D float32 or bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    if b is not None and (b.shape != (x.shape[1],) or b.device != x.device):
        raise ValueError(f"bias of shape {tuple(b.shape)} on {b.device} "
                         f"for {tuple(x.shape)} on {x.device}")


def _launch_fwd(x, b, plan: _Plan):
    global launches
    y = torch.empty((plan.n, plan.c, plan.out_h, plan.out_w), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):       # the launch goes to the current device
        err = _kernel("fwd")(
            x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            *plan.scalars(x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _launch_bwd(x, b, dy, plan: _Plan):
    global bwd_launches
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel("bwd")(
            x.data_ptr(), None if b is None else b.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *plan.scalars(x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


def _bias_grad(dx, b):
    return dx.sum((0, 2, 3), dtype=torch.float32).to(b.dtype)


class _FilteredLRelu(torch.autograd.Function):
    """K1 forward, K2 backward. First order only: R1 differentiates D alone,
    and nothing differentiates G twice."""

    @staticmethod
    def forward(ctx, x, b, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, b)
        return _launch_fwd(x, b, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        # autograd may hand over a strided gradient; the kernel reads it dense
        dx = _launch_bwd(x, b, dy.to(x.dtype).contiguous(), ctx.plan)
        db = _bias_grad(dx, b) if ctx.needs_input_grad[1] else None
        return dx, db, None


def filtered_lrelu_cuda(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                        gain=np.sqrt(2), slope=0.2, clamp=None,
                        flip_filter=False):
    """Kernel K1 on a CUDA tensor, differentiable through kernel K2; same
    arguments and result as ``filtered_lrelu_plain``."""
    _check_input("filtered_lrelu_cuda", x, b)
    if b is not None:
        b = b.to(x.dtype).contiguous()
    plan = _Plan(x, fu, fd, up, down, padding, gain, slope, clamp, flip_filter)
    return _FilteredLRelu.apply(x, b, plan)


def filtered_lrelu_bwd_cuda(x, dy, fu=None, fd=None, b=None, up=1, down=1,
                            padding=0, gain=np.sqrt(2), slope=0.2, clamp=None,
                            flip_filter=False):
    """Kernel K2 on CUDA tensors: (dx, db) of the forward at (x, b) for the
    output gradient ``dy``, as ``filtered_lrelu_bwd_plain``."""
    _check_input("filtered_lrelu_bwd_cuda", x, b)
    plan = _Plan(x, fu, fd, up, down, padding, gain, slope, clamp, flip_filter)
    want = (plan.n, plan.c, plan.out_h, plan.out_w)
    if tuple(dy.shape) != want or dy.device != x.device:
        raise ValueError(f"dy of shape {tuple(dy.shape)} on {dy.device}; the "
                         f"forward's output is {want} on {x.device}")
    xb = None if b is None else b.to(x.dtype).contiguous()
    dx = _launch_bwd(x, xb, dy.to(x.dtype).contiguous(), plan)
    return dx, (None if b is None else _bias_grad(dx, b))
