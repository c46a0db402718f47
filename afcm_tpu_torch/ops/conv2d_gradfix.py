"""conv2d whose derivatives of every order are convolutions (the idea of
the reference's ``torch_utils/ops/conv2d_gradfix.py``).

Autograd's double backward of ``F.conv2d`` (``_convolution_double_backward``)
computes the weight's term as a forward conv whose kernel is a gradient
image, which cuDNN runs on slow generic kernels, and runs one conv per group
for a grouped conv. R1 differentiates the discriminator twice, through its
convs, its depthwise FIRs and the blur. Here the backward of a conv is its
input-gradient and weight-gradient convolutions (``aten.convolution_backward``,
cuDNN's dgrad and wgrad), each an autograd Function whose own backward is
the other two, so a derivative of any order is one conv per term. The JAX
package needs none of this: XLA differentiates its convs itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def conv2d(x, w, stride=1, padding=0, groups: int = 1):
    """``F.conv2d(x, w, stride=stride, padding=padding, groups=groups)``
    without bias, differentiable to any order through convolutions."""
    return _Conv2d.apply(x, w, _pair(stride), _pair(padding), groups)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _InputGrad.apply(dy, w, x.shape, *ctx.conf)
        if ctx.needs_input_grad[1]:
            dw = _WeightGrad.apply(dy, x, w.shape, *ctx.conf)
        return dx, dw, None, None, None


class _InputGrad(torch.autograd.Function):
    """dx of ``_Conv2d``: the transposed conv of dy back to x's size."""

    @staticmethod
    def forward(ctx, dy, w, x_shape, stride, padding, groups):
        ctx.save_for_backward(dy, w)
        ctx.conf = (stride, padding, groups)
        return conv2d_input(x_shape, w, dy, stride, padding, groups=groups)

    @staticmethod
    def backward(ctx, ddx):
        dy, w = ctx.saved_tensors
        d_dy = d_w = None
        if ctx.needs_input_grad[0]:
            d_dy = _Conv2d.apply(ddx, w, *ctx.conf)
        if ctx.needs_input_grad[1]:
            d_w = _WeightGrad.apply(dy, ddx, w.shape, *ctx.conf)
        return d_dy, d_w, None, None, None, None


class _WeightGrad(torch.autograd.Function):
    """dw of ``_Conv2d``: cuDNN's weight-gradient conv of x and dy."""

    @staticmethod
    def forward(ctx, dy, x, w_shape, stride, padding, groups):
        ctx.save_for_backward(dy, x)
        ctx.conf = (stride, padding, groups)
        return conv2d_weight(x, w_shape, dy, stride, padding, groups=groups)

    @staticmethod
    def backward(ctx, ddw):
        dy, x = ctx.saved_tensors
        d_dy = d_x = None
        if ctx.needs_input_grad[0]:
            d_dy = _Conv2d.apply(x, ddw, *ctx.conf)
        if ctx.needs_input_grad[1]:
            d_x = _InputGrad.apply(dy, ddw, x.shape, *ctx.conf)
        return d_dy, d_x, None, None, None, None
