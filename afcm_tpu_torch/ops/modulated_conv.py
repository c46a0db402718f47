"""Plain and style-modulated convolutions (``afcm_tpu/ops/modulated_conv.py``).

The convs run on cuDNN (``F.conv2d`` through ``conv2d_gradfix``, whose
derivatives are convs too), as the JAX package leaves them to ``lax.conv``,
unless ``set_conv_impl`` routes the eligible 3x3 convs to the int8 conv
kernel (``ops/cuda/conv_int8.py``, kernels K3 and K4), as
``afcm_tpu/ops/modulated_conv.py:99-102,122-143`` routes them to its Pallas
kernel. ``modulated_conv2d`` keeps the JAX
package's scale-activations factorization (reference: the
``fused_modconv=False`` path), with demodulation computed without
materializing per-sample weights:

    conv(x, w * s[n,i] * d[n,o])  ==  d[n,o] * conv(x * s[n,i], w)
    d[n,o] = rsqrt( (s^2)[n,:] @ (sum_k w^2)[:, o] + 1e-8 )

Not ported: the lane channel-pad (``:104-118``, TPU layout). The int8 route
has no backend test and no force hook: dispatch is by the tensor's device
(a CPU tensor takes the kernel's plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from . import conv2d_gradfix
from .cuda.conv_int8 import conv3x3_int8_ste, int8_routable

# Quantized inference path: 'int8' routes the 3x3 convs of the gate below to
# the int8 conv kernel; 'int8_all' routes every eligible conv (experiments);
# 'xla' is the float conv (the name the shared configs and docs use for it).
# The train step runs under int8 too: K4's straight-through backward is the
# fp32 conv adjoint, itself differentiable, so R1's double backward crosses
# the discriminator's routed convs as JAX's does (tests/test_torch_int8_train.py,
# chip_smoke.py phase 18). Only the serving CLIs read tpu.conv_int8, as in
# afcm_tpu; a train step runs under it where set_conv_impl is called.
_CONV_IMPL = "xla"
_CONV_INT8_MIN_CH = 64


def _int8_gate(x_shape, w_shape) -> bool:
    """Which convs mode 'int8' quantizes: the small-spatial big-channel
    class, ``min(O, I) >= 256 and H <= 56``. It is the JAX package's
    predicate (``afcm_tpu/ops/modulated_conv.py:46-54``) kept as it is,
    because the gate decides which layers are quantized and with them the
    output under a given config."""
    o, i = int(w_shape[0]), int(w_shape[1])
    return min(o, i) >= 256 and int(x_shape[2]) <= 56


def set_conv_impl(impl: str, variant: str = None, min_ch: int = None):
    """Select the conv implementation: 'xla' (default, the float conv),
    'int8' (the gate above) or 'int8_all' (every eligible conv). ``variant``
    ('dots' | 'im2col') names an inner loop of the TPU kernel; the port has
    one kernel, checks the value and computes the same either way."""
    global _CONV_IMPL, _CONV_INT8_MIN_CH
    if impl not in ("xla", "int8", "int8_all"):
        raise ValueError(f"conv impl {impl!r}")
    _CONV_IMPL = impl
    if variant not in (None, "dots", "im2col"):
        raise ValueError(f"conv_int8 variant {variant!r}")
    if min_ch is not None:
        _CONV_INT8_MIN_CH = int(min_ch)


def get_conv_impl() -> str:
    return _CONV_IMPL


def fma(a, b, c):
    """Fused multiply-add a*b + c (``afcm_tpu/ops/modulated_conv.py:74-77``;
    reference: torch_utils/ops/fma.py, whose unbroadcasting backward is
    autograd's own here)."""
    return a * b + c


def conv2d(x, w, padding=0, groups: int = 1, flip_weight: bool = True,
           out_channels=None):
    """NCHW conv2d (correlation when flip_weight, like torch.conv2d);
    padding is an int or (padH, padW), symmetric. ``out_channels`` is the
    conv's whole output size where ``w`` holds a slice of it (a layer
    sharded over the model axis): the int8 routing decides on the whole
    shape, as ``afcm_tpu``'s does under GSPMD."""
    if isinstance(padding, (int, np.integer)):
        padding = (int(padding), int(padding))
    else:
        padding = (int(padding[0]), int(padding[1]))
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    if _CONV_IMPL in ("int8", "int8_all") and groups == 1:
        # passed only for a slice: a whole conv calls as it did
        y = _try_conv_int8(x, w, padding, *(() if out_channels is None else (out_channels,)))
        if y is not None:
            return y
    return conv2d_gradfix.conv2d(x, w.to(x.dtype), padding=padding, groups=groups)


def _try_conv_int8(x, w, padding, out_channels=None):
    """Route an eligible conv to the int8 conv kernel, else None.

    Eligibility is static, as in the JAX package: equal padding 0..2 on
    both axes, a 3x3 kernel on a square input, channels at or above the
    routing floor, and the gate under mode 'int8', all of the whole conv
    (``out_channels`` output channels; the weight's slice of them is what
    runs). A conv that is eligible runs the kernel or raises; nothing
    declines because the kernel failed. The quantization is per output
    channel, so a slice computes the same channels as the whole conv."""
    whole = (int(out_channels or w.shape[0]), *w.shape[1:])
    if padding[0] != padding[1]:
        return None
    if min(whole[0], whole[1]) < _CONV_INT8_MIN_CH:
        return None
    if _CONV_IMPL == "int8" and not _int8_gate(x.shape, whole):
        return None
    if not int8_routable(x.shape, whole, padding[0]):
        return None
    return conv3x3_int8_ste(x, w.float(), padding[0]).to(x.dtype)


def modulated_conv2d(x, w, s, demodulate: bool = True, padding=0,
                     input_gain=None, out_channels=None):
    """StyleGAN3-style modulated conv (reference: networks_stylegan3.py:24-64).

    Args:
      x: [N, I, H, W] input.
      w: [O, I, kh, kw] weight.
      s: [N, I] styles.
      demodulate: apply weight pre-normalization + demodulation.
      padding: int or (padH, padW).
      input_gain: optional extra scale on input channels: scalar, [I], or [N, I].
      out_channels: the whole O where ``w`` holds a slice of the output
        channels (``conv2d``); the pre-normalization and the demodulation
        reduce over I and the taps of each output channel, so a slice needs
        nothing of the others, but the styles must be whole.
    """
    batch = x.shape[0]
    in_channels = w.shape[1]
    assert s.shape == (batch, in_channels)

    w = w.float()
    s = s.float()
    if demodulate:
        w = w * torch.rsqrt(torch.mean(torch.square(w), dim=(1, 2, 3), keepdim=True))
        s = s * torch.rsqrt(torch.mean(torch.square(s)))

    dcoefs = None
    if demodulate:
        w_sq = torch.sum(torch.square(w), dim=(2, 3))             # [O, I]
        dcoefs = torch.rsqrt(torch.square(s) @ w_sq.T + 1e-8)     # [N, O]

    styles = s
    if input_gain is not None:
        input_gain = torch.as_tensor(input_gain, dtype=torch.float32,
                                     device=s.device)
        styles = styles * input_gain.expand(batch, in_channels)

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d(x, w, padding=padding, out_channels=out_channels)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    return x


def modulated_conv2d_resample(x, weight, styles, noise=None, up: int = 1,
                              down: int = 1, padding: int = 0,
                              resample_filter=None, demodulate: bool = True,
                              flip_weight: bool = True, out_channels=None):
    """StyleGAN2-style modulated conv with fused resampling
    (``afcm_tpu/ops/modulated_conv.py:187-221``; reference:
    CoModGAN/layers.py:19-77): the scale-activations factorization with the
    demodulation coefficients from one [N, I] x [I, O] product, the conv
    through ``conv2d_resample`` (and so ``conv2d`` and its int8 routing),
    and the noise added after the demodulation. ``out_channels`` is the
    whole O where ``weight`` holds a slice of the output channels: the
    routing decides on the whole conv, the demodulation of a slice needs
    its own rows of the weight alone, and the noise [N, 1, H, W] broadcasts
    over the slice's channels."""
    from .conv2d_resample import conv2d_resample

    batch, in_channels = x.shape[0], weight.shape[1]
    assert styles.shape == (batch, in_channels)
    weight = weight.float()
    styles = styles.float()

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight, out_channels=out_channels)
    if demodulate:
        w_sq = torch.sum(torch.square(weight), dim=(2, 3))          # [O, I]
        dcoefs = torch.rsqrt(torch.square(styles) @ w_sq.T + 1e-8)  # [N, O]
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
