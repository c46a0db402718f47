"""upfirdn2d — pad, upsample, FIR-filter and downsample NCHW images.

The forward conv path of ``afcm_tpu/ops/upfirdn2d.py`` (``:148-214``) in
plain torch. ``lax.conv_general_dilated`` upsamples with ``lhs_dilation``,
which ``F.conv2d`` lacks, so the port zero-stuffs explicitly; each
separable pass is one depthwise conv (``depthwise_conv2d``).

``gaussian_blur2d`` (``:306-333``) is the training blur fade on the
discriminator's inputs and the L1 targets; ``upsample2d`` (``:283-292``)
carries the CoModGAN skip image up a resolution, ``downsample2d``
(``:295-303``) the ``skip`` discriminator's image down one; ``filter2d``
(``:273-280``) filters at the input's size.

Not ported: the banded-matmul route (``:110-145``, ``:176-181``), which is
TPU routing, and the custom VJP (``:217-270``). That VJP exists to keep the
TPU compiler from lowering the transposed strided convs through data
reversals (``:223-229``); torch autograd computes the same transpose. The
depthwise convs go through ``conv2d_gradfix`` instead, for a reason of
PyTorch's own: R1 differentiates the discriminator's resampling and the blur
twice, and autograd's double backward of a grouped conv runs one conv per
channel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import conv2d_gradfix
from .filter_design import filter_size


def parse_scaling(scaling):
    if isinstance(scaling, (int, np.integer)):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    assert sx >= 1 and sy >= 1
    return sx, sy


def parse_padding(padding):
    if isinstance(padding, (int, np.integer)):
        padding = [padding, padding]
    padding = [int(x) for x in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _as_np_filter(f):
    if f is None:
        return None
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (1, 2)
    return f


def _zero_stuff(x, up: int, axis: int):
    """Insert ``up - 1`` zeros after every sample along ``axis``. The result
    has ``n * up`` samples: the ``up - 1`` trailing zeros are the trailing
    pad that ``afcm_tpu/ops/upfirdn2d.py:67`` folds into its conv padding."""
    if up == 1:
        return x
    shape = list(x.shape)
    shape[axis] *= up
    out = x.new_zeros(shape)
    index = [slice(None)] * x.ndim
    index[axis] = slice(None, None, up)
    out[tuple(index)] = x
    return out


def depthwise_conv2d(x, taps, stride=(1, 1), padding=(0, 0)):
    """Correlate every channel of NCHW ``x`` with the 2-D ``taps`` (a tensor
    or numpy array, never trained) through ``conv2d_gradfix``."""
    channels = x.shape[1]
    # copy(): a reversed 1x1 view keeps its negative strides through
    # np.ascontiguousarray, which torch rejects.
    taps = taps.copy() if isinstance(taps, np.ndarray) else taps.detach()
    weight = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    weight = weight[None, None].expand(channels, 1, *taps.shape).contiguous()
    return conv2d_gradfix.conv2d(x, weight, stride=stride, padding=padding,
                                 groups=channels)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, filter and downsample a batch of NCHW images.

    Args:
      x: [N, C, H, W] tensor.
      f: FIR filter — 1-D [taps] (separable), 2-D [fh, fw], or None (identity);
         numpy constants.
      up / down: int or [x, y] integer resampling factors.
      padding: int, [x, y] or [x0, x1, y0, y1] w.r.t. the upsampled image;
               negative values crop.
      flip_filter: False = convolution, True = correlation.
      gain: overall magnitude scaling.
    """
    assert x.ndim == 4
    f = _as_np_filter(f)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)

    _, _, in_h, in_w = x.shape
    fw, fh = filter_size(f)
    assert in_w * upx + px0 + px1 >= fw and in_h * upy + py0 + py1 >= fh, \
        "upsampled buffer smaller than filter"

    if f is None:
        if (upx, upy, downx, downy) == (1, 1, 1, 1) and gain == 1:
            return F.pad(x, (px0, px1, py0, py1))   # identity FIR: pad only
        f = np.ones([1, 1], dtype=np.float32)

    # Fold gain into the filter; flip for convolution semantics (F.conv2d
    # correlates, the reference convolves by default).
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]

    if f.ndim == 1:
        # Separable: W pass then H pass, each owning the resampling of its
        # own axis (zero rows from the H upsample commute with the W FIR).
        x = _zero_stuff(x, upx, 3)
        x = F.pad(x, (px0, px1, 0, 0))              # negative pads crop
        x = depthwise_conv2d(x, f[None, :], stride=(1, downx))
        x = _zero_stuff(x, upy, 2)
        x = F.pad(x, (0, 0, py0, py1))
        return depthwise_conv2d(x, f[:, None], stride=(downy, 1))
    x = _zero_stuff(_zero_stuff(x, upx, 3), upy, 2)
    x = F.pad(x, (px0, px1, py0, py1))
    return depthwise_conv2d(x, f, stride=(downy, downx))


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample NCHW images by an integer factor with the FIR filter f
    (``afcm_tpu/ops/upfirdn2d.py:283-292``)."""
    upx, upy = parse_scaling(up)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(_as_np_filter(f))
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Filter NCHW images with the FIR filter f, the output padded to the
    input's size (``afcm_tpu/ops/upfirdn2d.py:273-280``)."""
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(_as_np_filter(f))
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample NCHW images by an integer factor with the FIR filter f
    (``afcm_tpu/ops/upfirdn2d.py:295-303``)."""
    downx, downy = parse_scaling(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(_as_np_filter(f))
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)


def gaussian_blur2d(x, sigma, max_radius: int):
    """Gaussian blur of NCHW images with a tensor (or float) ``sigma`` under
    the static footprint ``2 * max_radius + 1``: the taps beyond
    ``floor(3 * sigma)`` are zero, which equals the reference's filter of
    size ``2 * floor(3 * sigma) + 1`` and is the identity for sigma < 1/3
    (``afcm_tpu/ops/upfirdn2d.py:306-333``). Differentiable in ``x`` to any
    order (R1 differentiates through it)."""
    t = torch.arange(-max_radius, max_radius + 1, dtype=torch.float32,
                     device=x.device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    blur_size = torch.floor(sigma * 3.0)
    taps = torch.exp2(-torch.square(t / torch.clamp(sigma, min=1e-8)))
    taps = torch.where(t.abs() <= blur_size, taps, torch.zeros_like(taps))
    taps = taps / taps.sum()
    x = depthwise_conv2d(x, taps[None, :], padding=(0, max_radius))
    return depthwise_conv2d(x, taps[:, None], padding=(max_radius, 0))
