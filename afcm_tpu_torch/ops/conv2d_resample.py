"""conv2d with fused up/down FIR resampling (``afcm_tpu/ops/conv2d_resample.py``).

The generic composition upfirdn(f, up, pad, gain=up²) -> conv(w) ->
upfirdn(f, down), with the reference's padding arithmetic
(torch_utils/ops/conv2d_resample.py:46-141).
"""

from __future__ import annotations

from . import conv2d_gradfix
from .filter_design import filter_size
from .modulated_conv import conv2d
from .upfirdn2d import parse_padding, upfirdn2d


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding=0,
                    groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False, out_channels=None):
    """2D conv with optional up/downsampling (padding w.r.t. upsampled image).
    ``out_channels``: the conv's whole output size where ``w`` holds a slice
    of it (``conv2d``)."""
    assert x.ndim == 4 and w.ndim == 4
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if down > 1 and up == 1:
        # Anti-alias filter, then strided conv (reference fast path,
        # conv2d_resample.py:105-109: the FIR comes before the conv).
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
            w = w.flip([2, 3])
        return conv2d_gradfix.conv2d(x, w.to(x.dtype), stride=down, groups=groups)

    x = upfirdn2d(x, f if up > 1 else None, up=up,
                  padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    # passed only for a slice: a whole conv calls as it did
    whole = {} if out_channels is None else {"out_channels": out_channels}
    x = conv2d(x, w, padding=0, groups=groups, flip_weight=flip_weight, **whole)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
