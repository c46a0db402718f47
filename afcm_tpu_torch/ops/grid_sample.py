"""2-D bilinear grid sampling, differentiable to every order
(``afcm_tpu/ops/grid_sample.py``).

The reference patches ``torch.nn.functional.grid_sample`` to allow
2nd-order gradients (``grid_sample_gradfix``, reference:
models/networks/stylegan3/torch_utils/ops/grid_sample_gradfix.py:28-40),
needed under the R1 penalty when an augmentation pipe warps D's inputs.
``F.grid_sample``'s backward has no backward of its own, so this sampler is
built from ``torch.gather`` and arithmetic, whose derivatives of every order
exist, w.r.t. the input and the grid. Semantics are those of
``mode='bilinear'``, ``padding_mode='zeros'``, ``align_corners=False``:

- ``input``  [N, C, H, W]
- ``grid``   [N, H_out, W_out, 2], normalized (x, y) in [-1, 1]
- pixel-center mapping ``p = ((g + 1) * size - 1) / 2``
- out-of-bounds taps contribute zero.
"""

from __future__ import annotations

import torch


def grid_sample(input, grid):
    """Bilinear zero-padded grid sample, torch-compatible (see module doc)."""
    assert input.dim() == 4, f"input must be [N,C,H,W], got {tuple(input.shape)}"
    assert grid.dim() == 4 and grid.shape[-1] == 2, \
        f"grid must be [N,Ho,Wo,2], got {tuple(grid.shape)}"
    n, c, h, w = input.shape
    out_hw = grid.shape[1:3]

    # Normalized -> (float) pixel coordinates; align_corners=False. The
    # bilinear weights are cast to the input's dtype, which the output keeps.
    x = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5          # [N, Ho, Wo]
    y = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0

    flat = input.reshape(n, c, h * w)
    out = 0.0
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            ix = x0 + dx
            iy = y0 + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            index = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            tap = torch.gather(flat, 2, index.reshape(n, 1, -1).expand(n, c, -1))
            weight = (wx * wy).to(input.dtype) * valid.to(input.dtype)
            out = out + tap.reshape(n, c, *out_hw) * weight[:, None]
    return out
