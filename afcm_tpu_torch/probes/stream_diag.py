"""Diagnose the hand-written copy rate: bytes per CTA, row-structured against
flat addressing, and the library's elementwise rate at the same shapes.

The counterpart of ``scripts/probe_stream_diag.py``. Three questions about
the copy rate on this card:
  1. work per CTA: ``cb`` planes (or ``br`` rows) per CTA;
  2. odd widths: rows of 276 bf16 are 552 bytes, so a row-by-row copy needs
     2-byte accesses before and after the 16-byte body of every other row,
     while the flat [rows, 512] view of the same bytes is aligned throughout;
  3. the ceiling itself: the flat persistent copy and ``x * 1.0009765625``
     in torch (the library's elementwise kernel, same logical traffic).

    python -m afcm_tpu_torch.probes.stream_diag [--device cpu] [--small]
"""

from __future__ import annotations

import torch

from ..ops.cuda import probe_stream as ps
from ..utils.profiling import time_ms
from . import HBM_BYTES_PER_S, banner, device_generator, free, probe_args, randn_bf16

SHAPES = [("C@276", 8192, 276, 276), ("C@256", 8192, 256, 256)]
CBS = (4, 8, 16)
FLAT_COLS, BRS = 512, (2048, 4096, 8192)
SMALL = dict(shapes=[("C@20", 16, 6, 20), ("C@16", 16, 8, 16)], cbs=(4, 8, 16),
             flat_cols=64, brs=(3, 5, 15))


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    gen = device_generator(device, args.seed)
    shapes, cbs, cols, brs = (SMALL["shapes"], SMALL["cbs"], SMALL["flat_cols"],
                              SMALL["brs"]) if args.small else (SHAPES, CBS, FLAT_COLS, BRS)
    iters = 2 if args.small else 10
    print(f"dtype bfloat16; HBM peak {HBM_BYTES_PER_S / 1e9:.0f} GB/s; GB/s of logical "
          "bytes (read + written)", flush=True)
    rows = []

    def line(shape, kernel, block, nb, ms, block_mb=None):
        rows.append(dict(shape=shape, kernel=kernel, block=block, bytes=nb, ms=ms,
                         gbps=nb / ms / 1e6))
        note = "" if block_mb is None else f", {block_mb:.2f} MB per CTA"
        print(f"{shape:6s} {kernel:14s} {block:10s} {nb / ms / 1e6:7.0f} GB/s "
              f"({ms:.3f} ms{note})", flush=True)

    one = torch.tensor(1.0009765625, dtype=torch.bfloat16, device=device)
    for name, c, h, w in shapes:
        x = randn_bf16((c, h, w), device, gen)
        nb = 2 * x.numel() * 2
        line(name, "library-mult", "", nb, time_ms(lambda: x * one, device, iters))
        line(name, "stream-copy", "flat", nb, time_ms(lambda: ps.stream_copy(x), device, iters))
        for cb in cbs:
            line(name, "copy3d", f"cb={cb}", nb,
                 time_ms(lambda: ps.copy3d(x, cb), device, iters),
                 2 * cb * h * w * 2 / 1e6)
        del x
        free(device)

    # The aligned flat stream: the byte count of the first shape, no odd rows
    # (1,218,816 rows of 512 at full size; the last CTA takes a partial block).
    _, c, h, w = shapes[0]
    n_rows = c * h * w // cols
    x = randn_bf16((n_rows, cols), device, gen)
    nb = 2 * x.numel() * 2
    line("flat", "library-mult", "", nb, time_ms(lambda: x * one, device, iters))
    for br in brs:
        line("flat", "copy2d", f"br={br}", nb,
             time_ms(lambda: ps.copy2d(x, br), device, iters), 2 * br * cols * 2 / 1e6)
    del x
    free(device)
    return rows


if __name__ == "__main__":
    main()
