"""Diagnose the hand-written copy rate: bytes per CTA, row-structured against
flat addressing, and the library's rate at the same shapes.

The counterpart of ``scripts/probe_stream_diag.py``. Three questions about
the copy rate on this card:
  1. work per CTA: ``cb`` planes (or ``br`` rows) per CTA. copy3d and copy2d
     keep one CTA per block, and one SM moves a small share of the card's
     rate, so the last blocks of a copy run on too few SMs to fill the
     card: the larger the block, the longer that tail (the probe's blocks
     of 0.6-8.4 MB of x against ``BRS_SHORT``'s 64 KB and 256 KB);
  2. odd widths: rows of 276 bf16 are 552 bytes, so a row-by-row copy needs
     2-byte accesses before and after the 16-byte body of every other row,
     while the flat [rows, 512] view of the same bytes is aligned
     throughout. The bulk copy moves a block as one span of bytes, so a
     block of 276-wide planes has one head and one tail under 16 bytes at
     most, and W 276 costs what W 256 costs per byte;
  3. the ceiling itself: the flat copy (a persistent grid whose CTAs claim
     pieces of the span, and beside it the same grid with a fixed share per
     CTA), ``Tensor.copy_`` into a preallocated y (the library's copy: the
     same function, y = x) and ``x * 1.0009765625`` (the library's
     elementwise kernel: the same logical traffic, but y != x).

Each shape's calls are timed together by CUDA events in ``WINDOWS`` windows,
taking turns; a line gives the median and the fastest and slowest window.

    python -m afcm_tpu_torch.probes.stream_diag [--device cpu] [--small]
"""

from __future__ import annotations

import torch

from ..ops.cuda import probe_stream as ps
from ..utils.profiling import time_windows
from . import HBM_BYTES_PER_S, banner, device_generator, free, probe_args, randn_bf16

SHAPES = [("C@276", 8192, 276, 276), ("C@256", 8192, 256, 256)]
CBS = (4, 8, 16)
FLAT_COLS, BRS = 512, (2048, 4096, 8192)
BRS_SHORT = (64, 256)       # blocks of 64 KB and 256 KB of x (question 1)
WINDOWS = 5
# Other rings of the bulk copy (stages, bytes a stage), timed at copy2d
# br=4096 in turns with the default (ps.BLOCK_RING) and Tensor.copy_ (shape
# "ring"): three CTAs an SM with 4 x 16 KB, two with 3 x 32 KB, one with
# the rest, fewer bytes in flight with fewer stages.
RINGS = ((4, 16384), (3, 32768), (4, 32768), (7, 32768), (2, 65536), (3, 65536))
SMALL = dict(shapes=[("C@20", 16, 6, 20), ("C@16", 16, 8, 16)], cbs=(4, 8, 16),
             flat_cols=64, brs=(3, 5, 15), brs_short=(1,), rings=((2, 16), (4, 32)))


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    gen = device_generator(device, args.seed)
    shapes, cbs, cols, brs, brs_short, rings = (
        (SMALL["shapes"], SMALL["cbs"], SMALL["flat_cols"], SMALL["brs"], SMALL["brs_short"],
         SMALL["rings"])
        if args.small else (SHAPES, CBS, FLAT_COLS, BRS, BRS_SHORT, RINGS))
    iters, windows = (2, 2) if args.small else (10, WINDOWS)
    print(f"dtype bfloat16; HBM peak {HBM_BYTES_PER_S / 1e9:.0f} GB/s; GB/s of logical "
          f"bytes (read + written); ms: median of {windows} windows of {iters} calls "
          "[fastest, slowest]", flush=True)
    rows = []
    one = torch.tensor(1.0009765625, dtype=torch.bfloat16, device=device)

    def measure(shape, x, cases):
        """cases: (kernel, block, fn, bytes per CTA or None), timed in turns."""
        nb = 2 * x.numel() * 2
        t = time_windows({(k, b): fn for k, b, fn, _ in cases}, device, windows, iters)
        for kernel, block, _, cta_bytes in cases:
            r = t[(kernel, block)]
            rows.append(dict(shape=shape, kernel=kernel, block=block, bytes=nb, ms=r["ms"],
                             ms_lo=r["lo"], ms_hi=r["hi"], gbps=nb / r["ms"] / 1e6))
            note = "" if cta_bytes is None else f", {cta_bytes / 1e6:.2f} MB per CTA"
            print(f"{shape:6s} {kernel:14s} {block:18s} {nb / r['ms'] / 1e6:7.0f} GB/s "
                  f"({r['ms']:.4f} ms [{r['lo']:.4f}, {r['hi']:.4f}]{note})", flush=True)

    # the flat copy's pieces claimed in turn (stream_copy) against a fixed
    # share per CTA of the same persistent grid
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if torch.device(device).type == "cuda" else 132
    for name, c, h, w in shapes:
        x = randn_bf16((c, h, w), device, gen)
        y = torch.empty_like(x)
        share = -(-2 * x.numel() // sms // 16) * 16
        measure(name, x, [("library-mult", "", lambda: x * one, None),
                          ("library-copy_", "", lambda: y.copy_(x), None),
                          ("stream-copy", "flat", lambda: ps.stream_copy(x), None),
                          ("stream-copy", "flat, shares", lambda: ps.bulk_copy(
                              x, share, ps.FLAT_RING), 2 * share)]
                + [("copy3d", f"cb={cb}", lambda cb=cb: ps.copy3d(x, cb), 2 * cb * h * w * 2)
                   for cb in cbs])
        del x, y
        free(device)

    # The aligned flat stream: the byte count of the first shape, no odd rows
    # (1,218,816 rows of 512 at full size; the last CTA takes a partial block).
    _, c, h, w = shapes[0]
    x = randn_bf16((c * h * w // cols, cols), device, gen)
    y = torch.empty_like(x)
    measure("flat", x, [("library-mult", "", lambda: x * one, None),
                        ("library-copy_", "", lambda: y.copy_(x), None)]
            + [("copy2d", f"br={br}", lambda br=br: ps.copy2d(x, br), 2 * br * cols * 2)
               for br in brs + brs_short])
    br = brs[len(brs) // 2]
    measure("ring", x, [("library-copy_", "", lambda: y.copy_(x), None)]
            + [("copy2d", f"br={br} {n}x{b}B",
                lambda n=n, b=b: ps.bulk_copy(x, br * cols * 2, (n, b), "copy2d"),
                2 * br * cols * 2) for n, b in (ps.BLOCK_RING,) + rings])
    del x, y
    free(device)
    return rows


if __name__ == "__main__":
    main()
