"""Stream probe at the FIR layers' shapes: what hand-written loads and stores
reach on the card, beside the fused filtered_lrelu kernel.

The counterpart of ``scripts/probe_fir_roofline.py``. At each up2/down2 FIR
layer shape of the generator (batch 16 folded into the channel count), with
no tap math:

  copy  : y = x                        (read 1x, write 1x)
  wr4x  : four scaled stores of x      (read 1x, write 4x): the up-FIR's writes
  rd4x  : pairwise sum of four planes  (read 4x, write 1x): the down-FIR's reads
  chain : x -> 4x intermediate in shared memory -> lrelu -> sum -> y
          (read 1x, write 1x): the fused chain's least device-memory traffic;
          once with 32 KB of shared memory per CTA (seven CTAs per SM) and
          once with the 224 KB one CTA can have (`chainX`)

and beside them ``Tensor.copy_`` (the library's copy), ``x.unsqueeze(1) *
s`` (one broadcasting multiply: wr4x as a library call) and ``x4.sum(1)``
(rd4x's sum as one reduction, which rounds once from float32 where rd4x
rounds each pairwise add, so its largest difference in bf16 units of
the largest addend is printed beside it); copy, wr4x and rd4x are timed with these in turns,
median of ``WINDOWS`` windows. At the same shape,
the fused ``filtered_lrelu`` kernel (separable 12-tap up2 -> lrelu -> down2)
and its plain composition with the same least-traffic accounting (x read, y
written): how far the real kernel is from the stream rate of its own
traffic.

Every operand is at least four times the card's 50 MB L2 (the channel count
is replicated ``rep`` times for that), so the rates are device memory's.
GB/s are of logical bytes (read + written).

    python -m afcm_tpu_torch.probes.fir_roofline [--device cpu] [--small]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import design_lowpass_filter, filtered_lrelu
from ..ops.cuda import filtered_lrelu as k1
from ..ops.cuda import probe_stream as ps
from ..utils.profiling import time_ms, time_windows
from . import (HBM_BYTES_PER_S, L2_BYTES, banner, device_generator, free,
               probe_args, randn_bf16)

# (name, channels, H, W, rep): the up2/down2 FIR layers at batch 16, the
# batch folded into the channel count, times rep so that x is >= 4x the L2.
SHAPES = [
    ("C128@276", 128, 276, 276, 1),
    ("C256@148", 256, 148, 148, 2),
    ("C512@84", 512, 84, 84, 2),
    ("C512@52", 512, 52, 52, 5),
    ("C128@256", 128, 256, 256, 1),     # power-of-two control
]
SMALL_SHAPES = [("C2@20x12", 2, 12, 20, 1), ("C1@7x9", 1, 7, 9, 1)]
BATCH = 16
WINDOWS = 5


def fir_case(h: int):
    """The separable 12-tap up2 / down2 filters and padding the probe times
    the fused kernel with (``scripts/probe_fir_roofline.py:166-180``)."""
    f = design_lowpass_filter(12, cutoff=h / 4, width=h / 2, fs=h * 2)
    return dict(fu=f, fd=f, up=2, down=2, padding=(9, 8, 9, 8),
                gain=float(np.sqrt(2)), slope=0.2, clamp=256.0)


def library_wr4x(x):
    """K5b's function as one library call: a broadcasting multiply by
    (1, 1/2, 1/4, 1/8), exact in bf16 and so bit-equal to the plain
    version."""
    s = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=x.dtype, device=x.device)
    return x.unsqueeze(1) * s.view(1, 4, 1, 1)


def library_rd4x(x4):
    """K5c's sum as one library call: a reduction over the four planes,
    accumulated in float32 and rounded to bf16 once (rd4x rounds each of its
    three adds), so not bit-equal to the plain version."""
    return x4.sum(1)


def rd4x_units(a, b, x4) -> float:
    """The largest difference of two sums of x4's four planes (``[C, H,
    W]``), each element in bf16 units of the last place of its largest
    addend (2^(e - 8) for |addend| = m * 2^e, 0.5 <= m < 1): the scale of
    one rounding, where units of the sum itself blow up as the addends
    cancel."""
    _, e = torch.frexp(x4.float().abs().amax(1))
    unit = torch.ldexp(torch.ones(e.shape, device=e.device), e - 8)
    return float(((a.float() - b.float()).abs() / unit).max())


def measure(name, c0, h, w, rep, device, gen, batch=BATCH, iters=10, windows=WINDOWS):
    c = batch * c0 * rep
    x = randn_bf16((c, h, w), device, gen)
    nb = x.numel() * 2
    row = dict(shape=name, planes=c, h=h, w=w, rep=rep, x_mbytes=nb / 1e6,
               l2_multiple=nb / L2_BYTES)
    # the copy and wr4x beside the library call that computes the same
    # function, in turns: median and spread over the windows
    y = torch.empty_like(x)
    t = time_windows({"copy": lambda: ps.stream_copy(x), "library_copy": lambda: y.copy_(x),
                      "wr4x": lambda: ps.stream_wr4x(x),
                      "library_wr4x": lambda: library_wr4x(x)},
                     device, windows, iters)
    for key, r in t.items():
        row[f"{key}_ms"], row[f"{key}_ms_spread"] = r["ms"], [r["lo"], r["hi"]]
    del y
    row["chain_ms"] = time_ms(lambda: ps.stream_chain(x), device, iters)
    row["chain_max_tile_ms"] = time_ms(
        lambda: ps.stream_chain(x, tile=ps.CHAIN_TILE_MAX), device, iters)
    free(device)
    x4 = randn_bf16((c, 4, h, w), device, gen)
    t = time_windows({"rd4x": lambda: ps.stream_rd4x(x4),
                      "library_rd4x": lambda: library_rd4x(x4)}, device, windows, iters)
    for key, r in t.items():
        row[f"{key}_ms"], row[f"{key}_ms_spread"] = r["ms"], [r["lo"], r["hi"]]
    row["library_rd4x_units"] = rd4x_units(library_rd4x(x4), ps.stream_rd4x_plain(x4), x4)
    del x4
    free(device)
    row["bytes"] = dict(copy=2 * nb, wr4x=5 * nb, rd4x=5 * nb, chain=2 * nb)

    # the fused kernel and its plain composition at the same shape
    kw = fir_case(h)
    xb = x.reshape(batch, c // batch, h, w)
    yb = filtered_lrelu(xb, **kw)
    row["fused_bytes"] = (xb.numel() + yb.numel()) * 2
    row["fused_out"] = list(yb.shape)
    del yb
    row["fused_ms"] = time_ms(lambda: filtered_lrelu(xb, **kw), device, max(2, iters // 3))
    row["fused_plain_ms"] = time_ms(lambda: k1.filtered_lrelu_plain(xb, **kw), device,
                                    2, warmup=1)
    del x, xb
    free(device)
    return row


def gbps(nbytes, ms):
    return nbytes / ms / 1e6


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    gen = device_generator(device, args.seed)
    shapes = SMALL_SHAPES if args.small else SHAPES
    batch = 2 if args.small else BATCH
    print(f"dtype bfloat16; chain tile {ps.CHAIN_TILE} items of 16 bytes "
          f"({4 * ps.CHAIN_TILE * 16 // 1024} KB shared per CTA); "
          f"HBM peak {HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    print(f"{'shape':10s} {'rep':>3s} {'x MB':>7s} | {'copy':>6s} {'wr4x':>6s} {'rd4x':>6s} "
          f"{'chain':>6s} {'chainX':>6s} {'copy_':>6s} {'x*s':>6s} | {'fused ms':>9s} {'GB/s':>6s} {'plain ms':>9s} "
          f"{'GB/s':>6s}", flush=True)
    rows = []
    for name, c0, h, w, rep in shapes:
        row = measure(name, c0, h, w, rep, device, gen, batch=batch,
                      iters=2 if args.small else 10, windows=2 if args.small else WINDOWS)
        nb = row["bytes"]
        for key in ("copy", "wr4x", "rd4x", "chain"):
            row[f"{key}_gbps"] = gbps(nb[key], row[f"{key}_ms"])
        row["chain_max_tile_gbps"] = gbps(nb["chain"], row["chain_max_tile_ms"])
        row["library_copy_gbps"] = gbps(nb["copy"], row["library_copy_ms"])
        row["library_wr4x_gbps"] = gbps(nb["wr4x"], row["library_wr4x_ms"])
        row["library_rd4x_gbps"] = gbps(nb["rd4x"], row["library_rd4x_ms"])
        row["fused_gbps"] = gbps(row["fused_bytes"], row["fused_ms"])
        row["fused_plain_gbps"] = gbps(row["fused_bytes"], row["fused_plain_ms"])
        print(f"{name:10s} {rep:3d} {row['x_mbytes']:7.1f} | {row['copy_gbps']:6.0f} "
              f"{row['wr4x_gbps']:6.0f} {row['rd4x_gbps']:6.0f} {row['chain_gbps']:6.0f} "
              f"{row['chain_max_tile_gbps']:6.0f} {row['library_copy_gbps']:6.0f} "
              f"{row['library_wr4x_gbps']:6.0f} | {row['fused_ms']:9.3f} "
              f"{row['fused_gbps']:6.0f} {row['fused_plain_ms']:9.3f} "
              f"{row['fused_plain_gbps']:6.0f}", flush=True)
        print("           ms [fastest, slowest window]: " + "; ".join(
            f"{key} {row[f'{key}_ms']:.4f} [{row[f'{key}_ms_spread'][0]:.4f}, "
            f"{row[f'{key}_ms_spread'][1]:.4f}]"
            for key in ("copy", "library_copy", "wr4x", "library_wr4x", "rd4x",
                        "library_rd4x"))
              + f"; x4.sum(1) {row['library_rd4x_gbps']:.0f} GB/s, at most "
              f"{row['library_rd4x_units']:g} bf16 units (of the largest addend) from "
              "rd4x's plain version", flush=True)
        rows.append(row)
    print("\nGB/s of logical bytes (read + written). copy/wr4x/rd4x/chain: the "
          "hand-written stream kernels, no tap math; copy_: Tensor.copy_; x*s: "
          "x.unsqueeze(1) * s, wr4x's function in one library call; x4.sum(1): rd4x's "
          "sum in one library call, rounded once.\nchain "
          f"(chainX: with {4 * ps.CHAIN_TILE_MAX * 16 // 1024} KB shared per CTA) "
          "bounds a fused up -> act -> down kernel's device-memory rate; fused: the "
          "filtered_lrelu kernel at the same shape, x read + y written;\nplain: its "
          "plain PyTorch composition under the same accounting.", flush=True)
    return rows


if __name__ == "__main__":
    main()
