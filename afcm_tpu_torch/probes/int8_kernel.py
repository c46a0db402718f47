"""Isolate what holds the int8 conv kernel: aligned products against shifted
tap slices, at one conv step's geometry ([512, 384] @ [384, 1920], nine taps).

The counterpart of ``scripts/diag_int8_kernel.py``, its four modes through
one hand-written kernel: ``dot1`` (a single product), ``aligned`` (nine
products at offset 0), ``slices`` (nine products at the taps' offsets
``dy * 160 + dx``, 1 or 2 bytes off the 4-byte grid of the fragment loads)
and ``sliceonly`` (the nine shifted slices summed, no product). ``aligned``
against ``slices`` says what the unaligned tap loads cost; ``sliceonly``
what the slicing costs alone. The four modes are timed together in
``WINDOWS`` windows, taking turns; a line gives the median and the fastest
and slowest window.

    python -m afcm_tpu_torch.probes.int8_kernel [--device cpu] [--small]
"""

from __future__ import annotations

from ..ops.cuda import probe_int8 as p8
from ..utils.profiling import time_windows
from . import INT8_OP_PER_S, banner, device_generator, probe_args, randint8

O, I, COLS, WP, STEPS = 512, 384, 1920, 160, 208
SMALL = dict(o=128, i=64, cols=128, wp=8, steps=2)
WINDOWS = 5


def window(cols: int, wp: int) -> int:
    """Columns of x a step needs, rounded up to 128
    (``diag_int8_kernel.py:34-35``)."""
    return -(-(cols + 2 * wp + 2) // 128) * 128


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    gen = device_generator(device, args.seed)
    o, i, cols, wp, steps = (SMALL[k] for k in ("o", "i", "cols", "wp", "steps")) \
        if args.small else (O, I, COLS, WP, STEPS)
    w9 = randint8((9, o, i), device, gen)
    x = randint8((steps, i, window(cols, wp)), device, gen)
    ops9 = 2 * o * i * cols * 9 * steps
    print(f"w9 {list(w9.shape)}, x {list(x.shape)} int8 -> bf16 [{steps}, {o}, {cols}]; "
          f"int8 peak {INT8_OP_PER_S / 1e12:.0f} TOP/s; ms: median of windows "
          "[fastest, slowest]", flush=True)
    iters, windows = (2, 2) if args.small else (10, WINDOWS)
    t = time_windows({mode: lambda mode=mode: p8.nine_tap_int8(w9, x, mode, cols, wp)
                      for mode in p8.MODES}, device, windows, iters)
    rows = []
    for mode in p8.MODES:
        ms, lo, hi = t[mode]["ms"], t[mode]["lo"], t[mode]["hi"]
        ops = ops9 // (9 if mode == "dot1" else 1)
        rows.append(dict(mode=mode, ms=ms, ms_spread=[lo, hi], ops=ops, tops=ops / ms / 1e9))
        print(f"{mode:9s}: {ms:7.4f} ms [{lo:.4f}, {hi:.4f}]  "
              f"({ops / ms / 1e9:6.1f} TOP/s equivalent)"
              + ("  [no products: the slices and their sum alone]"
                 if mode == "sliceonly" else ""), flush=True)
    return rows


if __name__ == "__main__":
    main()
