"""Isolate what holds the int8 conv kernel: aligned products against shifted
tap slices, at one conv step's geometry ([512, 384] @ [384, 1920], nine taps).

The counterpart of ``scripts/diag_int8_kernel.py``, its four modes through
one hand-written kernel: ``dot1`` (a single product), ``aligned`` (nine
products at offset 0), ``slices`` (nine products at the taps' offsets
``dy * 160 + dx``, 1 or 2 bytes off the 4-byte grid of the fragment loads)
and ``sliceonly`` (the nine shifted slices summed, no product). ``aligned``
against ``slices`` says what the unaligned tap loads cost; ``sliceonly``
what the slicing costs alone. The four modes are timed together in
``WINDOWS`` windows, taking turns, with ``dot1``'s product as a library
call beside them (``torch._int_mm`` per step, int32 out: the rounding to
bf16 is not in it); a line gives the median and the fastest and slowest
window.

Modes and kernels (``ops/cuda/probe_int8.py``): ``dot1``, ``aligned`` and
``slices`` run ``taps_matmul_kernel``, ``sliceonly`` runs
``slice_sum_kernel``.

    python -m afcm_tpu_torch.probes.int8_kernel [--device cpu] [--small]
"""

from __future__ import annotations

from ..ops.cuda import probe_int8 as p8
from ..utils.profiling import time_windows
from . import INT8_OP_PER_S, banner, device_generator, probe_args, randint8
from .int8_matmul import library_int_mm

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
    calls = {mode: lambda mode=mode: p8.nine_tap_int8(w9, x, mode, cols, wp)
             for mode in p8.MODES}
    int_mm = library_int_mm(w9[0], x[:, :, :cols])
    if int_mm is not None:
        calls["library_dot1"] = int_mm
    t = time_windows(calls, device, windows, iters)
    rows = []
    for mode in p8.MODES:
        ms, lo, hi = t[mode]["ms"], t[mode]["lo"], t[mode]["hi"]
        ops = ops9 // (9 if mode == "dot1" else 1)
        rows.append(dict(mode=mode, ms=ms, ms_spread=[lo, hi], ops=ops, tops=ops / ms / 1e9))
        print(f"{mode:9s}: {ms:7.4f} ms [{lo:.4f}, {hi:.4f}]  "
              f"({ops / ms / 1e9:6.1f} TOP/s equivalent)"
              + ("  [slice_sum_kernel, no products: the slices and their sum alone]"
                 if mode == "sliceonly" else "  [taps_matmul_kernel]"), flush=True)
    lib, dot1 = t.get("library_dot1"), rows[p8.MODES.index("dot1")]
    dot1["library_ms"] = None if lib is None else lib["ms"]
    dot1["library_ms_spread"] = None if lib is None else [lib["lo"], lib["hi"]]
    print("dot1 as torch._int_mm per step (int32 out): " + (
        "n/a (no _int_mm for the shape here)" if lib is None else
        f"{lib['ms']:7.4f} ms [{lib['lo']:.4f}, {lib['hi']:.4f}]"), flush=True)
    return rows


if __name__ == "__main__":
    main()
