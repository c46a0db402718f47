"""int8 against bf16 matrix rate, many products per launch.

The counterpart of ``scripts/bench_int8_matmul.py``: ``K`` independent
products ``[O, I] @ [I, L]`` per call, at the script's four shapes. Columns:
the hand-written kernel with ``b`` as the script has it (``[K, I, L]``, L
contiguous; its bytes are transposed on the way to the tensor cores), the
same kernel with ``b`` already as ``[K, L, I]`` (what the int8 conv's
quantizer writes; the difference is what that layout buys), and two library
lines: ``torch._int_mm`` per k (cuBLASLt int8, where this torch has it for
the shape) and the bf16 ``torch.matmul`` of the same integers.

    python -m afcm_tpu_torch.probes.int8_matmul [--device cpu] [--small]
"""

from __future__ import annotations

import torch

from ..ops.cuda import probe_int8 as p8
from ..utils.profiling import time_windows
from . import (HBM_BYTES_PER_S, INT8_OP_PER_S, banner, device_generator, free,
               probe_args, randint8)

# (O, I, L, K): K products of [O, I] @ [I, L] per call
SHAPES = [(512, 512, 2816, 64), (512, 512, 11264, 16), (256, 256, 5632, 64),
          (128, 128, 22528, 64)]
SMALL_SHAPES = [(128, 64, 256, 3), (16, 32, 24, 2)]
WINDOWS = 5


def library_int_mm(a, b):
    """``torch._int_mm(a, b[k])`` for every k, or None where this torch or
    device has no such product for the shape."""
    if not hasattr(torch, "_int_mm") or a.device.type != "cuda":
        return None
    try:
        torch._int_mm(a, b[0])
    except RuntimeError:
        return None
    return lambda: [torch._int_mm(a, b[k]) for k in range(b.shape[0])]


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    gen = device_generator(device, args.seed)
    on_card = device.type == "cuda"
    iters, windows = (2, 2) if args.small else (10, WINDOWS)
    print(f"int8 peak {INT8_OP_PER_S / 1e12:.0f} TOP/s, HBM {HBM_BYTES_PER_S / 1e9:.0f} GB/s; "
          f"TOP/s = 2 * O * I * L * K / time; ms: median of {windows} windows of {iters} "
          "calls [fastest, slowest]", flush=True)
    rows = []
    for o, i, l, k in (SMALL_SHAPES if args.small else SHAPES):
        if on_card and (o % 128 or l % 128 or i % 64):
            print(f"[{o},{i}]@[{i},{l}] x{k}: not a shape the kernel takes, skipped on the card")
            continue
        a = randint8((o, i), device, gen)
        b = randint8((k, i, l), device, gen)
        bt = b.transpose(1, 2).contiguous()
        ops = 2 * o * i * l * k
        moved = a.numel() + b.numel() + 4 * k * o * l
        row = dict(o=o, i=i, l=l, k=k, ops=ops, bytes=moved,
                   bound_ms=max(1e3 * ops / INT8_OP_PER_S, 1e3 * moved / HBM_BYTES_PER_S),
                   bound_by="operations" if ops / INT8_OP_PER_S >= moved / HBM_BYTES_PER_S
                   else "bytes")
        abf, bbf = a.to(torch.bfloat16), b.to(torch.bfloat16)
        calls = {"kernel": lambda: p8.stacked_matmul_int8(a, b),
                 "kernel_kli": lambda: p8.stacked_matmul_int8(a, bt, "kli"),
                 "bf16": lambda: torch.matmul(abf[None], bbf)}
        int_mm = library_int_mm(a, b)
        if int_mm is not None:
            calls["int_mm"] = int_mm
        t = time_windows(calls, device, windows, iters)
        del abf, bbf
        for key in ("kernel", "kernel_kli", "int_mm", "bf16"):
            r = t.get(key)
            row[f"{key}_ms"] = None if r is None else r["ms"]
            row[f"{key}_ms_spread"] = None if r is None else [r["lo"], r["hi"]]
            row[f"{key}_tops"] = None if r is None else ops / r["ms"] / 1e9
        def cell(key, unit="TOP/s"):
            if row[f"{key}_ms"] is None:
                return "n/a"
            lo, hi = row[f"{key}_ms_spread"]
            return (f"{row[f'{key}_ms']:.4f} ms [{lo:.4f}, {hi:.4f}] "
                    f"{row[f'{key}_tops']:6.1f} {unit}")
        print(f"[{o:4d},{i:4d}]@[{i:4d},{l:6d}] x{k:3d}  bf16 {cell('bf16', 'TF/s')} | "
              f"_int_mm {cell('int_mm')} | kernel {cell('kernel')} | "
              f"kernel [K,L,I] {cell('kernel_kli')} | "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        rows.append(row)
        del a, b, bt
        free(device)
    return rows


if __name__ == "__main__":
    main()
