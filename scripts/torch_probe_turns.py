"""Time the window and int8 probe kernels (K7, K8, K9) and the int8 conv's
quantizer kernels (K3q) of this tree against those of other trees, in turns
in one process, at the probes' and the int8 paths' full shapes.

    python scripts/torch_probe_turns.py --other DIR [DIR ...] [--kernels probes|quantizers|all]
        [--out FILE]

Each DIR is the root of another checkout of the repository, e.g. the parent
commit's ``git archive`` unpacked under an ignored directory, and is named
by its last path component. Its ``afcm_tpu_torch/csrc/probe_int8.cu``,
``probe_stream.cu`` and ``quantize_int8.cu`` are built with this tree's
nvcc flags and called through their C entry points
``afcm_taps_matmul_int8``, ``afcm_slice_sum_int8`` (K9's ``sliceonly``),
``afcm_probe_windows`` (the group and chunk from this tree's
``plan_windows``), ``afcm_quantize_activations`` and
``afcm_quantize_weights``. This tree's kernels are called through their
wrappers. Each case holds every other tree's output equal to this tree's
bit for bit (the quantizers: the packed tensor and the scales), then times
the other trees' kernels, this tree's and a library call where there is
one (K8: ``torch._int_mm`` per k; the activation quantizer:
``torch.linalg.vector_norm(x, inf, dim=(1, 2, 3))``, its amax half only,
not the same function) together by ``utils/profiling.time_windows``
(median of 5 windows of 10 calls, the calls taking turns; the spread is the
fastest and the slowest window). The quantizers are timed at batch 16, 512
channels: the CMSR path's three conv inputs in bf16 and the CoModGAN
path's three in float32, and the 512 x 512 float32 weights; each call
takes the next of enough copies of its input to exceed the 50 MB L2 twice
over (the input is read from device memory, as the bounds count it), and
the windows sleep long enough for the host to enqueue all their calls
(device time, not dispatch). Prints the card's name and power limit first
and a table; ``--out`` also writes the rows as JSON. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from afcm_tpu_torch import probes  # noqa: E402
from afcm_tpu_torch.ops.cuda import _build  # noqa: E402
from afcm_tpu_torch.ops.cuda import conv_int8 as k3  # noqa: E402
from afcm_tpu_torch.ops.cuda import probe_int8 as p8  # noqa: E402
from afcm_tpu_torch.ops.cuda import probe_stream as ps  # noqa: E402
from afcm_tpu_torch.probes import element_windows, int8_kernel, int8_matmul  # noqa: E402
from afcm_tpu_torch.utils.profiling import device_banner, time_windows  # noqa: E402

WINDOWS, ITERS = 5, 10
# The quantizers' cases: batch 16, 512 channels; (label, size, padding,
# dtype) of the activations the CMSR path quantizes (bf16) and the CoModGAN
# path's (float32).
QUANT_BATCH, QUANT_CHANNELS = 16, 512
QUANT_ACTIVATIONS = [("cmsr 36^2 p2 bf16", 36, 2, torch.bfloat16),
                     ("cmsr 52^2 p2 bf16", 52, 2, torch.bfloat16),
                     ("cmsr 38^2 p0 bf16", 38, 0, torch.bfloat16),
                     ("comodgan 10^2 p0 fp32", 10, 0, torch.float32),
                     ("comodgan 18^2 p0 fp32", 18, 0, torch.float32),
                     ("comodgan 34^2 p0 fp32", 34, 0, torch.float32)]
L2_BYTES = 50 * 2 ** 20


def build_others(roots, names=("probe_int8", "probe_stream", "quantize_int8")):
    """Each other tree's libraries ``names``, built into
    ``<root>/_build_turns`` (every nvcc started together), by the tree's
    name."""
    procs = []
    for root in roots:
        csrc = os.path.join(root, "afcm_tpu_torch", "csrc")
        os.makedirs(os.path.join(root, "_build_turns"), exist_ok=True)
        for name in names:
            so = os.path.join(root, "_build_turns", f"lib{name}.so")
            procs.append((root, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {os.path.basename(root): {} for root in roots}
    for root, name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}'s {name}.cu:\n{log}")
        libs[os.path.basename(root)][name] = ctypes.CDLL(so)
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    argtypes = {"afcm_taps_matmul_int8": [p, p, p, i, i, i, i, i, i, p, i, i, p],
                "afcm_slice_sum_int8": [p, p, i, i, i, i, i, i, p, p],
                "afcm_probe_windows": [p, p] + [i] * 12 + [f, i, i, p],
                "afcm_quantize_activations": [p] * 4 + [i] * 7 + [p],
                "afcm_quantize_weights": [p] * 3 + [i] * 5 + [p]}
    entries = {"probe_int8": ("afcm_taps_matmul_int8", "afcm_slice_sum_int8"),
               "probe_stream": ("afcm_probe_windows",),
               "quantize_int8": ("afcm_quantize_activations", "afcm_quantize_weights")}
    for tree in libs.values():
        for name, lib in tree.items():
            for entry in entries[name]:
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes[entry], ctypes.c_int
    return libs


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"the other tree's {name} failed: CUDA error {err}")


def other_taps(lib, w, x, offsets, cols, raw, out_dtype):
    """The other tree's afcm_taps_matmul_int8 (this tree's arguments)."""
    s = x.shape[0]
    i = w.shape[2]
    p = x.shape[2] if raw else x.shape[1]
    out = torch.empty((s, w.shape[1], cols), dtype=out_dtype, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    _check(lib.afcm_taps_matmul_int8(
        w.data_ptr(), x.data_ptr(), out.data_ptr(), s, w.shape[1], i, p, cols, len(offsets),
        offs, int(raw), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream), "afcm_taps_matmul_int8")
    return out


def other_slice_sum(lib, x, offsets, o, cols):
    """The other tree's afcm_slice_sum_int8 (this tree's arguments)."""
    s, i, p = x.shape
    out = torch.empty((s, o, cols), dtype=torch.bfloat16, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    _check(lib.afcm_slice_sum_int8(
        x.data_ptr(), out.data_ptr(), s, o, i, p, cols, len(offsets), offs,
        torch.cuda.current_stream().cuda_stream), "afcm_slice_sum_int8")
    return out


def other_windows(lib, x, call):
    """The other tree's afcm_probe_windows (this tree's plan)."""
    c, h, w = x.shape
    out = torch.empty((call["n_th"], call["n_tw"], c, call["win_h"], call["win_w"]),
                      dtype=x.dtype, device=x.device)
    plan = ps.plan_windows(c, call["win_h"], call["win_w"])
    _check(lib.afcm_probe_windows(
        x.data_ptr(), out.data_ptr(), c, h, w, c, call["win_h"], call["win_w"], call["n_th"],
        call["n_tw"], call["stride_h"], call["stride_w"], call["lo_h"], call["lo_w"], 2.0,
        *plan, torch.cuda.current_stream().cuda_stream), "afcm_probe_windows")
    return out


def other_activations(lib, x, p):
    """The other tree's afcm_quantize_activations: (packed x, x_scale). Its
    scratch holds 3n + 1 words (the parent's kernels use the first n)."""
    n, i, h, w = x.shape
    ip = -(-i // 32) * 32
    out = torch.empty((n, h + 2 * p, w + 2 * p, ip), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((3 * n + 1,), dtype=torch.int32, device=x.device)
    _check(lib.afcm_quantize_activations(
        x.data_ptr(), scratch.data_ptr(), x_scale.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), n, i, ip, h, w, p,
        torch.cuda.current_stream().cuda_stream), "afcm_quantize_activations")
    return out, x_scale


def other_weights(lib, w):
    """The other tree's afcm_quantize_weights: (packed w, w_scale)."""
    o, i = w.shape[:2]
    op, ip = -(-o // 128) * 128, -(-i // 32) * 32
    out = torch.empty((op // 64, ip // 32, 9, 2, 64, 16), dtype=torch.int8, device=w.device)
    w_scale = torch.empty((o,), dtype=torch.float32, device=w.device)
    _check(lib.afcm_quantize_weights(
        w.data_ptr(), w_scale.data_ptr(), out.data_ptr(), int(w.dtype == torch.bfloat16),
        o, op, i, ip, torch.cuda.current_stream().cuda_stream), "afcm_quantize_weights")
    return out, w_scale


def rotating(fn, copies):
    """fn(copy) over the copies in turn, one a call."""
    turn = itertools.cycle(copies)
    return lambda: fn(next(turn))


def unequal(a, b):
    if isinstance(a, tuple):
        counts = [unequal(x, y) for x, y in zip(a, b)]
        return -1 if -1 in counts or len(a) != len(b) else sum(counts)
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def measure(rows, kernel, case, bound_ms, bound_by, calls, device, **extra):
    """Holds every tree's output equal to 'this', times every call in turns."""
    got = {name: fn() for name, fn in calls.items() if name != "library"}
    torch.cuda.synchronize()
    diff = {name: unequal(out, got["this"]) for name, out in got.items() if name != "this"}
    del got
    t = time_windows(calls, device, WINDOWS, ITERS)
    row = dict(kernel=kernel, case=case, bound_ms=bound_ms, bound_by=bound_by,
               unequal_elements=diff, **extra)
    for name, r in t.items():
        row[f"{name}_ms"], row[f"{name}_ms_spread"] = r["ms"], [r["lo"], r["hi"]]
    rows.append(row)
    times = " | ".join(f"{name} {r['ms']:.4f} [{r['lo']:.4f}, {r['hi']:.4f}]"
                       for name, r in t.items())
    more = "".join(f" | {k} {v:.4f}" for k, v in extra.items())
    print(f"{kernel:4s} {case:34s} {times} | bound {bound_ms:.4f} ({bound_by}){more} | "
          f"unequal {diff}", flush=True)
    torch.cuda.empty_cache()


def time_probes(rows, others, device, gen):
    """K7, K8 and K9 at the probes' full shapes."""
    hbm, peak = probes.HBM_BYTES_PER_S, probes.INT8_OP_PER_S
    # K7 at K1's windows, variants A-D
    for label, planes, in_size, _, (_, win, stride, lo, tiles) in \
            element_windows.variant_geometry(small=False):
        xv = torch.randn((planes, in_size, in_size), generator=gen, device=device)
        call = dict(win_w=win, n_tw=tiles, stride_w=stride, lo_w=lo, win_h=win, n_th=tiles,
                    stride_h=stride, lo_h=lo)
        moved = xv.numel() * 4 + tiles * tiles * planes * win * win * 4
        calls = {name: functools.partial(other_windows, tree["probe_stream"], xv, call)
                 for name, tree in others.items()}
        calls["this"] = lambda: ps.element_windows(xv, **call)
        measure(rows, "K7", label, 1e3 * moved / hbm, "bytes", calls, device)
        del xv

    # K8 at bench_int8_matmul's first shape, b as [K, I, L] and [K, L, I]
    o, i, l, k = int8_matmul.SHAPES[0]
    a, b = probes.randint8((o, i), device, gen), probes.randint8((k, i, l), device, gen)
    ops, moved = 2 * o * i * l * k, a.numel() + b.numel() + 4 * k * o * l
    bound = (max(1e3 * ops / peak, 1e3 * moved / hbm),
             "operations" if ops / peak >= moved / hbm else "bytes")
    int_mm = int8_matmul.library_int_mm(a, b)
    for layout in ("kil", "kli"):
        bb = b if layout == "kil" else b.transpose(1, 2).contiguous()
        calls = {name: functools.partial(other_taps, tree["probe_int8"], a[None], bb, [0], l,
                                         layout == "kil", torch.int32)
                 for name, tree in others.items()}
        calls["this"] = functools.partial(p8.stacked_matmul_int8, a, bb, layout)
        if int_mm is not None:
            calls["library"] = int_mm
        measure(rows, "K8", f"[{o},{i}]@[{k},{i},{l}] b {layout}", *bound, calls, device)
        del bb
    del a, b

    # K9 at diag_int8_kernel's shape, every mode
    O, I, COLS, WP, STEPS = (int8_kernel.O, int8_kernel.I, int8_kernel.COLS, int8_kernel.WP,
                             int8_kernel.STEPS)
    w9 = probes.randint8((9, O, I), device, gen)
    x = probes.randint8((STEPS, I, int8_kernel.window(COLS, WP)), device, gen)
    for mode in p8.MODES:
        offsets = p8.tap_offsets(mode, WP)
        ops = 2 * O * I * COLS * len(offsets) * STEPS
        reach = max(offsets) + COLS - min(offsets)   # the bytes of an x row the mode reads
        moved = (len(offsets) if mode != "sliceonly" else 0) * O * I + STEPS * I * reach \
            + 2 * STEPS * O * COLS
        by_ops = 0.0 if mode == "sliceonly" else 1e3 * ops / peak
        bound = (max(by_ops, 1e3 * moved / hbm), "operations" if by_ops >= 1e3 * moved / hbm
                 else "bytes")
        if mode == "sliceonly":   # slice_sum_kernel of each tree
            calls = {name: functools.partial(other_slice_sum, tree["probe_int8"], x, offsets,
                                             O, COLS) for name, tree in others.items()}
        else:
            calls = {name: functools.partial(other_taps, tree["probe_int8"], w9, x, offsets,
                                             COLS, True, torch.bfloat16)
                     for name, tree in others.items()}
        calls["this"] = functools.partial(p8.nine_tap_int8, w9, x, mode, COLS, WP)
        measure(rows, "K9", f"mode {mode}", *bound, calls, device)


def time_quantizers(rows, others, device, gen):
    """The activation quantizer at the six routed inputs and the weight
    quantizer at 512 x 512, each call on the next of its input's copies.
    Bounds: x (w) read once, the packed tensor and the scales written once;
    for the activations also x read twice (its maximum, then the
    quantizing pass)."""
    hbm = probes.HBM_BYTES_PER_S
    n, c = QUANT_BATCH, QUANT_CHANNELS
    for label, h, p, dtype in QUANT_ACTIVATIONS:
        x = torch.randn((n, c, h, h), generator=gen, device=device).to(dtype)
        x_bytes = x.numel() * x.element_size()
        copies = [x] + [x.clone() for _ in range(-(-2 * L2_BYTES // x_bytes))]
        out_bytes = n * (h + 2 * p) ** 2 * -(-c // 32) * 32 + 4 * n
        calls = {name: rotating(lambda t, lib=tree["quantize_int8"]:
                                other_activations(lib, t, p), copies)
                 for name, tree in others.items()}
        calls["this"] = rotating(lambda t: k3.quantize_pack_activations_cuda(t, p), copies)
        calls["library"] = rotating(
            lambda t: torch.linalg.vector_norm(t, float("inf"), dim=(1, 2, 3)), copies)
        measure(rows, "K3qx", label, 1e3 * (x_bytes + out_bytes) / hbm, "bytes", calls,
                device, two_read_bound_ms=1e3 * (2 * x_bytes + out_bytes) / hbm)
        del x, copies
    w = torch.randn((c, c, 3, 3), generator=gen, device=device) / 68
    copies = [w] + [w.clone() for _ in range(-(-2 * L2_BYTES // (w.numel() * 4)))]
    out_bytes = -(-c // 128) * 128 * -(-c // 32) * 32 * 9 + 4 * c
    calls = {name: rotating(lambda t, lib=tree["quantize_int8"]: other_weights(lib, t), copies)
             for name, tree in others.items()}
    calls["this"] = rotating(k3.quantize_pack_weights_cuda, copies)
    measure(rows, "K3qw", f"[{c},{c},3,3] fp32", 1e3 * (w.numel() * 4 + out_bytes) / hbm,
            "bytes", calls, device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--other", required=True, nargs="+",
                        help="roots of the other checkouts (distinct last components)")
    parser.add_argument("--kernels", choices=("probes", "quantizers", "all"), default="all",
                        help="which kernels to time (default all)")
    parser.add_argument("--out", default=None, help="write the rows here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda")
    print(device_banner(device), flush=True)
    roots = [os.path.abspath(r) for r in args.other]
    if len({os.path.basename(r) for r in roots} | {"this", "library"}) != len(roots) + 2:
        raise SystemExit("the other trees need distinct names, neither 'this' nor 'library'")
    names = {"probes": ("probe_int8", "probe_stream"), "quantizers": ("quantize_int8",),
             "all": ("probe_int8", "probe_stream", "quantize_int8")}[args.kernels]
    others = build_others(roots, names)
    gen = probes.device_generator(device, 0)
    rows = []
    if args.kernels in ("probes", "all"):
        time_probes(rows, others, device, gen)
    if args.kernels in ("quantizers", "all"):
        time_quantizers(rows, others, device, gen)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": device_banner(device), "others": roots, "rows": rows}, fh,
                      indent=1)
    bad = [r for r in rows if any(r["unequal_elements"].values())]
    if bad:
        raise SystemExit(f"outputs differ between the trees: {[r['case'] for r in bad]}")
    return rows


if __name__ == "__main__":
    main()
