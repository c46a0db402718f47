"""Kernels K8 and K9: the int8 matrix-rate probes, CUDA C++ for Hopper
(``csrc/probe_int8.cu``), with their plain PyTorch versions.

* K8 ``stacked_matmul_int8`` is the port of ``scripts/bench_int8_matmul.py``
  (``pallas_stacked`` ``:37`` -> ``stacked_mm_kernel`` ``:30``):
  ``o[k] = a @ b[k]`` for int8 ``a [O, I]`` and ``b [K, I, L]``, int32
  ``[K, O, L]``. ``b`` is taken as the script gives it, L contiguous, and its
  bytes are transposed on the way to the tensor cores; ``b_layout="kli"``
  takes it already as ``[K, L, I]`` (what the int8 conv's quantizer writes),
  to show what that layout buys.
* K9 ``nine_tap_int8`` is the port of ``scripts/diag_int8_kernel.py``
  (``make`` ``:38`` -> ``kernel`` ``:42``): per step ``s`` the sum over the
  taps of ``w9[tap] @ x[s, :, off : off + cols]``, int32, rounded to bf16,
  in the script's four modes: ``dot1`` (one tap), ``aligned`` (nine taps,
  offset 0), ``slices`` (``off = dy * wp + dx``) and ``sliceonly`` (the nine
  shifted slices cast to int32 and summed, rows from I to O zero, no
  product: ``slice_sum_int8``).

K8 and the three product modes run ``taps_matmul_kernel``:
``wgmma.mma_async`` m64n256k32 products from shared memory
(``csrc/wgmma_s8.cuh``, as the int8 conv has them); a loader warp brings
the weights and x by tensor-map copies, x once per K step for all taps, and
three warps transpose it in shared memory when it comes n-contiguous,
through a ring of stages on mbarriers that ``plan_taps`` sizes.
``sliceonly`` runs ``slice_sum_kernel``: persistent CTAs stage a unit of x
rows once for all taps by one bulk copy through a ring, sum the taps in
16-bit lanes of packed words and store the unit's bf16 rows by one bulk
copy, as ``plan_slice_sum`` sizes them. Integer sums have no rounding: each
kernel equals its plain version bit for bit. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``launches`` counts
the launches by kernel name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

# Launches of each kernel in this process (tests and chip_smoke.py read and
# reset them).
launches = {"stacked_matmul": 0, "nine_tap": 0, "slice_sum": 0}

MODES = ("dot1", "aligned", "slices", "sliceonly")
_M_ALIGN = 128      # O and n: AFCM_P8_BM in csrc/probe_int8.cu, half of AFCM_P8_BN
_K_ALIGN = 64       # I: two of the kernel's K steps (AFCM_P8_KC)

# csrc/probe_int8.cu's tile and limits (AFCM_P8_*)
TILE_N = 256
MAX_TAPS = 9
MAX_STAGES = 8
BOX_MAX = 256                                   # bytes (raw x) or rows (K-major) of a box
SMEM_BUDGET = 232448 - 4 * 8 * MAX_STAGES       # 227 KB less the static barriers
ALIGN = 1024                                    # the ring's start in shared memory
# slice_sum_kernel's (AFCM_SL_*)
SLICE_ZERO = 4096                               # bytes of zeros the dead rows come from
SLICE_SMEM_SM = 233472                          # shared memory of an SM
SLICE_STATIC = 2 * 8 * 4                        # its static barriers


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def tap_offsets(mode: str, wp: int):
    """Column offsets of the taps of one mode (``diag_int8_kernel.py:43-46``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    if mode == "dot1":
        return [0]
    if mode == "aligned":
        return [0] * 9
    return [dy * wp + dx for dy in range(3) for dx in range(3)]


@dataclasses.dataclass(frozen=True)
class TapsPlan:
    """How ``taps_matmul_kernel`` stages a call (``csrc/probe_int8.cu``:
    ``make_plan``, which this mirrors; ``afcm_taps_plan`` exports the C
    side's). Taps go in ``groups``, each group's taps in one step: one
    group holding every tap where a ring of two stages fits, else one per
    tap. ``tap`` lists w's taps by offset, ``off`` each one's offset from
    its group's ``base``. A step covers ``ksub`` slices of 32 bytes of K;
    a slice (``slice_bytes``) holds the group's weights (``a_bytes``) and
    ``span`` rows of x (the tile's 256 columns plus the group's spread).
    Raw x comes by tensor-map boxes (``x_tma``: ``xboxes`` of 32 ``ksub``
    rows of ``xw`` bytes) or by cp.async (one box of ``xw`` bytes a row),
    into ``raws`` buffers beside the ring's ``stages`` (as many where they
    fit, else 2);
    K-major x by
    ``xboxes`` boxes of ``xw`` rows per slice, of 32 bytes in the 32-byte
    swizzle where every offset is a multiple of 8 rows (``b_sw32``), else
    of 16 bytes per half. An int32
    output is staged for its bulk stores in ``epi_bytes``, one consumer
    warpgroup's tile at a time (a bf16 one goes out from the registers: 0);
    ``smem`` counts 1 KB for aligning the ring."""
    groups: int
    span: int
    ksub: int
    a_bytes: int
    slice_bytes: int
    stage_bytes: int
    xboxes: int
    xw: int
    x_tma: int
    b_sw32: int
    stages: int
    raws: int
    epi_bytes: int
    smem: int
    tap: tuple
    off: tuple
    base: tuple


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_taps(offsets, i: int, raw: bool, out_bytes: int, tma_ok: bool = True) -> TapsPlan:
    """The kernel's plan for tap ``offsets``, ``i`` bytes of K (a multiple
    of 64), x n-contiguous if ``raw`` (raw x may come by tensor map if
    ``tma_ok``: P a multiple of 16 and x 16-byte aligned) and an output of
    ``out_bytes`` a value (4 int32, 2 bf16)."""
    taps = len(offsets)
    if not 1 <= taps <= MAX_TAPS or min(offsets) < 0 or i < 64 or i % 64:
        raise ValueError(f"taps_matmul plan: offsets {list(offsets)}, i {i}")
    order = sorted(range(taps), key=lambda t: offsets[t])
    for per_tap in (False, True):
        for ksub in (4, 2, 1):
            if i % (32 * ksub):
                continue
            groups = [[t] for t in order] if per_tap else [order]
            base = tuple(offsets[g[0]] for g in groups)
            off = tuple(offsets[t] - b for g, b in zip(groups, base) for t in g)
            span = _round_up(TILE_N + max(off), 8)
            x_tma = int(raw and tma_ok and all(b % 16 == 0 for b in base))
            b_sw32 = int(not raw and all(o % 8 == 0 for o in off))
            if x_tma:
                xboxes = -(-span // BOX_MAX)
                xw = _round_up(-(-span // xboxes), 16)
            elif raw:
                xboxes, xw = 1, _round_up(span + 32, 16)
            else:
                xboxes = -(-span // BOX_MAX)
                xw = _round_up(-(-span // xboxes), 8)
                span = xboxes * xw
            a_bytes = 128 * 32 * max(len(g) for g in groups)
            slice_bytes = a_bytes + 2 * 16 * span
            stage_bytes = ksub * slice_bytes
            epi_bytes = 64 * (TILE_N * out_bytes + 16) if out_bytes == 4 else 0
            raw_bytes = xboxes * 32 * ksub * xw if raw else 0
            for two in (False, True) if raw else (False,):
                for stages in range(MAX_STAGES, 2 if ksub > 1 else 1, -1):
                    raws = (2 if two else stages) if raw else 0
                    smem = stages * stage_bytes + raws * raw_bytes + epi_bytes + ALIGN
                    if smem <= SMEM_BUDGET:
                        return TapsPlan(len(groups), span, ksub, a_bytes, slice_bytes,
                                        stage_bytes, xboxes, xw, x_tma, b_sw32, stages, raws,
                                        epi_bytes, smem, tuple(order), off, base)
    raise ValueError(f"taps_matmul plan: no ring fits for offsets {list(offsets)}")


def kernel_plan(offsets, i: int, raw: bool, out_bytes: int, tma_ok: bool = True) -> TapsPlan:
    """The C side's plan (``afcm_taps_plan``), to hold ``plan_taps`` to."""
    taps = len(offsets)
    info = (ctypes.c_int * (14 + 3 * taps))()
    err = _lib().afcm_taps_plan((ctypes.c_int * taps)(*offsets), taps, i, int(raw),
                                int(tma_ok), int(out_bytes == 2), info)
    if err != 0:
        raise RuntimeError(f"afcm_taps_plan: CUDA error {err}")
    head, rest = list(info[:14]), list(info[14:])
    return TapsPlan(*head, tuple(rest[:taps]), tuple(rest[taps:2 * taps]),
                    tuple(rest[2 * taps:2 * taps + head[0]]))


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """How ``slice_sum_kernel`` stages a call (``csrc/probe_int8.cu``:
    ``make_slice_plan``, which this mirrors; ``afcm_slice_sum_plan`` exports
    the C side's). A unit is ``rows`` rows of o of one step; ``ctas`` CTAs
    an SM walk the units. x comes into a ring of ``stages`` stages of
    ``in_bytes`` (a unit's rows * P bytes and 32 of slack, rounded up to
    128), out leaves through two staging buffers of ``out_bytes`` (rows *
    N * 2); ``smem`` adds the zero rows' 4 KB and 128 bytes to align."""
    rows: int
    stages: int
    ctas: int
    in_bytes: int
    out_bytes: int
    smem: int


def plan_slice_sum(o: int, i: int, p: int, n: int) -> SlicePlan:
    """The kernel's plan for out rows ``o``, x rows ``i``, x row bytes ``p``
    and ``n`` columns (multiples of 8): the most rows a unit (8, 4, 2, 1),
    then the most CTAs an SM (2, 1), then the most stages (3, 2) that fit
    the SM's shared memory, 1 KB a CTA kept for the system."""
    if o < 1 or i < 1 or n < 8 or n % 8 or p % 8 or p < n:
        raise ValueError(f"slice_sum plan: o {o}, i {i}, p {p}, n {n}")
    for rows in (8, 4, 2, 1):
        for ctas in (2, 1):
            for stages in (3, 2):
                in_bytes = _round_up(rows * p + 32, 128)
                out_bytes = rows * n * 2
                smem = stages * in_bytes + 2 * out_bytes + SLICE_ZERO + 128
                if smem + SLICE_STATIC <= min(232448, SLICE_SMEM_SM // ctas - 1024):
                    return SlicePlan(rows, stages, ctas, in_bytes, out_bytes, smem)
    raise ValueError(f"slice_sum plan: no unit of one row fits, p {p}, n {n}")


def kernel_slice_plan(o: int, i: int, p: int, n: int) -> SlicePlan:
    """The C side's plan (``afcm_slice_sum_plan``), to hold ``plan_slice_sum`` to."""
    info = (ctypes.c_int * 6)()
    err = _lib().afcm_slice_sum_plan(o, i, p, n, info)
    if err != 0:
        raise RuntimeError(f"afcm_slice_sum_plan: CUDA error {err}")
    return SlicePlan(*info)


# ---------------------------------------------------------------- plain

def _int_matmul(a, b):
    """Exact integer product of integer-valued tensors: in float64 (every
    partial sum stays below 2^53; an integer matmul does not exist on the
    card), cast to int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def stacked_matmul_int8_plain(a, b, b_layout: str = "kil"):
    if b_layout == "kli":
        b = b.transpose(1, 2)
    return _int_matmul(a[None], b)


def to_bf16(acc):
    """int32 -> float32 -> bf16, both rounded to nearest even: what a cast
    of an int32 tensor to bfloat16 does."""
    return acc.to(torch.float32).to(torch.bfloat16)


def taps_matmul_int8_plain(w, x, offsets, cols: int, raw: bool = True,
                           out_dtype=torch.int32):
    """The plain version of ``taps_matmul_int8``."""
    acc = torch.zeros((x.shape[0], w.shape[1], cols), dtype=torch.int32, device=x.device)
    for tap, off in enumerate(offsets):
        rhs = x[:, :, off:off + cols] if raw else x[:, off:off + cols].transpose(1, 2)
        acc += _int_matmul(w[tap][None], rhs)
    return acc if out_dtype == torch.int32 else to_bf16(acc)


def slice_sum_int8_plain(x, offsets, o: int, cols: int):
    """The plain version of ``slice_sum_int8``."""
    rows = min(o, x.shape[1])
    acc = torch.zeros((x.shape[0], o, cols), dtype=torch.int32, device=x.device)
    for off in offsets:
        acc[:, :rows] += x[:, :rows, off:off + cols].to(torch.int32)
    return to_bf16(acc)


def nine_tap_int8_plain(w9, x, mode: str, cols: int, wp: int):
    if mode == "sliceonly":
        return slice_sum_int8_plain(x, tap_offsets(mode, wp), w9.shape[1], cols)
    acc = torch.zeros((x.shape[0], w9.shape[1], cols), dtype=torch.int32, device=x.device)
    for tap, off in enumerate(tap_offsets(mode, wp)):
        acc += _int_matmul(w9[tap][None], x[:, :, off:off + cols])
    return to_bf16(acc)


# ---------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of ``csrc/probe_int8.cu``, built at first use."""
    from ._build import load_library
    lib = load_library("probe_int8")[0]
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.afcm_taps_matmul_int8.argtypes = [p, p, p, i, i, i, i, i, i, p, i, i, p]
    lib.afcm_slice_sum_int8.argtypes = [p, p, i, i, i, i, i, i, p, p]
    lib.afcm_taps_plan.argtypes = [p, i, i, i, i, i, p]
    lib.afcm_slice_sum_plan.argtypes = [i, i, i, i, p]
    for fn in (lib.afcm_taps_matmul_int8, lib.afcm_slice_sum_int8, lib.afcm_taps_plan,
               lib.afcm_slice_sum_plan):
        fn.restype = ctypes.c_int
    return lib


def _check_int8(name, **tensors):
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.int8
                and t.is_contiguous() and t.device == first.device):
            raise ValueError(f"{name} needs contiguous int8 tensors on one device; "
                             f"{key} is {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"contiguous={t.is_contiguous()}")


def _launch(name, fn, x, *args):
    with torch.cuda.device(x.device):       # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_int8 kernel {name} launch failed: CUDA error {err}")
    launches[name] += 1


def taps_matmul_int8(w, x, offsets, cols: int, raw: bool = True, out_dtype=torch.int32,
                     counter: str = "nine_tap"):
    """K8's and K9's product, ``taps_matmul_kernel``: for every s,

        out[s] = sum_tap w[tap] @ X_s,   X_s = x[s, :, off : off + cols]  (raw)
                                          or x[s, off : off + cols, :]^T

    exact in int32, returned as int32 or rounded to bf16 (``out_dtype``).

    Args:
      w: int8 ``[T, O, I]``, T at least ``len(offsets)`` (tap k uses w[k]).
      x: int8 ``[S, I, P]`` (``raw``, n contiguous) or ``[S, P, I]``.
      offsets: the taps' column offsets, each with ``off + cols <= P``.
    Returns ``[S, O, cols]``. On the card O and cols must be multiples of
    128, I of 64 and P of 8; anything else raises. The launch counts under
    ``counter``."""
    _check_int8("taps_matmul_int8", w=w, x=x)
    offsets = [int(o) for o in offsets]
    if out_dtype not in (torch.int32, torch.bfloat16):
        raise ValueError(f"taps_matmul_int8: out_dtype {out_dtype}; int32 or bfloat16")
    if w.ndim != 3 or x.ndim != 3:
        raise ValueError(f"taps_matmul_int8: w {tuple(w.shape)}, x {tuple(x.shape)}")
    _, o, i = w.shape
    s, xi, p = x.shape if raw else (x.shape[0], x.shape[2], x.shape[1])
    if xi != i or not 1 <= len(offsets) <= min(MAX_TAPS, w.shape[0]) or cols < 1 \
            or min(offsets) < 0 or max(offsets) + cols > p:
        raise ValueError(f"taps_matmul_int8: w {tuple(w.shape)}, x {tuple(x.shape)} "
                         f"({'raw' if raw else 'K-major'}), offsets {offsets}, cols {cols}")
    if x.device.type == "cpu":
        return taps_matmul_int8_plain(w, x, offsets, cols, raw, out_dtype)
    if o % _M_ALIGN or cols % _M_ALIGN or i % _K_ALIGN or p % 8:
        raise ValueError(f"taps_matmul_int8 on the card takes O and cols in multiples of "
                         f"{_M_ALIGN}, I of {_K_ALIGN} and P of 8, got O {o}, I {i}, "
                         f"cols {cols}, P {p}")
    out = torch.empty((s, o, cols), dtype=out_dtype, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    _launch(counter, _lib().afcm_taps_matmul_int8, x, w.data_ptr(), x.data_ptr(),
            out.data_ptr(), s, o, i, p, cols, len(offsets), offs, int(raw),
            int(out_dtype == torch.bfloat16))
    return out


def stacked_matmul_int8(a, b, b_layout: str = "kil"):
    """K8: ``o[k] = a @ b[k]``, exact in int32.

    Args:
      a: int8 ``[O, I]``.
      b: int8 ``[K, I, L]`` (``b_layout="kil"``, L contiguous, as the TPU
        script has it) or ``[K, L, I]`` (``"kli"``, I contiguous).
    Returns int32 ``[K, O, L]``. On the card O and L must be multiples of
    128 and I of 64 (the script's shapes are); anything else raises."""
    if b_layout not in ("kil", "kli"):
        raise ValueError(f"b_layout {b_layout!r}; 'kil' or 'kli'")
    _check_int8("stacked_matmul_int8", a=a, b=b)
    if a.ndim != 2 or b.ndim != 3:
        raise ValueError(f"stacked_matmul_int8: a {tuple(a.shape)}, b {tuple(b.shape)}")
    o, i = a.shape
    k, bi, l = b.shape if b_layout == "kil" else (b.shape[0], b.shape[2], b.shape[1])
    if bi != i:
        raise ValueError(f"stacked_matmul_int8: a {tuple(a.shape)}, b {tuple(b.shape)} "
                         f"as {b_layout}")
    if a.device.type == "cpu":
        return stacked_matmul_int8_plain(a, b, b_layout)
    if o % _M_ALIGN or l % _M_ALIGN or i % _K_ALIGN:
        raise ValueError(f"stacked_matmul_int8 on the card takes O and L in multiples of "
                         f"{_M_ALIGN} and I of {_K_ALIGN}, got O {o}, I {i}, L {l}")
    return taps_matmul_int8(a[None], b, [0], l, raw=b_layout == "kil", counter="stacked_matmul")


def slice_sum_int8(x, offsets, o: int, cols: int):
    """K9's ``sliceonly``, ``slice_sum_kernel``: for every step s,

        out[s, r] = bf16( sum_tap int32(x[s, r, off : off + cols]) )   r < min(o, I)

    and rows from I to ``o`` zero, exact in int32 before the one rounding.

    Args:
      x: int8 ``[S, I, P]``.
      offsets: 1 to 9 column offsets, in any order, each with ``off + cols
        <= P``.
      o: rows of the output.
    Returns bf16 ``[S, o, cols]``. On the card cols and P must be multiples
    of 8 and x 8-byte aligned; anything else raises. The launch counts under
    ``slice_sum``."""
    _check_int8("slice_sum_int8", x=x)
    offsets = [int(v) for v in offsets]
    if x.ndim != 3 or not 1 <= len(offsets) <= MAX_TAPS or o < 1 or cols < 1 \
            or min(offsets) < 0 or max(offsets) + cols > x.shape[2]:
        raise ValueError(f"slice_sum_int8: x {tuple(x.shape)}, offsets {offsets}, o {o}, "
                         f"cols {cols}")
    if x.device.type == "cpu":
        return slice_sum_int8_plain(x, offsets, o, cols)
    s, i, p = x.shape
    if cols % 8 or p % 8 or x.data_ptr() % 8:
        raise ValueError(f"slice_sum_int8 on the card takes cols and P in multiples of 8 and "
                         f"x 8-byte aligned, got cols {cols}, P {p}, x at "
                         f"{x.data_ptr() % 16} bytes off 16")
    plan_slice_sum(o, i, p, cols)               # raises where no unit of one row fits
    out = torch.empty((s, o, cols), dtype=torch.bfloat16, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    _launch("slice_sum", _lib().afcm_slice_sum_int8, x, x.data_ptr(), out.data_ptr(),
            s, o, i, p, cols, len(offsets), offs)
    return out


def nine_tap_int8(w9, x, mode: str, cols: int, wp: int):
    """K9: per step ``s``, the sum over the taps of ``mode`` of
    ``w9[tap] @ x[s, :, off : off + cols]`` in int32, rounded to bf16.
    ``dot1``, ``aligned`` and ``slices`` run ``taps_matmul_kernel``
    (``taps_matmul_int8``, counted under ``nine_tap``); ``sliceonly`` sums
    the slices without a product in ``slice_sum_kernel`` (``slice_sum_int8``,
    counted under ``slice_sum``).

    Args:
      w9: int8 ``[9, O, I]``.
      x: int8 ``[S, I, P]``, P at least ``cols + 2 * wp + 2``.
      mode: ``dot1`` | ``aligned`` | ``slices`` | ``sliceonly``.
      cols: output columns per step; wp: the row pitch of the tap offsets.
    Returns bf16 ``[S, O, cols]``. On the card O and cols must be multiples
    of 128, I of 64 and P of 8; anything else raises."""
    offsets = tap_offsets(mode, wp)
    _check_int8("nine_tap_int8", w9=w9, x=x)
    if w9.ndim != 3 or w9.shape[0] != 9 or x.ndim != 3 or x.shape[1] != w9.shape[2] \
            or cols < 1 or max(offsets) + cols > x.shape[2]:
        raise ValueError(f"nine_tap_int8: w9 {tuple(w9.shape)}, x {tuple(x.shape)}, "
                         f"cols {cols}, wp {wp}")
    if x.device.type == "cpu":
        return nine_tap_int8_plain(w9, x, mode, cols, wp)
    _, o, i = w9.shape
    p = x.shape[2]
    if o % _M_ALIGN or cols % _M_ALIGN or i % _K_ALIGN or p % 8:
        raise ValueError(f"nine_tap_int8 on the card takes O and cols in multiples of "
                         f"{_M_ALIGN}, I of {_K_ALIGN} and P of 8, got O {o}, I {i}, "
                         f"cols {cols}, P {p}")
    if mode == "sliceonly":
        return slice_sum_int8(x, offsets, o, cols)
    return taps_matmul_int8(w9, x, offsets, cols, out_dtype=torch.bfloat16,
                            counter="nine_tap")
