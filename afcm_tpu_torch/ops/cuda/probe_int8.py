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
  product).

Both kernels share the tile loop and the ``mma.sync.m16n8k32`` product of
the int8 conv (``csrc/mma_s8.cuh``). Integer sums have no rounding: each
kernel equals its plain version bit for bit. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``launches`` counts
the launches by kernel name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of each kernel in this process (tests and chip_smoke.py read and
# reset them).
launches = {"stacked_matmul": 0, "nine_tap": 0}

MODES = ("dot1", "aligned", "slices", "sliceonly")
_M_ALIGN = 128      # AFCM_P8_BM, AFCM_P8_BN in csrc/probe_int8.cu
_K_ALIGN = 64       # AFCM_P8_KC


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


def nine_tap_int8_plain(w9, x, mode: str, cols: int, wp: int):
    o, i = w9.shape[1:]
    acc = torch.zeros((x.shape[0], o, cols), dtype=torch.int32, device=x.device)
    for tap, off in enumerate(tap_offsets(mode, wp)):
        rhs = x[:, :, off:off + cols]
        if mode == "sliceonly":
            rows = min(o, i)
            acc[:, :rows] += rhs[:, :rows].to(torch.int32)
        else:
            acc += _int_matmul(w9[tap][None], rhs)
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
    lib.afcm_taps_matmul_int8.restype = lib.afcm_slice_sum_int8.restype = ctypes.c_int
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
    out = torch.empty((k, o, l), dtype=torch.int32, device=a.device)
    offs = (ctypes.c_int * 1)(0)
    _launch("stacked_matmul", _lib().afcm_taps_matmul_int8, a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), k, o, i, l, l, 1, offs, int(b_layout == "kil"), 0)
    return out


def nine_tap_int8(w9, x, mode: str, cols: int, wp: int):
    """K9: per step ``s``, the sum over the taps of ``mode`` of
    ``w9[tap] @ x[s, :, off : off + cols]`` in int32, rounded to bf16.

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
    s, _, p = x.shape
    if o % _M_ALIGN or cols % _M_ALIGN or i % _K_ALIGN or p % 8:
        raise ValueError(f"nine_tap_int8 on the card takes O and cols in multiples of "
                         f"{_M_ALIGN}, I of {_K_ALIGN} and P of 8, got O {o}, I {i}, "
                         f"cols {cols}, P {p}")
    out = torch.empty((s, o, cols), dtype=torch.bfloat16, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    if mode == "sliceonly":
        _launch("nine_tap", _lib().afcm_slice_sum_int8, x, x.data_ptr(), out.data_ptr(),
                s, o, i, p, cols, len(offsets), offs)
    else:
        _launch("nine_tap", _lib().afcm_taps_matmul_int8, x, w9.data_ptr(), x.data_ptr(),
                out.data_ptr(), s, o, i, p, cols, len(offsets), offs, 1, 1)
    return out
