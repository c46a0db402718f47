"""Kernels K5-K7: the stream, copy and window-load probes, CUDA C++ for
Hopper (``csrc/probe_stream.cu``), with their plain PyTorch versions.

They are the ports of the TPU probe kernels of three scripts, which measure
what hand-written loads and stores reach at the FIR layers' shapes (no tap
math):

* K5 ``scripts/probe_fir_roofline.py``: ``stream_copy`` (``build_copy``
  ``:81``), ``stream_wr4x`` (``build_wr4x`` ``:94``), ``stream_rd4x``
  (``build_rd4x`` ``:112``), ``stream_chain`` (``build_chain`` ``:130``);
* K6 ``scripts/probe_stream_diag.py``: ``copy3d`` (``:39``) and ``copy2d``
  (``:49``);
* K7 ``scripts/probe_element_windows.py``: ``element_windows`` (the four
  ``pl.Element`` calls, ``:41-104``).

K7 assembles each CTA's output span (one window position, a group of
channels, ``plan_windows``) in shared memory and stores it with the bulk
copy's store.

K5a and K6 are one kernel, a bulk copy (``csrc/probe_stream.cu``): each CTA
moves pieces of the span through a ring of stages in shared memory with
``cp.async.bulk``. ``plan_copy`` gives K6 one CTA per block of the TPU
grid, and K5a a persistent grid of one CTA an SM whose CTAs claim the
span's pieces from a counter. The wrapper allocates y at x's offset modulo
16, so both move the same 16-byte body.

The TPU kernels fold the 4x factor of ``wr4x`` / ``rd4x`` into channel
*blocks* whose size follows that machine's fast memory (``_blocks``,
``:65-78``); the port fixes one layout that depends on no block size,
``y[c, k] = x[c] * 2**-k`` as ``[C, 4, H, W]``. Arithmetic keeps the TPU
kernels' order and types: bf16 in, every product and sum rounded to bf16.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``launches`` counts the launches by kernel name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

# Launches of each kernel in this process (tests and chip_smoke.py read and
# reset them).
launches = {"copy": 0, "wr4x": 0, "rd4x": 0, "chain": 0, "copy3d": 0,
            "copy2d": 0, "windows": 0}

CHAIN_TILE = 512            # 16-byte items of x per CTA step: 32 KB shared
CHAIN_TILE_MAX = 3584       # 4 * 3584 * 16 bytes = 224 KB of the 227 KB


# The bulk copy's rings (stages, bytes a stage). K6's blocks: six stages of
# 32 KB, five loads in flight a CTA and one CTA an SM (192 KB). K5a's
# shared span: four stages of 16 KB, one CTA an SM claiming pieces.
# RING_STAGES_MAX is the kernel's AFCM_PS_RING_MAX.
BLOCK_RING = (6, 32 << 10)
FLAT_RING = (4, 16 << 10)
RING_STAGES_MAX = 8
CTA_SHARED_MAX = 232448     # dynamic shared memory one CTA can have (AFCM_PS_SMEM_MAX)
WINDOW_CHUNK = 12288        # K7: values of a CTA's output a chunk, 48 KB of shared memory


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ---------------------------------------------------------------- plain

def stream_copy_plain(x):
    return x.clone()


def stream_wr4x_plain(x):
    """``[C, H, W]`` -> ``[C, 4, H, W]``: x, x/2, x/4, x/8 (exact in bf16)."""
    return torch.stack([x, x * 0.5, x * 0.25, x * 0.125], dim=1)


def stream_rd4x_plain(x):
    """``[C, 4, H, W]`` -> ``[C, H, W]``: ``(a + b) + (d + e)``, each sum
    rounded to the tensor's type."""
    return (x[:, 0] + x[:, 1]) + (x[:, 2] + x[:, 3])


def stream_chain_plain(x):
    """x -> four scaled copies -> leaky ReLU 0.2 -> pairwise sum, every
    product and sum in the tensor's type (the slope too: 0.2 rounded to
    bf16, as a bf16 kernel's constant is)."""
    t = stream_wr4x_plain(x)
    slope = torch.tensor(0.2, dtype=x.dtype, device=x.device)
    return stream_rd4x_plain(torch.where(t > 0, t, slope * t))


def element_windows_plain(x, win_w, n_tw, stride_w, lo_w=0, c_out=None,
                          win_h=None, n_th=1, stride_h=0, lo_h=0, scale=2.0):
    """The plain version of ``element_windows``: zero-pad, slice, stack."""
    c, h, w = x.shape
    c_out = c if c_out is None else c_out
    win_h = h if win_h is None else win_h
    hi_w = max(0, (n_tw - 1) * stride_w - lo_w + win_w - w)
    hi_h = max(0, (n_th - 1) * stride_h - lo_h + win_h - h)
    xp = F.pad(x, (lo_w, hi_w, lo_h, hi_h, 0, c_out - c))
    out = torch.stack([torch.stack([
        xp[:, ty * stride_h:ty * stride_h + win_h, tx * stride_w:tx * stride_w + win_w]
        for tx in range(n_tw)]) for ty in range(n_th)]) * scale
    return out


# ---------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of ``csrc/probe_stream.cu``, built at first use."""
    from ._build import load_library
    lib = load_library("probe_stream")[0]
    i, p, ll, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.afcm_probe_copy.argtypes = [p, p, ll, ll, i, i, i, p, p]
    lib.afcm_probe_x4.argtypes = [p, p, ll, i, i, p]
    lib.afcm_probe_chain.argtypes = [p, p, ll, i, p]
    lib.afcm_probe_windows.argtypes = [p, p] + [i] * 12 + [f, i, i, p]
    for fn in (lib.afcm_probe_copy, lib.afcm_probe_x4, lib.afcm_probe_chain,
               lib.afcm_probe_windows):
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, ndim, dtype=torch.bfloat16):
    if not (isinstance(x, torch.Tensor) and x.ndim == ndim and x.dtype == dtype
            and x.is_contiguous() and x.numel() > 0):
        raise ValueError(f"{name} needs a contiguous {ndim}-D {dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")


def _launch(name, fn, x, *args):
    with torch.cuda.device(x.device):       # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_stream kernel {name} launch failed: CUDA error {err}")
    launches[name] += 1


def stream_copy(x):
    """K5a: ``y = x`` for a bf16 tensor of any shape (read 1x, write 1x), by
    the bulk copy over a persistent grid."""
    _check("stream_copy", x, x.ndim)
    return bulk_copy(x)


def stream_wr4x(x):
    """K5b: bf16 ``[C, H, W]`` -> ``[C, 4, H, W]``, ``y[c, k] = x[c] * 2**-k``
    (read 1x, write 4x: the up-FIR's write pattern)."""
    _check("stream_wr4x", x, 3)
    if x.device.type == "cpu":
        return stream_wr4x_plain(x)
    c, h, w = x.shape
    y = torch.empty((c, 4, h, w), dtype=x.dtype, device=x.device)
    _launch("wr4x", _lib().afcm_probe_x4, x, x.data_ptr(), y.data_ptr(), c, h * w, 0)
    return y


def stream_rd4x(x):
    """K5c: bf16 ``[C, 4, H, W]`` -> ``[C, H, W]``, ``(a + b) + (d + e)``
    (read 4x, write 1x: the down-FIR's read pattern)."""
    _check("stream_rd4x", x, 4)
    if x.shape[1] != 4:
        raise ValueError(f"stream_rd4x needs [C, 4, H, W], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stream_rd4x_plain(x)
    c, _, h, w = x.shape
    y = torch.empty((c, h, w), dtype=x.dtype, device=x.device)
    _launch("rd4x", _lib().afcm_probe_x4, x, x.data_ptr(), y.data_ptr(), c, h * w, 1)
    return y


def stream_chain(x, tile: int = CHAIN_TILE):
    """K5d: the fused chain's device-memory traffic (x in, y out) with the
    4x intermediate in shared memory: ``tile`` 16-byte items of x per CTA
    step (a multiple of 256, at most 3584), 64 * tile bytes of shared
    memory."""
    _check("stream_chain", x, x.ndim)
    if tile < 256 or tile % 256 or tile > CHAIN_TILE_MAX:
        raise ValueError(f"stream_chain tile {tile}: a multiple of 256 up to {CHAIN_TILE_MAX}")
    if x.device.type == "cpu":
        return stream_chain_plain(x)
    y = torch.empty_like(x)
    _launch("chain", _lib().afcm_probe_chain, x, x.data_ptr(), y.data_ptr(), x.numel(), tile)
    return y


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """How the bulk copy cuts ``nbytes``. A block plan (K6): CTA b copies
    the bytes from ``b * block_bytes`` (the last CTA what is left), its
    pieces in order. A shared plan (K5a; ``block_bytes == nbytes``): the
    ``ctas`` CTAs claim the span's pieces from a counter in turn. A piece is
    ``stage_bytes`` (the last of a block or span shorter), and each CTA has
    a ring of ``stages`` of them; the kernel copies the head before a
    block's first 16-byte boundary and the tail after its last one with
    2-byte accesses."""
    nbytes: int
    block_bytes: int
    ctas: int
    stages: int
    stage_bytes: int
    shared: bool = False


def plan_copy(nbytes: int, block_bytes=None, sms: int = 132, ring=None) -> CopyPlan:
    """One CTA per ``block_bytes`` (K6: the TPU grid's block) through
    ``BLOCK_RING``, or, with None, the flat copy (K5a): a persistent grid of
    one CTA an SM, fewer for a span of fewer pieces, sharing the span
    through ``FLAT_RING``. ``ring`` (stages, bytes a stage) overrides the
    ring."""
    stages, stage_bytes = ring or (FLAT_RING if block_bytes is None else BLOCK_RING)
    if nbytes < 2 or nbytes % 2:
        raise ValueError(f"bulk copy of {nbytes} bytes: bf16 spans only")
    if not (2 <= stages <= RING_STAGES_MAX and stage_bytes >= 16 and stage_bytes % 16 == 0
            and stages * stage_bytes <= CTA_SHARED_MAX):
        raise ValueError(f"bulk copy ring of {stages} x {stage_bytes} bytes")
    if block_bytes is None:
        ctas = max(1, min(sms, -(-nbytes // stage_bytes)))
        return CopyPlan(nbytes, nbytes, ctas, stages, stage_bytes, shared=True)
    if block_bytes < 2 or block_bytes % 2:
        raise ValueError(f"bulk copy blocks of {block_bytes} bytes")
    return CopyPlan(nbytes, block_bytes, -(-nbytes // block_bytes), stages, stage_bytes)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def empty_like_aligned(x):
    """An empty contiguous tensor like x whose data starts at x's offset
    modulo 16 bytes, so that the bulk copy moves the same 16-byte body of
    both (a view of a buffer 16 bytes longer where the allocator's own
    alignment differs from x's)."""
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if (y.data_ptr() - x.data_ptr()) % 16 == 0:
        return y
    size = x.element_size()
    buf = torch.empty(x.numel() + 16 // size, dtype=x.dtype, device=x.device)
    shift = (x.data_ptr() - buf.data_ptr()) % 16 // size
    return buf[shift:shift + x.numel()].view(x.shape)


def bulk_copy(x, block_bytes=None, ring=None, counter: str = "copy"):
    """y = x by the bulk copy kernel: one CTA per ``block_bytes``, or with
    None the flat copy's persistent grid, through ``ring`` (stages, bytes a
    stage; default ``BLOCK_RING`` or ``FLAT_RING``); the launch counts under
    ``counter``. ``stream_copy``, ``copy3d`` and ``copy2d`` call it with the
    default rings."""
    _check(counter, x, x.ndim)
    on_card = x.device.type != "cpu"
    plan = plan_copy(x.numel() * x.element_size(), block_bytes,
                     _sm_count(x.device.index) if on_card else 132, ring)
    if not on_card:
        return stream_copy_plain(x)
    claims = _claims(x.device) if plan.shared else None
    y = empty_like_aligned(x)
    _launch(counter, _lib().afcm_probe_copy, x, x.data_ptr(), y.data_ptr(), plan.nbytes,
            plan.block_bytes, plan.ctas, plan.stages, plan.stage_bytes,
            None if claims is None else claims.data_ptr())
    return y


_claim_counters = {}


def _claims(device):
    """The shared span's claim counter of the current stream on ``device``:
    two int64 words, zero between launches (the kernel's last CTA zeroes
    them), so launches on one stream, which run in turn, can share it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _claim_counters:
        _claim_counters[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _claim_counters[key]


def copy3d(x, cb: int):
    """K6a: ``y = x`` for bf16 ``[C, H, W]``, one CTA per block of ``cb``
    planes (copied as one span of bytes)."""
    _check("copy3d", x, 3)
    if cb < 1 or x.shape[0] % cb:
        raise ValueError(f"copy3d: {x.shape[0]} planes do not divide into blocks of {cb}")
    return bulk_copy(x, cb * x.shape[1] * x.shape[2] * x.element_size(), counter="copy3d")


def copy2d(x, br: int):
    """K6b: ``y = x`` for a flat bf16 ``[rows, cols]``, one CTA per block of
    ``br`` rows (the last CTA takes the rows that are left)."""
    _check("copy2d", x, 2)
    if br < 1:
        raise ValueError(f"copy2d: {br} rows per CTA")
    return bulk_copy(x, br * x.shape[1] * x.element_size(), counter="copy2d")


def plan_windows(c_out: int, win_h: int, win_w: int, chunk: int = WINDOW_CHUNK):
    """K7's CTA work: (channels a CTA, values a chunk). A CTA takes one
    window position and the most channels, a multiple of 4 and at least 4,
    whose output (win_h * win_w values each) fits one ``chunk``, no more
    than ``c_out`` rounded up to 4; its span goes through shared memory in
    chunks of at most ``chunk`` values (a multiple of 4), 4 bytes each."""
    area = win_h * win_w
    group = max(4, chunk // area // 4 * 4)
    group = min(group, -(-c_out // 4) * 4)
    return group, min(chunk, -(-group * area // 4) * 4)


def element_windows(x, win_w, n_tw, stride_w, lo_w=0, c_out=None, win_h=None,
                    n_th=1, stride_h=0, lo_h=0, scale=2.0):
    """K7: overlapping, unaligned, zero-filled input windows of fp32
    ``[C, H, W]``:

        out[ty, tx, c] = scale * xpad[c, ty*stride_h - lo_h : + win_h,
                                         tx*stride_w - lo_w : + win_w]

    where xpad is x with zeros outside ``[0, H) x [0, W)`` and in the
    channels from C to ``c_out``. Returns ``[n_th, n_tw, c_out, win_h,
    win_w]``; ``win_h`` defaults to H (one row of windows along W, as the
    TPU probe has them)."""
    _check("element_windows", x, 3, torch.float32)
    c, h, w = x.shape
    c_out = c if c_out is None else int(c_out)
    win_h = h if win_h is None else int(win_h)
    if c_out < c or min(win_w, win_h, n_tw, n_th) < 1 or min(stride_w, stride_h) < 0:
        raise ValueError(f"element_windows: c_out {c_out} for {c} channels, window "
                         f"{win_h}x{win_w}, tiles {n_th}x{n_tw}, strides {stride_h}, {stride_w}")
    if x.device.type == "cpu":
        return element_windows_plain(x, win_w, n_tw, stride_w, lo_w, c_out, win_h,
                                     n_th, stride_h, lo_h, scale)
    out = torch.empty((n_th, n_tw, c_out, win_h, win_w), dtype=x.dtype, device=x.device)
    group, chunk = plan_windows(c_out, win_h, win_w)
    _launch("windows", _lib().afcm_probe_windows, x, x.data_ptr(), out.data_ptr(),
            c, h, w, c_out, win_h, win_w, n_th, n_tw, stride_h, stride_w, lo_h, lo_w,
            float(scale), group, chunk)
    return out
