"""Kernels K1 and K2: the fused filtered leaky ReLU, forward and backward,
CUDA C++ for Hopper, bound as ``torch.library`` operators.

``afcm_tpu_torch::filtered_lrelu`` (``filtered_lrelu_op``) runs
``csrc/filtered_lrelu.cu`` (K1, the port of
``afcm_tpu/ops/pallas/filtered_lrelu_mxu.py:414-500``, kernel ``:273-290``)
on a CUDA tensor; its registered backward is
``afcm_tpu_torch::filtered_lrelu_bwd`` (``filtered_lrelu_bwd_op``), which
runs ``csrc/filtered_lrelu_bwd.cu`` (K2, the port of ``bwd_kernel``,
``:292-323``, behind the ``custom_vjp`` at ``:485-495``). On a CPU tensor
both operators compute the plain versions. The forward saves only its
input and the bias; K2 recomputes the pre-activation from them. Being
operators with fake (shape) implementations, the calls stay single nodes of
a ``torch.export`` graph, so an exported generator keeps K1.
``filtered_lrelu_cuda`` and ``filtered_lrelu_bwd_cuda`` take the reference's
arguments (numpy taps, padding, flip_filter) and call the operators on CUDA
tensors only.
``launches`` and ``bwd_launches`` count the launches of K1 and K2. Both
kernels' tiles are planned here (``plan_fwd_tile``, ``plan_bwd_tile``):
which instantiation takes the call, the tile and its windows, and the shared
memory they need; the C entry points check the plan against their own
formulas.
``filtered_lrelu_plain`` and ``filtered_lrelu_bwd_plain`` beside them are
the plain PyTorch versions the kernels must reproduce: the CPU path of
``ops.filtered_lrelu`` and the oracles the card's checks compare against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..bias_act import bias_act
from ..filter_design import filter_size
from ..upfirdn2d import parse_padding, upfirdn2d

# Launches of the CUDA kernels in this process (tests and chip_smoke.py read
# and reset them): K1, the forward, and K2, the backward.
launches = 0
bwd_launches = 0

_MAX_TAPS = 64          # AFCM_MAX_TAPS in csrc/filtered_lrelu{,_bwd}.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K1's and K2's instantiations by filter geometry (up, down, up taps, down
# taps): the three of the shipped generator's layout. Every other geometry
# takes the generic kernel. The planners run without the libraries, so the
# sets stand here too; loading a library checks its set against the kernel's
# own list.
FWD_SPECIALISED = frozenset({(2, 2, 12, 12), (2, 4, 12, 24), (4, 2, 24, 12)})
BWD_SPECIALISED = frozenset({(2, 2, 12, 12), (2, 4, 12, 24), (4, 2, 24, 12)})
FWD_CHUNK = 8                       # AFCM_CHUNK: outputs per thread and chunk of K1's passes
BWD_SLACK = 64                      # AFCM_SLACK: floats before and after K2's buffers
SMEM_TWO_CTAS = 112 * 1024          # dynamic bytes per CTA that keep two CTAs on an SM
SMEM_ONE_CTA = 226 * 1024           # AFCM_MAX_SMEM: what one CTA can have


def _up_window(up: int, ntu: int) -> int:
    """x samples a chunk of ``FWD_CHUNK`` polyphase up-FIR outputs reads
    when it starts at phase 0 (``up_window`` in csrc/filtered_lrelu.cu)."""
    reach = 0
    for i in range(FWD_CHUNK):
        k0 = -i % up
        reach = max(reach, (i + k0) // up + -(-(ntu - k0) // up))
    return reach


def fwd_windows(tile: int, up: int, down: int, ntu: int, ntd: int,
                specialised: bool):
    """(M, L, E) of K1 per axis for an output tile of ``tile`` pixels: the
    mid window ``(T - 1) * down + ntd``; the samples the up passes make, E,
    which the specialised kernel rounds up to whole chunks from phase 0
    (``ceil((M + up - 1) / 8) * 8``) and the generic kernel keeps at M; and
    the x window those read, ``E / up - 8 / up + (a chunk's reach)`` or
    ``ceil((M + ntu - 2) / up) + 1``."""
    mid = (tile - 1) * down + ntd
    if specialised:
        ext = -(-(mid + up - 1) // FWD_CHUNK) * FWD_CHUNK
        return mid, ext // up - FWD_CHUNK // up + _up_window(up, ntu), ext
    return mid, -(-(mid + ntu - 2) // up) + 1, mid


def _fwd_tile(tile_y, tile_x, up, down, ntu, ntd, out_h, out_w, specialised):
    (my, ly, ey), (mx, lx, ex) = (fwd_windows(t, up, down, ntu, ntd, specialised)
                                  for t in (tile_y, tile_x))
    # odd row pitches in the specialised kernel: no bank conflicts where the
    # lanes of a warp take neighbouring rows
    pitch = (lambda v: v | 1) if specialised else (lambda v: v)
    buf_a = max(ly * pitch(lx), ey * pitch(mx), tile_y * pitch(tile_x) if specialised else 0)
    buf_b = max(ly * pitch(ex), tile_y * pitch(mx))
    tiles = -(-out_h // tile_y) * -(-out_w // tile_x)
    work = tiles * ((ly * ex + mx * ey) * -(-ntu // up)
                    + (tile_y * mx + tile_y * tile_x) * ntd)
    return dict(tile_y=tile_y, tile_x=tile_x, mid_y=my, mid_x=mx, in_y=ly, in_x=lx,
                smem_bytes=4 * (buf_a + buf_b), specialised=specialised, tiles=tiles,
                fmas_per_plane=work)


def plan_fwd_tile(up: int, down: int, ntu: int, ntd: int, out_h: int, out_w: int):
    """K1's plan for one call: the output tile Ty x Tx (multiples of 8 in a
    specialised instantiation, of 4 in the generic kernel, up to 64) that
    does the least work over all tiles of the image within the shared memory
    that keeps two CTAs on an SM (one CTA's where no tile fits that), its
    windows M and L per axis, the dynamic shared memory, and whether the
    geometry has an instantiation of its own (``FWD_SPECIALISED``) or takes
    the generic kernel. Raises where not even the smallest tile fits. The
    search runs once per geometry and size: it costs about a millisecond of
    Python, more than the kernel takes."""
    return dict(_plan_fwd_tile(up, down, ntu, ntd, out_h, out_w,
                               (up, down, ntu, ntd) in FWD_SPECIALISED))


@functools.lru_cache(maxsize=1024)
def _plan_fwd_tile(up, down, ntu, ntd, out_h, out_w, specialised):
    sides = range(FWD_CHUNK if specialised else 4, 65, FWD_CHUNK if specialised else 4)
    plans = [_fwd_tile(ty, tx, up, down, ntu, ntd, out_h, out_w, specialised)
             for ty in sides for tx in sides]
    for budget in (SMEM_TWO_CTAS, SMEM_ONE_CTA):
        fitting = [pl for pl in plans if pl["smem_bytes"] <= budget]
        if fitting:
            return min(fitting, key=lambda pl: (pl["fmas_per_plane"], pl["smem_bytes"],
                                                pl["tile_y"]))
    raise ValueError(f"filtered_lrelu forward: no tile of up={up}, down={down}, "
                     f"{ntu}/{ntd} taps fits {SMEM_ONE_CTA} bytes of shared memory")


def bwd_windows(tile: int, up: int, down: int, ntu: int, ntd: int):
    """(M, L, D) of K2 for a dx tile of ``tile`` pixels per axis: the mid
    window ``(T - 1) * up + ntu``, the x window ``ceil((M + ntu - 2) / up) +
    1`` and the dy window ``(M + ntd - 2) // down + 1``."""
    mid = (tile - 1) * up + ntu
    return mid, -(-(mid + ntu - 2) // up) + 1, (mid + ntd - 2) // down + 1


def _bwd_tile(tile, up, down, ntu, ntd, in_h, in_w, specialised):
    mid, in_tile, dy_tile = bwd_windows(tile, up, down, ntu, ntd)
    # odd row pitches in the specialised kernel: no bank conflicts where the
    # lanes of a warp take neighbouring rows
    pitch = (lambda v: v | 1) if specialised else (lambda v: v)
    buf_a = max(in_tile * pitch(in_tile), dy_tile * pitch(dy_tile))
    buf_b = max(in_tile, dy_tile, tile) * pitch(mid)
    buf_m = mid * pitch(mid)
    taps_up, taps_down = -(-ntu // up), -(-ntd // down)
    tiles = -(-in_h // tile) * -(-in_w // tile)
    work = tiles * (in_tile * mid * taps_up + mid * mid * taps_up
                    + dy_tile * mid * taps_down + mid * mid * taps_down
                    + tile * mid * ntu + tile * tile * ntu)
    return dict(tile=tile, mid=mid, in_tile=in_tile, dy_tile=dy_tile,
                smem_bytes=4 * (2 * BWD_SLACK + buf_a + buf_b + buf_m),
                specialised=specialised, tiles=tiles, fmas_per_plane=work)


def plan_bwd_tile(up: int, down: int, ntu: int, ntd: int, in_h: int, in_w: int):
    """K2's plan for one call: the dx tile T (a multiple of 4) that does the
    least work over all tiles of the image within the shared memory that
    keeps two CTAs on an SM (one CTA's where no tile fits that), its windows
    M, L and D, the dynamic shared memory, and whether the geometry has an
    instantiation of its own (``BWD_SPECIALISED``) or takes the generic
    kernel. Raises where not even T = 4 fits. The search runs once per
    geometry and size."""
    return dict(_plan_bwd_tile(up, down, ntu, ntd, in_h, in_w,
                               (up, down, ntu, ntd) in BWD_SPECIALISED))


@functools.lru_cache(maxsize=1024)
def _plan_bwd_tile(up, down, ntu, ntd, in_h, in_w, specialised):
    plans = [_bwd_tile(t, up, down, ntu, ntd, in_h, in_w, specialised)
             for t in range(4, 65, 4)]
    for budget in (SMEM_TWO_CTAS, SMEM_ONE_CTA):
        fitting = [pl for pl in plans if pl["smem_bytes"] <= budget]
        if fitting:
            return min(fitting, key=lambda pl: (pl["fmas_per_plane"], pl["tile"]))
    raise ValueError(f"filtered_lrelu backward: no tile of up={up}, down={down}, "
                     f"{ntu}/{ntd} taps fits {SMEM_ONE_CTA} bytes of shared memory")


def filtered_lrelu_plain(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                         gain=np.sqrt(2), slope=0.2, clamp=None,
                         flip_filter=False):
    """bias -> upfirdn(fu, up, pad, gain=up²) -> lrelu(slope)·gain, clamp ->
    upfirdn(fd, down): ``afcm_tpu/ops/filtered_lrelu.py:146-151``."""
    px0, px1, py0, py1 = parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


def _upfirdn2d_adjoint(dy, f, in_shape, up=1, down=1, padding=0, gain=1,
                       flip_filter=False):
    """The transpose of ``upfirdn2d(x, f, up, down, padding, gain=gain,
    flip_filter)`` for an x of ``in_shape``, applied to dy: upfirdn2d with
    up and down swapped and the filter flipped (the reference's
    torch_utils/ops/upfirdn2d.py backward)."""
    f = None if f is None else np.asarray(f, np.float32)
    fw, fh = filter_size(f)
    px0, _, py0, _ = parse_padding(padding)
    ih, iw = in_shape[2], in_shape[3]
    oh, ow = dy.shape[2], dy.shape[3]
    p = [fw - px0 - 1, iw * up - ow * down + px0 - up + 1,
         fh - py0 - 1, ih * up - oh * down + py0 - up + 1]
    return upfirdn2d(dy, f, up=down, down=up, padding=p, gain=gain,
                     flip_filter=not flip_filter)


def filtered_lrelu_bwd_plain(x, dy, fu=None, fd=None, b=None, up=1, down=1,
                             padding=0, gain=np.sqrt(2), slope=0.2, clamp=None,
                             flip_filter=False):
    """(dx, db) of ``filtered_lrelu_plain`` at (x, b) for the output
    gradient ``dy``, written out as the transposes of its two FIR passes
    around the leaky ReLU's and the clamp's masks (the derivatives autograd
    takes of them: slope where the pre-activation is not > 0, zero where the
    activation lies outside ±clamp); db is None when b is None. No autograd,
    so it also runs where autograd is off (inside an operator's kernel)."""
    px0, px1, py0, py1 = parse_padding(padding)
    pad = [px0, px1, py0, py1]
    with torch.no_grad():
        pre = upfirdn2d(bias_act(x, b), fu, up=up, padding=pad, gain=up ** 2,
                        flip_filter=flip_filter)
        d_act = _upfirdn2d_adjoint(dy.to(pre.dtype), fd, pre.shape, down=down,
                                   flip_filter=flip_filter)
        d_pre = d_act * torch.where(pre > 0, 1.0, slope).to(pre.dtype) * gain
        if clamp is not None:
            act = torch.where(pre > 0, pre, pre * slope) * gain
            d_pre = torch.where((act >= -clamp) & (act <= clamp), d_pre,
                                torch.zeros_like(d_pre))
        dx = _upfirdn2d_adjoint(d_pre, fu, x.shape, up=up, padding=pad, gain=up ** 2,
                                flip_filter=flip_filter).to(x.dtype)
    return dx, (None if b is None else _bias_grad(dx, b))


def slope_ambiguous(x, fu=None, b=None, up=1, padding=0, gain=np.sqrt(2),
                    slope=0.2, clamp=None, flip_filter=False, rtol=1e-5):
    """Bool mask over x: the pixels whose gradient passes through a
    pre-activation within ``rtol * max|pre-activation|`` of the leaky ReLU's
    kink at 0 or of ±clamp. There the slope (or the clamp's cut) is decided
    by rounding, so two correct backward passes whose pre-activations differ
    in the last bits may differ by up to (1 - slope)·gain·|dL/d(act)| per
    up tap. Checks of a backward against another hold it to a bound
    elsewhere and count these pixels."""
    px0, px1, py0, py1 = parse_padding(padding)
    pad = [px0, px1, py0, py1]
    with torch.no_grad():
        pre = upfirdn2d(bias_act(x.float(), None if b is None else b.float()),
                        fu, up=up, padding=pad, gain=up ** 2,
                        flip_filter=flip_filter)
        tol = rtol * float(pre.abs().max())
        near = pre.abs() <= tol
        if clamp is not None:
            act = torch.where(pre > 0, pre, pre * slope).abs() * gain
            near |= (act - clamp).abs() <= tol * gain
    with torch.enable_grad():
        # which inputs the up-FIR carries to those samples: its transpose,
        # with every tap made positive
        z = torch.zeros(x.shape, device=x.device, requires_grad=True)
        mid = upfirdn2d(z, None if fu is None else np.abs(fu), up=up,
                        padding=pad, gain=up ** 2, flip_filter=flip_filter)
        (reach,) = torch.autograd.grad(mid, z, near.float())
    return reach > 0


@functools.lru_cache(maxsize=None)
def _kernel(direction: str):
    """The C entry point of K1 ("fwd") or K2 ("bwd"), built at first use."""
    from ._build import load_library
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    name = "filtered_lrelu" if direction == "fwd" else "filtered_lrelu_bwd"
    expected = FWD_SPECIALISED if direction == "fwd" else BWD_SPECIALISED
    library = load_library(name)[0]
    listed = (ctypes.c_int * (4 * 16))()
    count = getattr(library, f"afcm_filtered_lrelu_{direction}_geometries")(listed, 16)
    built = {tuple(listed[4 * k:4 * k + 4]) for k in range(min(count, 16))}
    if count > 16 or built != expected:
        raise RuntimeError(f"{name}.cu instantiates {sorted(built)} ({count}), the "
                           f"planner expects {sorted(expected)}")
    fn = getattr(library, f"afcm_filtered_lrelu_{direction}")
    tensors = [p, p, p] if direction == "fwd" else [p, p, p, p]   # x, bias, (dy,) y or dx
    fn.argtypes = tensors + [
        i,                                        # dtype
        i, i, i, i, i, i,                         # n, c, in_h, in_w, out_h, out_w
        p, i, p, i,                               # fu, ntu, fd, ntd
        i, i, i, i,                               # up, down, px0, py0
        f, f, f, i]                               # gain, slope, clamp, has_clamp
    if direction == "fwd":
        fn.argtypes += [i] * 8                    # Ty, Tx, My, Mx, Ly, Lx, smem bytes, specialised
    else:
        fn.argtypes += [i] * 6                    # T, M, L, D, smem bytes, specialised
    fn.argtypes += [p]                            # stream
    fn.restype = ctypes.c_int
    return fn


def _correlation_taps(f, scale: float, flip_filter: bool) -> np.ndarray:
    """Taps in the kernel's correlation order (flipped unless flip_filter),
    times the per-axis gain; None is the 1-tap identity filter."""
    if f is None:
        return np.asarray([scale], np.float32)
    f = np.asarray(f, np.float32)
    if f.ndim != 1:
        raise NotImplementedError(
            "the filtered_lrelu kernels take separable (1-D) filters only; "
            "radial 2-D filters are used by no shipped config")
    if not 1 <= len(f) <= _MAX_TAPS:
        raise ValueError(f"filter of {len(f)} taps; the kernels take 1..{_MAX_TAPS}")
    f = f if flip_filter else f[::-1]
    return np.ascontiguousarray(f * np.float32(scale), np.float32)


class _Plan:
    """The static arguments of one call on x (a tensor or its shape),
    checked and in the kernels' form."""

    def __init__(self, x, fu, fd, up, down, padding, gain, slope, clamp,
                 flip_filter):
        self.up, self.down = int(up), int(down)
        if self.up < 1 or self.down < 1:
            raise ValueError(f"up={up}, down={down}")
        self.px0, px1, self.py0, py1 = parse_padding(padding)
        self.gu = _correlation_taps(fu, self.up, flip_filter)
        self.gd = _correlation_taps(fd, 1.0, flip_filter)
        self.n, self.c, self.in_h, self.in_w = map(int, getattr(x, "shape", x))
        taps = (len(self.gu) - 1) + (len(self.gd) - 1)
        self.out_w = (self.in_w * self.up + self.px0 + px1 - taps + self.down - 1) // self.down
        self.out_h = (self.in_h * self.up + self.py0 + py1 - taps + self.down - 1) // self.down
        if self.out_h < 1 or self.out_w < 1:
            raise ValueError(f"empty output {self.out_h}x{self.out_w} for input "
                             f"{self.in_h}x{self.in_w} and padding {padding}")
        self.gain, self.slope = float(gain), float(slope)
        self.has_clamp = clamp is not None
        self.clamp = float(clamp) if self.has_clamp else 0.0

    def scalars(self, dtype):
        return (_DTYPES[dtype], self.n, self.c, self.in_h, self.in_w,
                self.out_h, self.out_w, self.gu.ctypes.data, len(self.gu),
                self.gd.ctypes.data, len(self.gd), self.up, self.down,
                self.px0, self.py0, self.gain, self.slope, self.clamp,
                int(self.has_clamp))

    def fwd_tile(self):
        """K1's tile plan in the C entry point's order (the planner caches
        it per geometry and size)."""
        t = plan_fwd_tile(self.up, self.down, len(self.gu), len(self.gd),
                          self.out_h, self.out_w)
        return (t["tile_y"], t["tile_x"], t["mid_y"], t["mid_x"], t["in_y"], t["in_x"],
                t["smem_bytes"], int(t["specialised"]))

    def bwd_tile(self):
        """K2's tile plan in the C entry point's order."""
        t = plan_bwd_tile(self.up, self.down, len(self.gu), len(self.gd),
                          self.in_h, self.in_w)
        return (t["tile"], t["mid"], t["in_tile"], t["dy_tile"], t["smem_bytes"],
                int(t["specialised"]))


def _check_input(name, x, b):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous 4-D float32 or bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    if b is not None and (b.shape != (x.shape[1],) or b.device != x.device):
        raise ValueError(f"bias of shape {tuple(b.shape)} on {b.device} "
                         f"for {tuple(x.shape)} on {x.device}")


def _launch_fwd(x, b, plan: _Plan):
    global launches
    y = torch.empty((plan.n, plan.c, plan.out_h, plan.out_w), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):       # the launch goes to the current device
        err = _kernel("fwd")(
            x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            *plan.scalars(x.dtype), *plan.fwd_tile(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _launch_bwd(x, b, dy, plan: _Plan):
    global bwd_launches
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel("bwd")(
            x.data_ptr(), None if b is None else b.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *plan.scalars(x.dtype), *plan.bwd_tile(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


def _bias_grad(dx, b):
    return dx.sum((0, 2, 3), dtype=torch.float32).to(b.dtype)


# ---------------------------------------------------------------------------
# The operators: K1 as ``afcm_tpu_torch::filtered_lrelu`` and K2 as
# ``afcm_tpu_torch::filtered_lrelu_bwd``, defined and implemented with the
# low-level ``torch.library.Library``, whose call costs the host less than a
# ``torch.library.custom_op``'s (PERF.md §6). The schema holds the taps
# in the kernels' correlation order as float lists (empty: the 1-tap
# identity filter), not yet scaled by the up gain, and the four paddings;
# torch.export keeps each call as one node of the graph. CPU tensors take
# the plain versions, CUDA tensors the kernels.

_LIB = torch.library.Library("afcm_tpu_torch", "DEF")
_STATIC = ("float[] fu, float[] fd, int up, int down, int px0, int px1, int py0, "
           "int py1, float gain, float slope, float? clamp")
_LIB.define(f"filtered_lrelu(Tensor x, Tensor? b, {_STATIC}) -> Tensor")
_LIB.define(f"filtered_lrelu_bwd(Tensor x, Tensor? b, Tensor dy, {_STATIC}) -> Tensor")


@functools.lru_cache(maxsize=1024)
def _op_arguments(fu, fd, padding, flip_filter):
    taps = [[] if f is None else
            _correlation_taps(np.frombuffer(f[0], np.float32).reshape(f[1]), 1.0,
                              flip_filter).tolist() for f in (fu, fd)]
    return (*taps, *padding)


def _taps_key(f):
    if f is None:
        return None
    f = np.asarray(f, np.float32)
    return f.tobytes(), f.shape


def op_arguments(fu, fd, padding, flip_filter):
    """(fu, fd, px0, px1, py0, py1) of the operators for numpy taps in the
    reference's order: the taps flipped into correlation order unless
    ``flip_filter``, as float lists; converted once per filter content.
    Raises on radial (2-D) filters and on more taps than the kernels take,
    as the kernels would."""
    return _op_arguments(_taps_key(fu), _taps_key(fd), tuple(parse_padding(padding)),
                         bool(flip_filter))


def _op_taps(taps):
    return np.asarray(taps, np.float32) if len(taps) else None


@functools.lru_cache(maxsize=1024)
def _op_plan(shape, fu, fd, up, down, padding, gain, slope, clamp):
    """The _Plan of an operator call, once per shape and argument tuple: the
    taps go back to numpy on the first call only."""
    return _Plan(shape, _op_taps(fu), _op_taps(fd), up, down, padding, gain,
                 slope, clamp, True)


def _plan_of(x, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    return _op_plan(tuple(x.shape), tuple(fu), tuple(fd), up, down,
                    (px0, px1, py0, py1), gain, slope, clamp)


def _fwd_plain(x, b, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    return filtered_lrelu_plain(x, _op_taps(fu), _op_taps(fd), b, up, down,
                                [px0, px1, py0, py1], gain, slope, clamp,
                                flip_filter=True)


def _fwd_k1(x, b, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    _check_input("filtered_lrelu", x, b)
    if b is not None:
        b = b.to(x.dtype).contiguous()
    return _launch_fwd(x, b, _plan_of(x, fu, fd, up, down, px0, px1, py0, py1,
                                      gain, slope, clamp))


def _fwd_fake(x, b, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    # _Plan's output size, on symbolic sizes too
    taps = max(len(fu) - 1, 0) + max(len(fd) - 1, 0)
    n, c, in_h, in_w = x.shape
    out_h = (in_h * up + py0 + py1 - taps + down - 1) // down
    out_w = (in_w * up + px0 + px1 - taps + down - 1) // down
    return x.new_empty((n, c, out_h, out_w))


def _bwd_plain(x, b, dy, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    return filtered_lrelu_bwd_plain(x, dy, _op_taps(fu), _op_taps(fd), b, up, down,
                                    [px0, px1, py0, py1], gain, slope, clamp,
                                    flip_filter=True)[0]


def _bwd_k2(x, b, dy, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp):
    _check_input("filtered_lrelu_bwd", x, b)
    plan = _plan_of(x, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp)
    want = (plan.n, plan.c, plan.out_h, plan.out_w)
    if tuple(dy.shape) != want or dy.device != x.device:
        raise ValueError(f"dy of shape {tuple(dy.shape)} on {dy.device}; the "
                         f"forward's output is {want} on {x.device}")
    if b is not None:
        b = b.to(x.dtype).contiguous()
    # autograd may hand over a strided gradient; the kernel reads it dense
    return _launch_bwd(x, b, dy.to(x.dtype).contiguous(), plan)


def _bwd_fake(x, b, dy, *args):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    x, b, *ctx.args = inputs
    ctx.save_for_backward(x, b)


def _backward(ctx, dy):
    """K2 for dx, and db as dx summed over batch and space. First order
    only: R1 differentiates D alone, and nothing differentiates G twice."""
    x, b = ctx.saved_tensors
    dx = filtered_lrelu_bwd_op(x, b, dy, *ctx.args)
    db = _bias_grad(dx, b) if ctx.needs_input_grad[1] else None
    return (dx, db) + (None,) * len(ctx.args)


for _name, _plain, _kernel_fn, _fake in (("filtered_lrelu", _fwd_plain, _fwd_k1, _fwd_fake),
                                         ("filtered_lrelu_bwd", _bwd_plain, _bwd_k2,
                                          _bwd_fake)):
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _kernel_fn, "CUDA")
    torch.library.register_fake(f"afcm_tpu_torch::{_name}", _fake, lib=_LIB)
torch.library.register_autograd("afcm_tpu_torch::filtered_lrelu", _backward,
                                setup_context=_setup_context, lib=_LIB)
# filtered_lrelu_op(x, b, fu, fd, up, down, px0, px1, py0, py1, gain, slope, clamp)
filtered_lrelu_op = torch.ops.afcm_tpu_torch.filtered_lrelu.default
# filtered_lrelu_bwd_op(x, b, dy, fu, ...): dx of filtered_lrelu_op at (x, b) for dy
filtered_lrelu_bwd_op = torch.ops.afcm_tpu_torch.filtered_lrelu_bwd.default


def filtered_lrelu_call(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                        gain=np.sqrt(2), slope=0.2, clamp=None, flip_filter=False):
    """The operator for ``filtered_lrelu_plain``'s arguments, on any device."""
    fu, fd, px0, px1, py0, py1 = op_arguments(fu, fd, padding, flip_filter)
    return filtered_lrelu_op(x, b, fu, fd, int(up), int(down), px0, px1, py0, py1,
                             float(gain), float(slope),
                             None if clamp is None else float(clamp))


def filtered_lrelu_cuda(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                        gain=np.sqrt(2), slope=0.2, clamp=None,
                        flip_filter=False):
    """Kernel K1 on a CUDA tensor through the operator, differentiable
    through kernel K2; same arguments and result as ``filtered_lrelu_plain``."""
    _check_input("filtered_lrelu_cuda", x, b)
    return filtered_lrelu_call(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                               flip_filter)


def filtered_lrelu_bwd_cuda(x, dy, fu=None, fd=None, b=None, up=1, down=1,
                            padding=0, gain=np.sqrt(2), slope=0.2, clamp=None,
                            flip_filter=False):
    """Kernel K2 on CUDA tensors through the operator: (dx, db) of the
    forward at (x, b) for the output gradient ``dy``, as
    ``filtered_lrelu_bwd_plain``."""
    _check_input("filtered_lrelu_bwd_cuda", x, b)
    fu, fd, px0, px1, py0, py1 = op_arguments(fu, fd, padding, flip_filter)
    dx = filtered_lrelu_bwd_op(x, b, dy, fu, fd, int(up), int(down), px0, px1, py0,
                               py1, float(gain), float(slope),
                               None if clamp is None else float(clamp))
    return dx, (None if b is None else _bias_grad(dx, b))
