"""Python API over the native ops, with exact numpy fallbacks.

The port's own copy of ``afcm_tpu/native/ops.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from .build import get_native


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def assemble_windows(volume: np.ndarray, window_indices: np.ndarray,
                     lo: float, hi: float) -> np.ndarray:
    """Gather slice windows from a uint8 volume, normalized to [-1, 1].

    Args:
      volume: [D, H, W] uint8.
      window_indices: [batch, slices_per_window] int32; -1 = zero padding.
      lo / hi: Normalize range (e.g. 0, 255).
    Returns [batch, slices_per_window, H, W] float32.
    """
    volume = np.ascontiguousarray(volume, dtype=np.uint8)
    idx = np.ascontiguousarray(window_indices, dtype=np.int32)
    batch, spw = idx.shape
    d, h, w = volume.shape
    inv_range = 1.0 / (hi - lo)

    lib = get_native()
    if lib is not None:
        out = np.empty((batch, spw, h, w), dtype=np.float32)
        lib.assemble_windows(_ptr(volume, ctypes.c_uint8), d, h, w,
                             _ptr(idx, ctypes.c_int32), batch, spw,
                             ctypes.c_float(lo), ctypes.c_float(inv_range),
                             _ptr(out, ctypes.c_float))
        return out

    # numpy fallback (identical semantics)
    clipped = np.clip(idx, 0, d - 1)
    gathered = volume[clipped.reshape(-1)].astype(np.float32)
    gathered = np.clip(2 * (gathered - lo) * inv_range - 1, -1, 1)
    pad_value = np.clip(2 * (0.0 - lo) * inv_range - 1, -1, 1)
    invalid = (idx < 0) | (idx >= d)
    gathered[invalid.reshape(-1)] = pad_value
    return gathered.reshape(batch, spw, h, w)


def accumulate_patches(pmap: np.ndarray, nmask: np.ndarray,
                       patches: np.ndarray, coords: np.ndarray,
                       offsets: np.ndarray, sizes: np.ndarray):
    """Overlap-add halo-cropped patches into [D, H, W] accumulators in place.

    coords[b] = (z, y0, x0) destination origin; offsets[b] = (oy, ox) source
    offset inside the patch; sizes[b] = (h, w) of the cropped region.
    """
    assert pmap.dtype == np.float32 and nmask.dtype == np.uint16
    patches = np.ascontiguousarray(patches, dtype=np.float32)
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    batch, ph, pw = patches.shape
    d, h, w = pmap.shape

    lib = get_native()
    if lib is not None and pmap.flags["C_CONTIGUOUS"] and \
            nmask.flags["C_CONTIGUOUS"]:
        lib.accumulate_patches(_ptr(pmap, ctypes.c_float),
                               _ptr(nmask, ctypes.c_uint16), d, h, w,
                               _ptr(patches, ctypes.c_float), batch, ph, pw,
                               _ptr(coords, ctypes.c_int32),
                               _ptr(offsets, ctypes.c_int32),
                               _ptr(sizes, ctypes.c_int32))
        return

    for b in range(batch):
        z, y0, x0 = coords[b]
        oy, ox = offsets[b]
        ch, cw = sizes[b]
        pmap[z, y0:y0 + ch, x0:x0 + cw] += patches[b, oy:oy + ch, ox:ox + cw]
        nmask[z, y0:y0 + ch, x0:x0 + cw] += 1


def ssim_mean(x: np.ndarray, y: np.ndarray, win_size: int, c1: float,
              c2: float, cov_norm: float):
    """Fused native mean-SSIM (uniform window, reflect boundary, float64).

    Returns the scalar mean of the SSIM map over the win//2-cropped
    interior, or None when the native library is unavailable (callers fall
    back to the numpy path in utils/metrics.py, which this matches to
    ~1e-12).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    lib = get_native()
    if lib is None or x.shape != y.shape or x.ndim > 4 \
            or win_size % 2 != 1 or min(x.shape) < win_size:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    dims = np.asarray(x.shape, dtype=np.int64)
    out = np.zeros((1,), np.float64)
    lib.ssim_mean(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                  _ptr(dims, ctypes.c_long), x.ndim, win_size,
                  ctypes.c_double(c1), ctypes.c_double(c2),
                  ctypes.c_double(cov_norm),
                  _ptr(out, ctypes.c_double))
    return float(out[0])


def slice_metrics(g: np.ndarray, l: np.ndarray, win_size: int, c1: float,
                  c2: float, cov_norm: float):
    """Fused per-slice (axis-0) PSNR/SSIM means over two [D, H, W] volumes
    — the reference's evaluate_slice protocol (evaluation.py:116-121) in
    one native call (own-max PSNR normalization, data-range-2 constants,
    empty-target slices skipped). Returns (psnr_mean, ssim_mean, count) or
    None when the native library is unavailable (callers fall back to the
    per-slice loops in utils/metrics.py, which this matches to ~1e-12)."""
    g = np.asarray(g)
    l = np.asarray(l)
    lib = get_native()
    if lib is None or g.shape != l.shape or g.ndim != 3 \
            or win_size % 2 != 1 or min(g.shape[1:]) < win_size:
        return None
    g = np.ascontiguousarray(g, dtype=np.float64)
    l = np.ascontiguousarray(l, dtype=np.float64)
    out = np.zeros((3,), np.float64)
    lib.slice_metrics(_ptr(g, ctypes.c_double), _ptr(l, ctypes.c_double),
                      g.shape[0], g.shape[1], g.shape[2], win_size,
                      ctypes.c_double(c1), ctypes.c_double(c2),
                      ctypes.c_double(cov_norm), _ptr(out, ctypes.c_double))
    return float(out[0]), float(out[1]), int(out[2])


def err_stats(a: np.ndarray, b: np.ndarray):
    """(mse, mae) of two same-shape arrays in one native float64 pass, or
    None when the native library is unavailable."""
    a = np.asarray(a)
    b = np.asarray(b)
    lib = get_native()
    if lib is None or a.shape != b.shape:  # numpy path broadcasts; we don't
        return None
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    out = np.zeros((2,), np.float64)
    lib.err_stats(_ptr(a, ctypes.c_double), _ptr(b, ctypes.c_double),
                  a.size, _ptr(out, ctypes.c_double))
    return float(out[0]), float(out[1])
