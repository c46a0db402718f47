"""Image quality metrics (PSNR / SSIM / MAE).

scikit-image is not available in this environment, so `psnr` and `ssim`
reimplement `skimage.metrics.peak_signal_noise_ratio` /
`structural_similarity` semantics exactly as the reference uses them
(reference: util/evaluation.py): uniform 7^n window, sample covariance
normalization, K1=0.01/K2=0.03, and the skimage convention that float images
without an explicit data_range use range 2 (the [-1, 1] dtype range) — the
reference relies on that quirk, so parity requires it.

The evaluate_* entry points mirror util/evaluation.py:92-127 one-for-one.

The port's own copy of ``afcm_tpu/utils/metrics.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import uniform_filter


def _default_data_range(im_true: np.ndarray) -> float:
    if np.issubdtype(im_true.dtype, np.integer):
        info = np.iinfo(im_true.dtype)
        return float(info.max - info.min)
    return 2.0  # skimage float convention: dtype range (-1, 1)


def psnr(im_true: np.ndarray, im_test: np.ndarray,
         data_range: Optional[float] = None) -> float:
    im_true = np.asarray(im_true)
    im_test = np.asarray(im_test)
    if data_range is None:
        data_range = _default_data_range(im_true)
    err = _mse(im_true, im_test)
    return float(10 * np.log10((data_range ** 2) / err))


def _err_moments(a, b):
    """(mse, mae) as np.float64 scalars — np.float64 so psnr's divide
    yields inf (not a Python ZeroDivisionError) on identical inputs, like
    the original np.mean path. One fused native pass when available."""
    from ..native import err_stats
    got = err_stats(a, b)
    if got is not None:
        return np.float64(got[0]), np.float64(got[1])
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.mean(d * d), np.mean(np.abs(d))


def _mse(a, b):
    return _err_moments(a, b)[0]


def ssim(im_true: np.ndarray, im_test: np.ndarray,
         data_range: Optional[float] = None, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> float:
    x = np.asarray(im_true, dtype=np.float64)
    y = np.asarray(im_test, dtype=np.float64)
    assert x.shape == y.shape
    if min(x.shape) < win_size:
        # Match the skimage oracle, which raises instead of silently
        # averaging an empty interior crop (NaN).
        raise ValueError(
            f"win_size {win_size} exceeds image extent {x.shape}; pass a "
            "smaller win_size")
    if data_range is None:
        data_range = _default_data_range(im_true)

    ndim = x.ndim
    np_win = win_size ** ndim
    cov_norm = np_win / (np_win - 1)

    # Fused native path (native/window_ops.cpp:ssim_mean): same
    # uniform-filter/reflect/sample-covariance math in one C++ sweep —
    # ~10x the numpy composition on this 1-core host (the numpy path below
    # is the semantic oracle and the fallback; parity ~1e-12, pinned by
    # tests/test_native.py).
    from ..native import ssim_mean as _native_ssim
    got = _native_ssim(x, y, win_size, (k1 * data_range) ** 2,
                       (k2 * data_range) ** 2, cov_norm)
    if got is not None:
        return got

    filt = lambda im: uniform_filter(im, size=win_size)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    sl = tuple(slice(pad, dim - pad) for dim in s.shape)
    return float(np.mean(s[sl]))


def mae(a, b) -> float:
    return float(_err_moments(a, b)[1])


# -- reference evaluate_* API (util/evaluation.py) ---------------------------


def psnr_2d(g_img, l_img) -> float:
    """Max-normalized 2-D PSNR (reference: evaluation.py:31-37)."""
    l_img = np.squeeze(np.asarray(l_img))
    g_img = np.squeeze(np.asarray(g_img))
    return psnr(l_img / l_img.max(), g_img / g_img.max())


def evaluate_2D(g_img, l_img) -> Optional[Tuple[float, float, float]]:
    """Per-sample PSNR/SSIM means over a batch, skipping empty targets
    (reference: evaluation.py:92-104)."""
    c_psnr = c_ssim = c_mse = 0.0
    count = 0
    g_img = np.asarray(g_img)
    l_img = np.asarray(l_img)
    for i in range(g_img.shape[0]):
        if np.max(l_img[i]) <= 0:
            continue
        c_psnr += psnr_2d(g_img[i][0], l_img[i][0])
        c_ssim += ssim(np.squeeze(l_img[i][0]), np.squeeze(g_img[i][0]))
        c_mse += float(np.mean(np.abs(l_img - g_img)))
        count += 1
    if count == 0:
        return None
    return c_psnr / count, c_ssim / count, c_mse / count


def evaluate_3D(g_img, l_img) -> Tuple[float, float, float]:
    """(reference: evaluation.py:123-127)"""
    l_img = np.asarray(l_img)
    g_img = np.asarray(g_img)
    mse_v, mae_v = _err_moments(l_img, g_img)  # one fused pass for both
    data_range = _default_data_range(l_img)
    return (float(10 * np.log10((data_range ** 2) / mse_v)),
            ssim(l_img, g_img), float(mae_v))


def threed_psnr(g_img, l_img) -> float:
    """Tri-axial per-slice PSNR average (reference: evaluation.py:40-68)."""
    g_img = np.asarray(g_img)
    l_img = np.asarray(l_img)
    c_psnr = 0.0
    done = 0
    for axis in range(3):
        for i in range(g_img.shape[axis]):
            t_l = np.squeeze(np.take(l_img, i, axis=axis))
            t_g = np.squeeze(np.take(g_img, i, axis=axis))
            d_range = float(max(t_l.max(), t_g.max()) -
                            min(t_l.min(), t_g.min()))
            if d_range == 0:
                c_psnr += c_psnr / (done + 1)
            else:
                c_psnr += psnr(t_l, t_g, data_range=d_range)
            done += 1
    return c_psnr / sum(g_img.shape)


def threed_ssim(g_img, l_img) -> float:
    """Tri-axial per-slice SSIM average (reference: evaluation.py:6-18)."""
    g_img = np.asarray(g_img)
    l_img = np.asarray(l_img)
    c_ssim = 0.0
    for axis in range(3):
        for i in range(g_img.shape[axis]):
            c_ssim += ssim(np.squeeze(np.take(l_img, i, axis=axis)),
                           np.squeeze(np.take(g_img, i, axis=axis)))
    return c_ssim / sum(g_img.shape)


def evaluate_one(g_img, l_img) -> Tuple[float, float, float]:
    """Tri-axial PSNR/SSIM + MAE (reference: evaluation.py:107-114)."""
    return threed_psnr(g_img, l_img), threed_ssim(g_img, l_img), mae(l_img, g_img)


def threed_slice_psnr(g_img, l_img) -> float:
    c_psnr = 0.0
    count = 0
    for i in range(l_img.shape[0]):
        if np.max(l_img[i]) <= 0:
            continue
        t_l = np.squeeze(l_img[i])
        t_g = np.squeeze(g_img[i])
        c_psnr += psnr(t_l / t_l.max(), t_g / t_g.max())
        count += 1
    return c_psnr / count


def threed_slice_ssim(g_img, l_img) -> float:
    c_ssim = 0.0
    count = 0
    for i in range(l_img.shape[0]):
        if np.max(l_img[i]) <= 0:
            continue
        c_ssim += ssim(l_img[i], g_img[i])
        count += 1
    return c_ssim / count


def evaluate_slice(g_img, l_img) -> Tuple[float, float, float]:
    """Axis-0 per-slice means (reference: evaluation.py:116-121).

    One fused native pass over the volume when available (window_ops.cpp
    slice_metrics — the own-max PSNR normalization, data-range-2 constants
    and empty-target skip in C++, ~2x the per-slice Python loops below on
    this 1-core host; parity ~1e-12, pinned by tests/test_native.py)."""
    g_img = np.asarray(g_img)
    l_img = np.asarray(l_img)
    if g_img.ndim == 3 and np.issubdtype(l_img.dtype, np.floating) \
            and np.issubdtype(g_img.dtype, np.floating):
        from ..native import slice_metrics as _native_slice
        win = 7
        np_win = win * win
        dr = 2.0  # float slices: the skimage data-range-2 convention
        got = _native_slice(g_img, l_img, win, (0.01 * dr) ** 2,
                            (0.03 * dr) ** 2, np_win / (np_win - 1))
        if got is not None:
            return got[0], got[1], mae(l_img, g_img)
    return (threed_slice_psnr(g_img, l_img), threed_slice_ssim(g_img, l_img),
            mae(l_img, g_img))


def dice_one(pred, target, eps: float = 1e-8) -> float:
    pred = np.asarray(pred).astype(float)
    target = np.asarray(target)
    intersection = pred * target
    return float((2 * intersection.sum() + eps) /
                 (pred.sum() + target.sum() + eps))
