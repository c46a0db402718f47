# Frozen copy of afcm_tpu_torch/ops/filter_design.py at commit 9498692, plain PyTorch
# only: no kernel, no int8 routing, no tensor parallelism, no remat.
"""Construction-time FIR filter design for the alias-free layers (numpy).

A copy of ``afcm_tpu/ops/filter_design.py``: that module cannot be imported
without jax because ``afcm_tpu/ops/__init__.py`` imports the JAX ops.
``tests/test_torch_ops.py`` holds the two copies equal.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.special


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False):
    """Kaiser low-pass FIR: 1-D taps (separable), a 2-D [numtaps, numtaps]
    jinc filter (radial), or ``None`` for the identity (numtaps == 1)."""
    assert numtaps >= 1
    if numtaps == 1:
        return None

    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, dtype=np.float32)

    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return np.asarray(f, dtype=np.float32)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1, separable=None) -> np.ndarray:
    """Normalize and scale a FIR filter for ``upfirdn2d``. A 1-D filter with
    fewer than 8 taps becomes its 2-D outer product (reference heuristic)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2)
    assert f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = (f.ndim == 1 and f.size >= 8)
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


def filter_size(f) -> tuple:
    """Return (width, height) of a filter (None => 1x1)."""
    if f is None:
        return 1, 1
    assert 1 <= f.ndim <= 2
    return int(f.shape[-1]), int(f.shape[0])
