"""Seeded phantom volumes drawn on the device: the benchmark's traffic
generator, reading its parameters from a traffic file.

A copy of ``afcm_tpu_torch/data/demo.make_phantom`` (commit 9498692) moved
from scipy on the host to the device: smooth random anatomy inside an
ellipsoid, the FLAIR-like and T1-like modalities nonlinear transforms of
it. The Gaussian filters are separable 1-D convolutions truncated at four
sigmas with reflected edges (scipy's ``gaussian_filter`` default)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *key: int) -> int:
    """A 31-bit seed for one stream of the run, from ``--seed`` (any size)
    and a stream key: the same seed gives the same streams."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *key]
    return int(np.random.SeedSequence(words).generate_state(1)[0] & 0x7FFFFFFF)


def _blur_axis(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    radius = min(int(4.0 * sigma + 0.5), x.shape[axis] - 1)
    t = torch.arange(-radius, radius + 1, device=x.device, dtype=torch.float32)
    taps = torch.exp(-0.5 * (t / sigma) ** 2)
    taps = taps / taps.sum()
    x = x.movedim(axis, -1)
    shape = x.shape
    flat = x.reshape(-1, 1, shape[-1])
    flat = F.pad(flat, (radius, radius), mode="reflect")
    flat = F.conv1d(flat, taps.view(1, 1, -1))
    return flat.reshape(shape).movedim(-1, axis)


def gaussian_filter(x: torch.Tensor, sigma) -> torch.Tensor:
    for axis, s in enumerate(sigma):
        x = _blur_axis(x, float(s), axis)
    return x


def make_phantom(depth: int, size: int, generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """uint8 [depth, size, size] volumes on ``device``: ``flair`` (the
    input) and ``t1_hr4sr`` (the high-resolution target)."""
    lin = lambda n: torch.linspace(-1, 1, n, device=device)
    z, y, x = torch.meshgrid(lin(depth), lin(size), lin(size), indexing="ij")
    r = torch.sqrt((x / 0.8) ** 2 + (y / 0.9) ** 2 + (z / 0.95) ** 2)
    skull = (r < 1.0).float()
    field = gaussian_filter(torch.randn((depth, size, size), generator=generator,
                                        device=device), (2, 8, 8))
    field = (field - field.min()) / (field.max() - field.min())
    ventricles = gaussian_filter(torch.randn((depth, size, size), generator=generator,
                                             device=device), (3, 12, 12))
    ventricles = (ventricles > ventricles.std()).float()
    t1 = skull * (60 + 150 * field + 40 * ventricles)
    flair = skull * (50 + 100 * field ** 2 + 70 * ventricles)
    return {"flair": flair.clamp(0, 255).to(torch.uint8),
            "t1_hr4sr": t1.clamp(0, 255).to(torch.uint8)}


def draw_pool(traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """The traffic's pool of ``pool`` volumes, each ``depth_min`` to
    ``depth_max`` slices deep (drawn from the seed) of ``size``^2 slices,
    made on the device and copied to the host as uint8 numpy arrays."""
    rng = np.random.RandomState(sub_seed(seed, 1))
    depths = rng.randint(traffic["depth_min"], traffic["depth_max"] + 1,
                         size=traffic["pool"])
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    pool = []
    for depth in depths:
        vols = make_phantom(int(depth), traffic["size"], gen, device)
        pool.append({k: v.cpu().numpy() for k, v in vols.items()})
    return pool
