"""GAN objectives of the StyleGAN3 training step (``afcm_tpu/models/losses.py``).

R1 differentiates the discriminator's logits with respect to its real input
with ``create_graph=True``, through the blur, and the D loss then
differentiates that gradient again: double backward through plain torch
ops only (the discriminator has no hand-written kernel).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F


def softplus_d_loss(fake_logits, real_logits):
    """Non-saturating D loss: mean softplus(D(fake)), mean softplus(-D(real))."""
    return F.softplus(fake_logits).mean(), F.softplus(-real_logits).mean()


def softplus_g_loss(fake_logits):
    return F.softplus(-fake_logits).mean()


def r1_penalty(real_logits, real_img):
    """0.5 * E[ ||∇_x D(x)||² ] on real images (``:26-37``).

    ``real_logits`` must come from ``real_img`` (which requires grad) through
    the discriminator and any blur in front of it, so the gradient is taken
    w.r.t. the pre-blur input, as the reference does
    (comodgan_model.py:139-146). The JAX function runs D again inside
    ``jax.grad``; here the D-loss forward's logits are reused, which is the
    same value."""
    (grads,) = torch.autograd.grad(real_logits.sum(), real_img,
                                   create_graph=True)
    return 0.5 * torch.square(grads).sum(dim=(1, 2, 3)).mean()


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def nan_to_num_grads(params: Iterable[torch.Tensor]) -> None:
    """Per-step gradient scrubbing in place: NaN -> 0, ±Inf -> ±1e5
    (reference: comodgan_model.py:170-182)."""
    for p in params:
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=1e5, neginf=-1e5)


def blur_sigma_schedule(cur_nimg: float, blur_init_sigma: float,
                        blur_fade_kimg: float) -> float:
    """Progressive blur fade (reference: stylegan3_model.py:115-116), on the
    host: ``cur_nimg`` is the train loop's image count."""
    if blur_fade_kimg <= 0 or blur_init_sigma <= 0:
        return 0.0
    return max(1.0 - float(cur_nimg) / (blur_fade_kimg * 1e3), 0.0) * blur_init_sigma
