"""GAN objectives (``afcm_tpu/models/losses.py``): those of the StyleGAN3
and CoModGAN training step, and the pix2pix baseline's (``gan_loss``,
``cal_gradient_penalty``) with the segmentation losses beside them.

R1 differentiates the discriminator's logits with respect to its real input
with ``create_graph=True``, through the blur, and the D loss then
differentiates that gradient again: double backward through plain torch
ops only (the discriminator has no hand-written kernel).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from .. import parallel


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


def gan_loss(mode: str, logits, target_is_real: bool):
    """pix2pix-style GAN objectives (``:44-55``; reference:
    models/utils.py:213-279): ``vanilla`` is the mean binary cross-entropy
    of the logits against all-ones or all-zeros."""
    if mode == "vanilla":
        target = torch.ones_like(logits) if target_is_real else torch.zeros_like(logits)
        return F.binary_cross_entropy_with_logits(logits, target)
    if mode == "lsgan":
        return torch.square(logits - (1.0 if target_is_real else 0.0)).mean()
    if mode == "wgangp":
        return -logits.mean() if target_is_real else logits.mean()
    raise NotImplementedError(f"gan mode {mode}")


def cal_gradient_penalty(d_fn: Callable, real_data, fake_data,
                         alpha: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         mode: str = "mixed", constant: float = 1.0,
                         lambda_gp: float = 10.0):
    """WGAN-GP gradient penalty (``:57-81``; reference:
    models/utils.py:282-316): ``lambda_gp`` · E[(||∇_x D(x)|| - constant)²]
    at x between the real and the fake batch. ``alpha`` [N, 1, 1, 1], the
    interpolation weights, is drawn uniform from ``generator`` unless given.
    The gradient keeps its graph, so the penalty differentiates into D's
    parameters. Returns the penalty and the per-sample gradients [N, -1]."""
    if lambda_gp <= 0:
        return torch.zeros((), device=real_data.device), None
    if mode == "real":
        interp = real_data
    elif mode == "fake":
        interp = fake_data
    elif mode == "mixed":
        if alpha is None:
            alpha = parallel.rand((real_data.shape[0],) + (1,) * (real_data.dim() - 1),
                                  generator, real_data.device)
        interp = alpha * real_data + (1 - alpha) * fake_data
    else:
        raise NotImplementedError(mode)
    interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp, create_graph=True)
    grads = grads.reshape(real_data.shape[0], -1)
    norms = torch.linalg.vector_norm(grads + 1e-16, dim=1)
    return torch.square(norms - constant).mean() * lambda_gp, grads


def dice_loss_1class(pred_logits, target, smooth: float = 0.01):
    """Binary dice on the thresholded sigmoid (``:83-95``; reference:
    models/utils.py:349-370)."""
    n = target.shape[0]
    pred = (torch.sigmoid(pred_logits) > 0.5).float().reshape(n, -1)
    target = target.reshape(n, -1).float()
    rev_p, rev_t = 1 - pred, 1 - target
    inter1 = (pred * target).sum(1)
    inter2 = (rev_p * rev_t).sum(1)
    loss = (2 * (inter1 + inter2) + smooth) / (
        pred.sum(1) + rev_p.sum(1) + target.sum(1) + rev_t.sum(1) + smooth)
    return 1 - loss.sum() / n


def bce_dice_loss(pred_logits, target, alpha: float = 1.0, beta: float = 1.0):
    """Linear BCE + dice combination (``:98-102``; reference:
    models/utils.py:373-385)."""
    bce = F.binary_cross_entropy_with_logits(pred_logits, target.float())
    return alpha * bce + beta * dice_loss_1class(pred_logits, target)


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
