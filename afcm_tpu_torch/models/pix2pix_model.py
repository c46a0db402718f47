"""The pix2pix baseline model: one D + G step with the classic objectives
(``afcm_tpu/models/pix2pix_model.py``; reference: models/pix2pix_model.py).

The GAN objective is configurable (vanilla | lsgan | wgangp, reference:
models/utils.py:213-316), both optimizers are Adam(beta1, 0.999, eps 1e-8),
and the UNet's and the PatchGAN's batch-norm running statistics are the
networks' buffers. The step follows the JAX step (``:101-163``) phase for
phase, and moves the statistics where it does:

- G's statistics move twice: in the gradient-free forward that makes the D
  phase's fake, then in the G phase's forward, which starts from them;
- D's move on the fake batch, then on the real batch; the gradient penalty
  runs D in eval mode on those statistics, and its gradient reaches D's
  parameters through them too, as ``jax.value_and_grad`` of the JAX
  step's D loss differentiates them (``nn.pix2pix.differentiable_statistics``);
  the D forward inside G's loss runs in train mode on batch statistics and
  moves nothing;
- D steps before G, and G's loss sees the updated D.

The JAX package compiles the step over an immutable state; here PyTorch
runs it eagerly and updates the modules and the Adam states in place. Its
random draws (the two forwards' dropout, the penalty's interpolation)
come from the ``torch.Generator`` the caller hands over, or are given
(``dropout_masks``, ``gp_alpha``), which is how the tests pass flax's.
The networks compute in float32 whatever ``tpu.compute_dtype`` says, as in
the JAX package.

Data parallel (``distribute``), as ``GANModel``'s step: the draws and the
given masks and ``gp_alpha`` are the global batch's, sliced; the batch
norms take the global batch's statistics; each net's gradient is averaged
over the ranks in one flat all-reduce; the losses are the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import parallel
from ..nn.pix2pix import (NLayerDiscriminator, PixelDiscriminator, UnetGenerator,
                          differentiable_statistics)
from . import losses
from .gan_model import global_metrics
from .train_state import make_optimizer, with_lr

Masks = Optional[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    """``afcm_tpu/models/pix2pix_model.py:24-33``, same fields and defaults."""

    gan_mode: str = "vanilla"
    lambda_l1: float = 100.0
    lambda_gp: float = 0.0        # wgangp gradient penalty weight
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    beta1: float = 0.5
    combine_ab: bool = True


class Pix2PixModel:
    """The UNet generator and the discriminator with their optimizers."""

    def __init__(self, generator: UnetGenerator, discriminator: nn.Module,
                 config: Pix2PixConfig):
        self.generator = generator
        self.discriminator = discriminator
        self.config = config
        self.step = 0
        self.group: Optional[parallel.DataGroup] = None
        self.opt_G = make_optimizer(generator.parameters(), config.lr_g, config.beta1,
                                    0.999, 1e-8)
        self.opt_D = make_optimizer(discriminator.parameters(), config.lr_d,
                                    config.beta1, 0.999, 1e-8)

    def to(self, device) -> "Pix2PixModel":
        """Move both networks (and so the optimizers' parameters) to device."""
        self.generator.to(device)
        self.discriminator.to(device)
        return self

    def with_lr(self, lr_g: float, lr_d: float) -> None:
        with_lr(self.opt_G, lr_g)
        with_lr(self.opt_D, lr_d)

    def distribute(self, group: Optional[parallel.DataGroup]) -> None:
        """Train as one rank of ``group`` (None: alone)."""
        self.group = group
        parallel.attach(self.generator, group)
        parallel.attach(self.discriminator, group)

    def _d_input(self, a, b):
        return torch.cat([a, b], dim=1) if self.config.combine_ab else b

    def train_step(self, batch: Dict[str, torch.Tensor], cur_nimg: Optional[float] = None,
                   generator: Optional[torch.Generator] = None,
                   dropout_masks: Tuple[Masks, Masks] = (None, None),
                   gp_alpha: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One D + G step on ``batch`` ({"A", "B"} on the model's device).
        ``cur_nimg`` is accepted for the train loop's shared call and unused
        (pix2pix has no schedule in the image count). ``dropout_masks`` holds
        the keep masks of the D phase's and the G phase's forwards, per
        ``mid{i}`` level; ``gp_alpha`` [N, 1, 1, 1] the penalty's
        interpolation; what is not given is drawn from ``generator``.
        Returns the losses as 0-d tensors, left on the device."""
        del cur_nimg
        cfg = self.config
        gen, disc = self.generator, self.discriminator
        real_a, real_b = batch["A"], batch["B"]
        masks_d, masks_g = dropout_masks
        group = self.group
        if group is not None:
            masks_d, masks_g = ({k: group.local(v) for k, v in m.items()}
                                if m is not None else None for m in (masks_d, masks_g))
            gp_alpha = group.local(gp_alpha)
            if generator is not None:
                generator = parallel.GlobalDraws(generator, group)

        # ---- D phase: G's gradient-free forward moves G's statistics ----
        with torch.no_grad():
            fake_b = gen(real_a, train=True, dropout_masks=masks_d, generator=generator)
        fake_ab = self._d_input(real_a, fake_b)
        real_ab = self._d_input(real_a, real_b)
        with differentiable_statistics(disc):
            loss_d_fake = losses.gan_loss(cfg.gan_mode, disc(fake_ab), False)
            loss_d_real = losses.gan_loss(cfg.gan_mode, disc(real_ab), True)
            loss_d = (loss_d_fake + loss_d_real) * 0.5
            if cfg.gan_mode == "wgangp" and cfg.lambda_gp > 0:
                # the statistics just moved, frozen (eval mode), for the
                # interpolate pass, ``:126-133``
                gp, _ = losses.cal_gradient_penalty(
                    lambda x: disc(x, train=False), real_ab, fake_ab, alpha=gp_alpha,
                    generator=generator, lambda_gp=cfg.lambda_gp)
                loss_d = loss_d + gp
            self._step(self.opt_D, disc, loss_d)

        # ---- G phase, through the updated D ----
        fake = gen(real_a, train=True, dropout_masks=masks_g, generator=generator)
        pred_fake = disc(self._d_input(real_a, fake), train=True, update_stats=False)
        loss_g_gan = losses.gan_loss(cfg.gan_mode, pred_fake, True)
        loss_g_l1 = losses.l1_loss(fake, real_b) * cfg.lambda_l1
        self._step(self.opt_G, gen, loss_g_gan + loss_g_l1)
        self.step += 1
        metrics = {"G_GAN": loss_g_gan, "G_L1": loss_g_l1, "D_real": loss_d_real,
                   "D_fake": loss_d_fake}
        return global_metrics(metrics, group)

    def _step(self, optimizer, net: nn.Module, loss) -> None:
        """Gradients of ``loss`` w.r.t. ``net``'s parameters only, averaged
        over the ranks, one Adam step."""
        params = list(net.parameters())
        grads = list(torch.autograd.grad(loss, params))
        if self.group is not None:
            self.group.average_(grads, "grads")
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def eval_step(self, a, slice_idx=None, generator: Optional[torch.Generator] = None,
                  ref_img=None):
        """G on the running statistics, no dropout (``:164-170``); the other
        arguments are accepted for the train loop's shared validate call."""
        del slice_idx, generator, ref_img
        with torch.inference_mode():
            return self.generator(a, train=False)


def build_pix2pix_model(cfg, generator: Optional[torch.Generator] = None
                        ) -> Pix2PixModel:
    """``afcm_tpu/models/pix2pix_model.py:build_pix2pix_model``: unet_256 or
    unet_128, a basic / n_layers or pixel D, from the config's ``model``,
    ``loss`` and ``optimizer``. Random weights are drawn from ``generator``."""
    g_cfg = dict(cfg.model.G)
    d_cfg = dict(cfg.model.D)
    net_g = g_cfg.get("netG", "unet_256")
    if net_g not in ("unet_256", "unet_128"):
        raise NotImplementedError(f"pix2pix generator {net_g}")
    net = UnetGenerator(
        input_nc=g_cfg.get("input_nc", 1), output_nc=g_cfg.get("output_nc", 1),
        num_downs=8 if net_g == "unet_256" else 7, ngf=g_cfg.get("ngf", 64),
        norm=g_cfg.get("norm", "batch"), use_dropout=g_cfg.get("dropout", True),
        init_type=g_cfg.get("init_type", "normal"),
        init_gain=g_cfg.get("init_gain", 0.02), generator=generator)
    net_d = d_cfg.get("netD", "basic")
    d_kw = dict(input_nc=d_cfg.get("input_nc", 2), ndf=d_cfg.get("ndf", 64),
                norm=d_cfg.get("norm", "batch"),
                init_type=d_cfg.get("init_type", "normal"),
                init_gain=d_cfg.get("init_gain", 0.02), generator=generator)
    if net_d in ("basic", "n_layers"):
        disc = NLayerDiscriminator(
            n_layers=3 if net_d == "basic" else d_cfg.get("n_layers", 3), **d_kw)
    elif net_d == "pixel":
        disc = PixelDiscriminator(**d_kw)
    else:
        raise NotImplementedError(f"pix2pix discriminator {net_d}")
    config = Pix2PixConfig(gan_mode=cfg.loss.gan_mode, lambda_l1=cfg.loss.lambda_L1,
                           lambda_gp=getattr(cfg.loss, "lambda_gp", 0.0),
                           lr_g=cfg.optimizer.lr_G, lr_d=cfg.optimizer.lr_D,
                           beta1=cfg.optimizer.beta1, combine_ab=cfg.model.combine_ab)
    return Pix2PixModel(net, disc, config)
