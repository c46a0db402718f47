# Frozen copy of the plain parts of afcm_tpu_torch/models/__init__.py,
# models/gan_model.py, models/losses.py and models/train_state.py at commit
# 9498692: the builders, the train step (no data or tensor parallelism, no
# style mixing), the losses with R1, Adam and the EMA.
"""The conditional GAN of the reference: networks from a config tree, the
eval forward and one training step (D phase with R1 through the blur, D
update, G phase through the updated D, G update, EMA)."""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nn import CoModDiscriminator, CoModGenerator, Stylegan3Generator
from .ops import gaussian_blur2d

_SG3_SYNTH_KEYS = {
    "channel_base", "channel_max", "num_layers", "num_critical",
    "first_cutoff", "first_stopband", "last_stopband_rel", "margin_size",
    "output_scale", "dropout_rate", "skip_resolution", "cond_mod",
    "conv_kernel", "filter_size", "lrelu_upsampling", "use_radial_filters",
    "conv_clamp", "compute_dtype",
}
_COMOD_SYNTH_KEYS = {
    "channel_base", "channel_max", "dropout_rate", "skip_resolution",
    "channel_attention", "resample_filter", "architecture", "conv_clamp",
    "cond_mod",
}
_GENERATORS = {"stylegan3": (Stylegan3Generator, _SG3_SYNTH_KEYS),
               "comodgan": (CoModGenerator, _COMOD_SYNTH_KEYS)}


def build_generator(g_cfg: Dict[str, Any], compute_dtype: str = "float32",
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """Generator from a ``model.G`` config dict; a StyleGAN3 G computes its
    conv stack in ``compute_dtype``, a CoModGAN G in float32."""
    g_cfg = dict(g_cfg)
    net_g = g_cfg.pop("netG")
    cls, keys = _GENERATORS[net_g]
    raw = dict(g_cfg.get("synthesis_kwargs") or {})
    synthesis_kwargs = {k: v for k, v in raw.items() if k in keys}
    mapping_kwargs = dict(g_cfg.get("mapping_kwargs") or {})
    if net_g == "stylegan3":
        synthesis_kwargs["compute_dtype"] = compute_dtype
        mapping_kwargs = {k: v for k, v in mapping_kwargs.items()
                          if k in ("num_layers", "lr_multiplier", "w_avg_beta")}
    return cls(
        z_dim=g_cfg["z_dim"], c_dim=g_cfg["c_dim"], w_dim=g_cfg["w_dim"],
        img_resolution=g_cfg["img_resolution"],
        img_channels_in=g_cfg["img_channels_in"],
        img_channels_out=g_cfg["img_channels_out"],
        mapping_kwargs=mapping_kwargs, synthesis_kwargs=synthesis_kwargs,
        generator=generator)


def build_discriminator(d_cfg: Dict[str, Any], compute_dtype: str = "float32",
                        generator: Optional[torch.Generator] = None) -> nn.Module:
    """Discriminator from a ``model.D`` config dict."""
    d_cfg = dict(d_cfg)
    if d_cfg.pop("netD") != "comodgan":
        raise NotImplementedError("the reference holds the CoModGAN D only")
    return CoModDiscriminator(
        c_dim=d_cfg.get("c_dim", 0),
        img_resolution=d_cfg["img_resolution"],
        img_channels=d_cfg["img_channels"],
        channel_base=d_cfg.get("channel_base", 32768),
        channel_max=d_cfg.get("channel_max", 512),
        conv_clamp=d_cfg.get("conv_clamp"),
        cmap_dim=d_cfg.get("cmap_dim"),
        mapping_kwargs=dict(d_cfg.get("mapping_kwargs") or {}),
        epilogue_kwargs=dict(d_cfg.get("epilogue_kwargs") or {}),
        compute_dtype=compute_dtype, generator=generator)


def eval_forward(generator: nn.Module, c_dim: int, cond_img, slice_idx, z):
    """A generator in eval mode with const noise, c taken from slice_idx."""
    if c_dim > 0:
        c = slice_idx.reshape(-1, c_dim)
    else:
        c = torch.zeros((cond_img.shape[0], 1), device=cond_img.device)
    return generator(z, c, cond_img, train=False, noise_mode="const")


# -- losses -------------------------------------------------------------------

def softplus_d_loss(fake_logits, real_logits):
    return F.softplus(fake_logits).mean(), F.softplus(-real_logits).mean()


def softplus_g_loss(fake_logits):
    return F.softplus(-fake_logits).mean()


def r1_penalty(real_logits, real_img):
    """0.5 * E[ ||∇_x D(x)||² ] on real images, through the blur."""
    (grads,) = torch.autograd.grad(real_logits.sum(), real_img, create_graph=True)
    return 0.5 * torch.square(grads).sum(dim=(1, 2, 3)).mean()


def blur_sigma_schedule(cur_nimg: float, blur_init_sigma: float,
                        blur_fade_kimg: float) -> float:
    if blur_fade_kimg <= 0 or blur_init_sigma <= 0:
        return 0.0
    return max(1.0 - float(cur_nimg) / (blur_fade_kimg * 1e3), 0.0) * blur_init_sigma


def ema_beta(batch_size: int, ema_kimgs: float, ramp: Optional[float],
             cur_nimg: float) -> float:
    ema_nimg = ema_kimgs * 1000.0
    if ramp is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ramp)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(module_ema: nn.Module, module: nn.Module, beta: float) -> None:
    for p_ema, p in zip(module_ema.parameters(), module.parameters()):
        p_ema.copy_(p + (p_ema - p) * beta)
    for b_ema, b in zip(module_ema.buffers(), module.buffers()):
        b_ema.copy_(b)


class GAN:
    """G, D, G_ema and the two Adam optimizers of a config tree, trained by
    ``train_step`` as the port's ``GANModel`` trains them on one device."""

    def __init__(self, cfg: Dict[str, Any], generator: nn.Module,
                 discriminator: nn.Module):
        self.cfg = cfg
        g_cfg = cfg["model"]["G"]
        self.z_dim, self.c_dim = g_cfg.get("z_dim", 512), g_cfg.get("c_dim", 0)
        self.batch_size = cfg["loaders"]["batch_size"]
        self.combine_ab = cfg["model"]["combine_ab"]
        loss = cfg["loss"]
        self.lambda_l1, self.lambda_r1 = loss["lambda_L1"], loss["lambda_r1"]
        self.r1_interval = int(loss.get("r1_interval", 1))
        self.blur_init_sigma = loss.get("blur_init_sigma", 0.0)
        self.blur_fade_kimg = loss.get("blur_fade_kimg", 0.0)
        self.blur_max_radius = int(np.floor(self.blur_init_sigma * 3.0))
        ema = cfg["scheduler"]["ema"]
        self.ema_enabled, self.ema_kimgs = ema["enabled"], ema["ema_kimgs"]
        self.ema_ramp = None if ema["ramp"] in (None, "None") else ema["ramp"]
        self.shared_g_fwd = bool(cfg["tpu"].get("shared_g_fwd", False))
        self.generator = generator
        self.discriminator = discriminator
        self.generator_ema = copy.deepcopy(generator).requires_grad_(False)
        opt = cfg["optimizer"]
        self.opt_G = torch.optim.Adam(generator.parameters(), lr=opt["lr_G"],
                                      betas=(0.0, 0.99), eps=1e-8)
        self.opt_D = torch.optim.Adam(discriminator.parameters(), lr=opt["lr_D"],
                                      betas=(0.0, 0.99), eps=1e-8)

    def with_lr(self, lr_g: float, lr_d: float) -> None:
        for opt, lr in ((self.opt_G, lr_g), (self.opt_D, lr_d)):
            for group in opt.param_groups:
                group["lr"] = float(lr)

    def _cond(self, batch):
        if self.c_dim > 0:
            return batch["slice_idx"].reshape(-1, self.c_dim)
        return torch.zeros((batch["A"].shape[0], 1), device=batch["A"].device)

    def _d_input(self, a, b):
        return torch.cat([a, b], dim=1) if self.combine_ab else b

    def _blur(self, img, sigma):
        if self.blur_max_radius <= 0:
            return img
        return gaussian_blur2d(img, sigma, max_radius=self.blur_max_radius)

    def _run_d(self, img, c, sigma):
        return self.discriminator(self._blur(img, sigma), c)

    def train_step(self, batch: Dict[str, torch.Tensor], cur_nimg: float,
                   with_r1: bool, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One D + G + EMA step; z and the train-mode draws come from
        ``generator`` in the port's order."""
        gen, disc = self.generator, self.discriminator
        real_a, real_b = batch["A"], batch["B"]
        c = self._cond(batch)
        z = torch.randn((real_a.shape[0], self.z_dim), generator=generator,
                        device=real_a.device)
        sigma = blur_sigma_schedule(cur_nimg, self.blur_init_sigma, self.blur_fade_kimg)
        params_g = list(gen.parameters())
        params_d = list(disc.parameters())

        def run_g():
            return gen(z, c, real_a, ref_img=real_b, train=True, generator=generator)

        if self.shared_g_fwd:
            fake_shared = run_g()
            fake_d = fake_shared.detach()
        else:
            with torch.no_grad():
                fake_d = run_g()
        real_ab = self._d_input(real_a, real_b)
        r1_on = self.lambda_r1 > 0 and with_r1
        if r1_on:
            real_ab = real_ab.detach().requires_grad_(True)
        fake_logits = self._run_d(self._d_input(real_a, fake_d), c, sigma)
        real_logits = self._run_d(real_ab, c, sigma)
        loss_d_fake, loss_d_real = softplus_d_loss(fake_logits, real_logits)
        loss_d = loss_d_fake + loss_d_real
        loss_r1 = torch.zeros((), device=real_a.device)
        if r1_on:
            loss_r1 = r1_penalty(real_logits, real_ab)
            loss_d = loss_d + loss_r1 * self.lambda_r1 * max(1, self.r1_interval)
        self._step(self.opt_D, params_d, loss_d)

        fake_b = fake_shared if self.shared_g_fwd else run_g()
        gen_logits = self._run_d(self._d_input(real_a, fake_b), c, sigma)
        loss_g_gan = softplus_g_loss(gen_logits)
        loss_g_l1 = torch.mean(torch.abs(self._blur(fake_b, sigma)
                                         - self._blur(real_b, sigma))) * self.lambda_l1
        self._step(self.opt_G, params_g, loss_g_gan + loss_g_l1)

        if self.ema_enabled:
            beta = ema_beta(self.batch_size, self.ema_kimgs, self.ema_ramp, cur_nimg)
            ema_update(self.generator_ema, gen, beta)
        return {"G_GAN": loss_g_gan.detach(), "G_L1": loss_g_l1.detach(),
                "D_real": loss_d_real.detach(), "D_fake": loss_d_fake.detach(),
                "D_r1": loss_r1.detach()}

    @staticmethod
    def _step(optimizer, params, loss):
        """Gradients (zeros where a parameter does not reach the loss), the
        NaN/Inf scrub, one Adam step."""
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
            torch.nan_to_num_(p.grad, nan=0.0, posinf=1e5, neginf=-1e5)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
