"""Model registry: config -> generator, discriminator, GANModel
(``afcm_tpu/models/__init__.py``).

Two generator families: the alias-free StyleGAN3 generator (``netG:
stylegan3``) and the co-modulated StyleGAN2 generator of the CoModGAN
baseline (``netG: comodgan``). ``tpu.compute_dtype`` reaches the StyleGAN3
generator and the discriminator; the CoModGAN generator computes in float32,
as in the JAX package, whose synthesis keys for it take no compute dtype.
``build_model`` dispatches on ``model.name`` as the JAX registry does: the
two GAN families assemble a ``GANModel``, ``pix2pix`` the baseline's
``Pix2PixModel`` (UNet G, PatchGAN or PixelGAN D), which computes in float32.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from ..nn import CoModDiscriminator, CoModGenerator, Stylegan3Generator
from .gan_model import GANConfig, GANModel, StyleMix

# The generator of configs/adni/stylegan3/cmsr.yml as afcm_tpu.config
# resolves it (the shipped CMSR model; bench.py:_make_gen builds the same
# graph). chip_smoke.py builds it without yaml; tests/test_torch_generator.py
# holds it equal to the config.
CMSR_ADNI_G: Dict[str, Any] = {
    "netG": "stylegan3", "z_dim": 512, "w_dim": 512, "c_dim": 1,
    "img_resolution": 256, "img_channels_in": 4, "img_channels_out": 1,
    "synthesis_kwargs": {
        "channel_base": 16384, "channel_max": 512, "num_layers": 14,
        "num_critical": 2, "first_cutoff": 2.0,
        "first_stopband": 2 ** 2.1, "last_stopband_rel": 2 ** 0.3,
        "margin_size": 10, "output_scale": 0.25, "skip_resolution": 128,
        "conv_kernel": 3, "filter_size": 6, "lrelu_upsampling": 2,
        "use_radial_filters": False, "conv_clamp": 256,
        "magnitude_ema_beta": 0.5 ** (16 / (20 * 1e3)), "cond_mod": True},
    "mapping_kwargs": {"num_layers": 8},
}

# Synthesis keys the port's generator takes. The JAX package also takes
# channel_align (TPU layout), and magnitude_ema_beta feeds only the
# training-time EMA update.
_SG3_SYNTH_KEYS = {
    "channel_base", "channel_max", "num_layers", "num_critical",
    "first_cutoff", "first_stopband", "last_stopband_rel", "margin_size",
    "output_scale", "dropout_rate", "skip_resolution", "cond_mod",
    "conv_kernel", "filter_size", "lrelu_upsampling", "use_radial_filters",
    "conv_clamp", "compute_dtype", "remat", "remat_min_size",
}
# ``afcm_tpu/models/__init__.py:30-34``, with the synthesizer's name
_COMOD_SYNTH_KEYS = {
    "channel_base", "channel_max", "dropout_rate", "skip_resolution",
    "channel_attention", "resample_filter", "architecture", "conv_clamp",
    "cond_mod",
}
_GENERATORS = {"stylegan3": (Stylegan3Generator, _SG3_SYNTH_KEYS),
               "comodgan": (CoModGenerator, _COMOD_SYNTH_KEYS)}


def build_generator(g_cfg: Dict[str, Any],
                    generator: Optional[torch.Generator] = None):
    """Generator from a ``model.G`` config dict; random weights are drawn
    from ``generator``."""
    g_cfg = dict(g_cfg)
    net_g = g_cfg.pop("netG")
    if net_g not in _GENERATORS:
        raise NotImplementedError(f"Generator model name [{net_g}] is not recognized")
    cls, keys = _GENERATORS[net_g]
    raw = dict(g_cfg.get("synthesis_kwargs") or {})
    synthesis_kwargs = {k: v for k, v in raw.items() if k in keys}
    mapping_kwargs = dict(g_cfg.get("mapping_kwargs") or {})
    if net_g == "comodgan":
        # the synthesizer's name picks its class; the mapper's kwargs, its
        # name included, go to CoModGenerator as they are
        if raw.get("name"):
            synthesis_kwargs["name"] = raw["name"]
    else:
        mapping_kwargs = {k: v for k, v in mapping_kwargs.items()
                          if k in ("num_layers", "lr_multiplier", "w_avg_beta")}
    return cls(
        z_dim=g_cfg["z_dim"], c_dim=g_cfg["c_dim"], w_dim=g_cfg["w_dim"],
        img_resolution=g_cfg["img_resolution"],
        img_channels_in=g_cfg["img_channels_in"],
        img_channels_out=g_cfg["img_channels_out"],
        mapping_kwargs=mapping_kwargs, synthesis_kwargs=synthesis_kwargs,
        generator=generator)


def build_discriminator(d_cfg: Dict[str, Any],
                        generator: Optional[torch.Generator] = None):
    """Discriminator from a ``model.D`` config dict
    (``afcm_tpu/models/__init__.py:61-76``)."""
    d_cfg = dict(d_cfg)
    net_d = d_cfg.pop("netD")
    if net_d != "comodgan":
        raise NotImplementedError(
            f"Discriminator model name [{net_d}] is not recognized")
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
        compute_dtype=d_cfg.get("compute_dtype", "float32"),
        generator=generator)


def _with_compute_dtype(g_cfg: Dict[str, Any], compute_dtype: str) -> Dict[str, Any]:
    """``g_cfg`` with ``compute_dtype`` in the synthesis kwargs of the
    StyleGAN3 generator; a CoModGAN generator's config is returned as it is
    (its G stays float32, ``afcm_tpu/models/__init__.py:99-110``)."""
    g_cfg = dict(g_cfg)
    if g_cfg.get("netG") == "stylegan3":
        g_cfg["synthesis_kwargs"] = dict(g_cfg.get("synthesis_kwargs") or {},
                                         compute_dtype=compute_dtype)
    return g_cfg


def check_model_name(cfg) -> None:
    """The model families: StyleGAN3, CoModGAN and the pix2pix baseline,
    which the volumetric entry points refuse (``evaluate.ensure_volumetric``)."""
    name = getattr(cfg.model, "name", "stylegan3")
    if name not in ("stylegan3", "comodgan", "pix2pix"):
        raise NotImplementedError(f"model name [{name}] is not recognized")


def build_model(cfg, generator: Optional[torch.Generator] = None):
    """Top-level model factory (``afcm_tpu/models/__init__.py:86-99``):
    ``stylegan3`` and ``comodgan`` assemble the co-modulated ``GANModel``,
    ``pix2pix`` the baseline conditional GAN. Random weights are drawn from
    ``generator``."""
    check_model_name(cfg)
    if getattr(cfg.model, "name", "stylegan3") == "pix2pix":
        from .pix2pix_model import build_pix2pix_model
        return build_pix2pix_model(cfg, generator=generator)
    return build_gan_model(cfg, generator=generator)


def build_gan_model(cfg, generator: Optional[torch.Generator] = None) -> GANModel:
    """GANModel from a full config tree, as ``afcm_tpu/models/__init__.py:93-139``
    assembles it: ``tpu.compute_dtype`` drives D and the StyleGAN3 G, G_ema
    starts as a copy of G. Random weights are drawn from ``generator``."""
    check_model_name(cfg)
    compute_dtype = cfg.tpu.compute_dtype
    g_cfg = _with_compute_dtype(cfg.model.G, compute_dtype)
    if g_cfg.get("netG") == "stylegan3" and cfg.tpu.get("remat", False):
        # tpu.remat trains with rematerialization (afcm_tpu/models/__init__.py:103-107)
        g_cfg["synthesis_kwargs"] = dict(
            g_cfg["synthesis_kwargs"], remat=True,
            remat_min_size=int(cfg.tpu.get("remat_min_size", 0) or 0))
    d_cfg = dict(cfg.model.D)
    d_cfg.setdefault("compute_dtype", compute_dtype)
    net_g = build_generator(g_cfg, generator=generator)
    net_d = build_discriminator(d_cfg, generator=generator)
    ema = cfg.scheduler.ema
    config = GANConfig(
        z_dim=g_cfg.get("z_dim", 512), c_dim=g_cfg.get("c_dim", 0),
        batch_size=cfg.loaders.batch_size, combine_ab=cfg.model.combine_ab,
        lambda_l1=cfg.loss.lambda_L1, lambda_r1=cfg.loss.lambda_r1,
        r1_interval=int(cfg.loss.get("r1_interval", 1)),
        lr_g=cfg.optimizer.lr_G, lr_d=cfg.optimizer.lr_D,
        ema_enabled=ema.enabled, ema_kimgs=ema.ema_kimgs,
        # the reference YAMLs write `ramp: None`, which YAML reads as a string
        ema_ramp=None if ema.ramp in (None, "None") else ema.ramp,
        blur_init_sigma=getattr(cfg.loss, "blur_init_sigma", 0.0),
        blur_fade_kimg=getattr(cfg.loss, "blur_fade_kimg", 0.0),
        shared_g_fwd=bool(cfg.tpu.get("shared_g_fwd", False)))
    return GANModel(config, copy.deepcopy(net_g), net_g, net_d)


def build_eval_model(g_cfg: Dict[str, Any], compute_dtype: str = "float32",
                     generator: Optional[torch.Generator] = None) -> GANModel:
    """Inference GANModel: only the EMA generator, built from ``g_cfg``
    (a StyleGAN3 G in ``compute_dtype``, the config's ``tpu.compute_dtype``;
    a CoModGAN G in float32)."""
    g_cfg = _with_compute_dtype(g_cfg, compute_dtype)
    config = GANConfig(z_dim=g_cfg.get("z_dim", 512), c_dim=g_cfg.get("c_dim", 0))
    return GANModel(config, build_generator(g_cfg, generator=generator))


__all__ = ["CMSR_ADNI_G", "GANConfig", "GANModel", "build_discriminator",
           "build_eval_model", "build_gan_model", "build_generator",
           "build_model", "check_model_name", "StyleMix"]
