"""The conditional-GAN model: training step and inference
(``afcm_tpu/models/gan_model.py``).

``train_step`` follows the JAX step (``:211-314``) phase for phase: the D
phase on a detached fake (softplus losses, R1 through the blur), the D
update, then the G phase through the updated D (softplus + blurred L1), the
G update, then the EMA. The JAX package compiles the step into one XLA
program over an immutable state; here PyTorch runs it eagerly and updates
the modules, the Adam states and the EMA copy in place. On CUDA tensors the
generator's forward runs kernel K1 and its backward kernel K2.

The generator's train-mode forwards draw their noise (CoModGAN) and
co-modulation dropout from the step's ``torch.Generator``; the target batch
goes to G as ``ref_img`` for the CoModGAN ``RefMappingNetwork``. A CoModGAN
G updates its mapper's ``w_avg`` in each train-mode forward, twice a step
unless the forward is shared, as the JAX step's ``moments`` do
(``:239-291``), and ``ema_update`` copies it into G_ema. The StyleGAN3 step
updates neither ``w_avg`` nor ``magnitude_ema`` (``_run_g`` passes no
``update_emas``, ``:153-156``), and neither does this.

Data parallel (``distribute``): on W ranks of a process group, each with
its contiguous slice of the global batch, the step is the single-device
step on the global batch, as ``afcm_tpu``'s sharded step is: the draws are
the global batch's, sliced (``parallel.GlobalDraws``; a given ``z`` is the
global batch's too), D's minibatch std and the mapper's ``w_avg`` take the
global batch's statistics, each net's gradient is averaged over the ranks
in one flat all-reduce before it is scrubbed, and the losses returned are
the global batch's.

Tensor parallel (``distribute`` with a model group, ``tpu.mesh_shape [D,
M]``): G, G_ema and D keep their slices of the parameters
``parallel.infer_param_sharding`` shards (``parallel/tensor.py``); the
draws are sliced by the data index, so every rank of a data row draws the
same z and masks; after each backward the gradients of the parameters
that are not sharded are reduced over the model group (the biases of
sharded layers summed, the rest averaged: ``ModelGroup.reduce_replicated_``),
then every gradient is averaged over the data group, and the losses are
averaged over the data group alone.

Style mixing (``style_mixing_prob > 0``, ``:162-192``): each train-mode G
forward maps ``z`` (updating the mapper's ``w_avg``, as the JAX step does
for both generator families) and a second latent ``z2`` (not updating it),
and with probability p takes the styles from one ``cutoff`` in
``[1, num_ws)`` on from ``z2``; ``cutoff`` and the coin are one draw for
the whole batch, the same on every rank, and ``z2`` is drawn for the global
batch. A ``StyleMix`` passes the three in, as ``z`` is passed in. The
``RefMappingNetwork`` mapper maps no latent and raises here, as the JAX
step does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..ops import gaussian_blur2d
from ..utils.profiling import span
from . import losses
from .train_state import ema_beta, ema_update, make_optimizer, with_lr


# the spans of ``GANModel._step`` per net: its backward, then its update
_STEP_SPANS = {"D": ("afcm.train.D.backward", "afcm.train.D.update"),
               "G": ("afcm.train.G.backward", "afcm.train.G.update")}


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Static training hyperparameters (``afcm_tpu/models/gan_model.py:36-83``,
    same fields and defaults)."""

    z_dim: int = 512
    c_dim: int = 0
    batch_size: int = 16
    combine_ab: bool = True
    lambda_l1: float = 100.0
    lambda_r1: float = 10.0
    r1_interval: int = 1
    lr_g: float = 0.0025
    lr_d: float = 0.002
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    ema_enabled: bool = True
    ema_kimgs: float = 10.0
    ema_ramp: Optional[float] = None
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    style_mixing_prob: float = 0.0
    shared_g_fwd: bool = False


class StyleMix(NamedTuple):
    """The draws of one style-mixing G forward: ``z2`` [N, z_dim] (of the
    global batch), ``cutoff`` in [1, num_ws) and ``coin`` (mix or not)."""

    z2: torch.Tensor
    cutoff: Union[int, torch.Tensor]
    coin: Union[bool, torch.Tensor]


def global_metrics(metrics: Dict[str, torch.Tensor],
                   group: Optional[parallel.DataGroup]) -> Dict[str, torch.Tensor]:
    """The step's losses, detached, averaged over the ranks of ``group``
    in one all-reduce: the global batch's losses."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is None:
        return metrics
    values = group.mean_(torch.stack([v.float() for v in metrics.values()]), "metrics")
    return dict(zip(metrics, values.unbind()))


def eval_forward(generator: nn.Module, c_dim: int, cond_img, slice_idx, z,
                 ref_img=None):
    """A generator in eval mode with const noise, c taken from slice_idx:
    the body of ``GANModel.eval_step``, which the serving export traces."""
    if c_dim > 0:
        c = slice_idx.reshape(-1, c_dim)
    else:
        c = torch.zeros((cond_img.shape[0], 1), device=cond_img.device)
    return generator(z, c, cond_img, ref_img=ref_img, train=False, noise_mode="const")


class GANModel:
    """The EMA generator for inference and, when ``generator`` and
    ``discriminator`` are given, the trained pair with their optimizers."""

    def __init__(self, config: GANConfig, generator_ema: nn.Module,
                 generator: Optional[nn.Module] = None,
                 discriminator: Optional[nn.Module] = None):
        self.config = config
        self.z_dim, self.c_dim = config.z_dim, config.c_dim
        self.generator_ema = generator_ema.requires_grad_(False)
        self.generator = generator
        self.discriminator = discriminator
        self.blur_max_radius = int(np.floor(config.blur_init_sigma * 3.0))
        self.step = 0
        self.group: Optional[parallel.DataGroup] = None
        self.model_group: Optional[parallel.ModelGroup] = None
        if generator is not None:
            self.opt_G = make_optimizer(generator.parameters(), config.lr_g,
                                        config.adam_beta1, config.adam_beta2,
                                        config.adam_eps)
            self.opt_D = make_optimizer(discriminator.parameters(), config.lr_d,
                                        config.adam_beta1, config.adam_beta2,
                                        config.adam_eps)

    def to(self, device) -> "GANModel":
        """Move every network (and so the optimizers' parameters) to device."""
        for net in (self.generator_ema, self.generator, self.discriminator):
            if net is not None:
                net.to(device)
        return self

    def with_lr(self, lr_g: float, lr_d: float) -> None:
        with_lr(self.opt_G, lr_g)
        with_lr(self.opt_D, lr_d)

    def distribute(self, group: Optional[parallel.DataGroup],
                   model_group: Optional[parallel.ModelGroup] = None) -> None:
        """Train as one rank of the data group ``group`` (None: alone) and,
        with a ``model_group``, shard the networks over it; the module
        docstring says what that changes."""
        self.group = group
        parallel.attach(self.generator, group)
        parallel.attach(self.discriminator, group)
        if model_group is not None:
            self.model_group = model_group
            parallel.shard_module(self.generator, model_group, self.opt_G)
            parallel.shard_module(self.discriminator, model_group, self.opt_D)
            parallel.shard_module(self.generator_ema, model_group)

    # -- helpers -------------------------------------------------------------

    def _cond(self, batch):
        if self.c_dim > 0:
            return batch["slice_idx"].reshape(-1, self.c_dim)
        return torch.zeros((batch["A"].shape[0], 1), device=batch["A"].device)

    def _d_input(self, a, b):
        return torch.cat([a, b], dim=1) if self.config.combine_ab else b

    def _blur(self, img, sigma):
        if self.blur_max_radius <= 0:
            return img
        return gaussian_blur2d(img, sigma, max_radius=self.blur_max_radius)

    def _run_d(self, img, c, sigma):
        return self.discriminator(self._blur(img, sigma), c)

    def _run_g(self, z, c, cond_img, ref_img, generator, mix: Optional[StyleMix]):
        """A train-mode G forward (``afcm_tpu/models/gan_model.py:149-160``),
        with style mixing when the config asks for it."""
        gen = self.generator
        if self.config.style_mixing_prob <= 0:
            return gen(z, c, cond_img, ref_img=ref_img, train=True, generator=generator)
        # afcm_tpu/models/gan_model.py:162-192: the mapping of z updates
        # w_avg, the mapping of z2 does not
        ws = gen.mapping(z, c, update_w_avg=True)
        num_ws = ws.shape[1]
        if mix is None:
            mix = self._draw_mix(z, num_ws, generator)
        elif self.group is not None:
            mix = mix._replace(z2=self.group.local(mix.z2))
        ws2 = gen.mapping(mix.z2, c, update_w_avg=False)
        cutoff = torch.as_tensor(mix.cutoff, device=ws.device)
        coin = torch.as_tensor(mix.coin, device=ws.device)
        mask = (torch.arange(num_ws, device=ws.device) >= cutoff) & coin
        ws = torch.where(mask[None, :, None], ws2, ws)
        return gen.synthesis(ws, cond_img, train=True, generator=generator)

    def _draw_mix(self, z, num_ws: int, generator) -> StyleMix:
        """The style-mixing draws from the step's generator: ``z2`` for the
        global batch (this rank's rows), then one cutoff and one coin,
        which every rank draws alike from its copy of the stream."""
        z2 = parallel.randn(tuple(z.shape), generator, z.device)
        scalar = generator.generator if isinstance(generator, parallel.GlobalDraws) \
            else generator
        cutoff = torch.randint(1, num_ws, (), generator=scalar, device=z.device)
        coin = torch.rand((), generator=scalar, device=z.device) < self.config.style_mixing_prob
        return StyleMix(z2, cutoff, coin)

    # -- the train step --------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor], cur_nimg: float,
                   with_r1: bool = True, z: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   mix: Union[StyleMix, Sequence[StyleMix], None] = None
                   ) -> Dict[str, torch.Tensor]:
        """One D + G + EMA step on ``batch`` ({"A", "B", "slice_idx"} on the
        model's device, this rank's slice); ``cur_nimg`` is the image count
        after this batch. ``z`` [N, z_dim] (of the global batch) and the
        co-modulation dropout masks are drawn from ``generator`` (a
        ``torch.Generator`` on the device, seeded alike on every rank)
        unless ``z`` is given; so are the style-mixing draws unless ``mix``
        gives them: one ``StyleMix`` for every G forward of the step, or
        one per forward (the D phase's, then the G phase's). Returns the
        losses as 0-d tensors, left on the device."""
        cfg = self.config
        gen, disc = self.generator, self.discriminator
        real_a, real_b = batch["A"], batch["B"]
        c = self._cond(batch)
        if self.group is not None:
            z = self.group.local(z)
            if generator is not None:
                generator = parallel.GlobalDraws(generator, self.group)
        if z is None:
            z = parallel.randn((real_a.shape[0], cfg.z_dim), generator, real_a.device)
        sigma = losses.blur_sigma_schedule(cur_nimg, cfg.blur_init_sigma,
                                           cfg.blur_fade_kimg)
        params_g = list(gen.parameters())
        params_d = list(disc.parameters())
        mixes = [mix, mix] if mix is None or isinstance(mix, StyleMix) else list(mix)

        def run_g(mix):
            return self._run_g(z, c, real_a, real_b, generator, mix)

        # ---- D phase (G frozen; reference stylegan3_model.py:117-125) ----
        with span("afcm.train.d_fake"):
            if cfg.shared_g_fwd:
                # One forward serves both phases: its graph is kept and the G
                # head's gradient flows back through it after the D update.
                fake_shared = run_g(mixes[0])
                fake_d = fake_shared.detach()
            else:
                with torch.no_grad():
                    fake_d = run_g(mixes[0])

        with span("afcm.train.d_loss"):
            real_ab = self._d_input(real_a, real_b)
            r1_on = cfg.lambda_r1 > 0 and with_r1
            if r1_on:
                real_ab = real_ab.detach().requires_grad_(True)
            fake_logits = self._run_d(self._d_input(real_a, fake_d), c, sigma)
            real_logits = self._run_d(real_ab, c, sigma)
            loss_d_fake, loss_d_real = losses.softplus_d_loss(fake_logits, real_logits)
            loss_d = loss_d_fake + loss_d_real
            loss_r1 = torch.zeros((), device=real_a.device)
        if r1_on:
            with span("afcm.train.r1"):
                loss_r1 = losses.r1_penalty(real_logits, real_ab)
                # Lazy R1 scales by the interval so the sum over steps matches
                # the every-step schedule (interval 1 => the same loss).
                loss_d = loss_d + loss_r1 * cfg.lambda_r1 * max(1, cfg.r1_interval)
        self._step(self.opt_D, params_d, loss_d, disc)

        # ---- G phase, through the updated D (stylegan3_model.py:126-135) ----
        with span("afcm.train.g_fake"):
            fake_b = fake_shared if cfg.shared_g_fwd else run_g(mixes[-1])
        with span("afcm.train.g_loss"):
            gen_logits = self._run_d(self._d_input(real_a, fake_b), c, sigma)
            loss_g_gan = losses.softplus_g_loss(gen_logits)
            loss_g_l1 = losses.l1_loss(self._blur(fake_b, sigma),
                                       self._blur(real_b, sigma)) * cfg.lambda_l1
        # Gradients w.r.t. G's parameters only: D's weights get none from
        # the G head, so nothing reaches D's optimizer.
        self._step(self.opt_G, params_g, loss_g_gan + loss_g_l1, gen)

        # ---- EMA (reference train.py:67-77) ----
        if cfg.ema_enabled:
            with span("afcm.train.ema"):
                beta = ema_beta(cfg.batch_size, cfg.ema_kimgs, cfg.ema_ramp, cur_nimg)
                ema_update(self.generator_ema, gen, beta)
        self.step += 1
        with span("afcm.train.metrics"):
            metrics = {"G_GAN": loss_g_gan, "G_L1": loss_g_l1, "D_real": loss_d_real,
                       "D_fake": loss_d_fake, "D_r1": loss_r1}
            metrics = global_metrics(metrics, self.group)
            metrics["blur_sigma"] = torch.tensor(sigma)
        return metrics

    def _step(self, optimizer, params, loss, net):
        """Gradients of ``loss`` w.r.t. ``params`` (zeros where a parameter
        does not reach the loss, as JAX gives, so every Adam state steps
        together), the replicated ones of ``net`` reduced over the model
        group, all averaged over the data group, NaN/Inf scrubbing, one
        Adam step, in the spans of ``net`` (D's or G's)."""
        backward, update = _STEP_SPANS["D" if net is self.discriminator else "G"]
        with span(backward):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with span(update):
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            if self.model_group is not None:
                self.model_group.reduce_replicated_(net, params, grads)
            if self.group is not None:
                self.group.average_(grads, "grads")
            for p, g in zip(params, grads):
                p.grad = g
            losses.nan_to_num_grads(params)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)

    # -- inference -----------------------------------------------------------

    def eval_step(self, cond_img, slice_idx, z=None,
                  generator: Optional[torch.Generator] = None, ref_img=None):
        """EMA forward with const noise (``afcm_tpu/models/gan_model.py:318-337``;
        reference: comodgan_model.py:114-126).

        ``z`` [N, z_dim] is drawn from ``generator`` (a ``torch.Generator``
        on the device of ``cond_img``) when not given. ``ref_img`` is the
        target batch where there is one (validation), for the CoModGAN
        ``RefMappingNetwork``; the serving flow has none, like the
        reference's set_test_input, and the other mappers ignore it."""
        if z is None:
            z = torch.randn((cond_img.shape[0], self.z_dim), generator=generator,
                            device=cond_img.device)
        with torch.inference_mode():
            return eval_forward(self.generator_ema, self.c_dim, cond_img, slice_idx, z,
                                ref_img)
