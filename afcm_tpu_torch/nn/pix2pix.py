"""pix2pix baseline networks: the UNet generator and the PatchGAN and
PixelGAN discriminators (``afcm_tpu/nn/pix2pix.py``; reference:
models/pix2pix_model.py, upstream pytorch-CycleGAN-and-pix2pix).

The UnetSkipConnectionBlock recursion (conv k4 s2 / transposed conv k4 s2,
norm + ReLU/LeakyReLU, dropout on the innermost decoder stages) and the
70x70 PatchGAN. Parameter and buffer names are the JAX package's, so its
variables load with ``utils.port.load_jax_variables``: the blocks that
``UnetGenerator`` builds are its own children (``outer``, ``up1``, ``up2``,
``up4``, ``mid{i}``, ``inner``), each block holding ``down_w``, ``up_w``,
``down_b``, ``up_b``, ``down_norm`` and ``up_norm``.

Habits of the JAX package kept where upstream pix2pix differs:

- the batch norm is written out: its running variance moves by the biased
  batch variance, and ``update_stats=False`` runs a train-mode forward on
  batch statistics without moving them (the D forward inside G's loss);
- the leaky ReLU is ``where(x >= 0, x, 0.2 x)``, slope 1 at exactly 0;
- train-mode dropout takes a given keep mask per block, or draws one from
  an explicit ``torch.Generator``;
- inside ``differentiable_statistics`` the running statistics a train-mode
  forward moves stay functions of the batch, and an eval-mode forward reads
  them so: the JAX step's gradient penalty runs D on the statistics its two
  D forwards just computed from D's parameters, and differentiates through
  them (``afcm_tpu/models/pix2pix_model.py:117-133``).

The generator's convs are cuDNN's (``F.conv2d`` and ``F.conv_transpose2d``);
the discriminators' go through ``ops.conv2d_gradfix`` because the WGAN-GP
penalty differentiates D twice. The networks compute in float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv2d_gradfix import conv2d as conv2d_any_order
from .layers import dropout


def _lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _bias(x, b):
    return x + b[None, :, None, None]


def make_weight_init(init_type: str = "normal", init_gain: float = 0.02
                     ) -> Callable[..., torch.Tensor]:
    """Initializers of torch-layout [out, in, *k] kernels, the distributions
    of ``afcm_tpu/nn/pix2pix.py:make_weight_init`` (reference:
    models/utils.py:72-110): ``normal`` std ``init_gain``; ``xavier``;
    ``kaiming`` (the gain ignored, like torch's kaiming_normal_);
    ``orthogonal`` over [out, in·k·k] (flax's ``column_axis=0``). Returns
    ``init(shape, generator) -> Tensor``."""
    if init_type not in ("normal", "xavier", "kaiming", "orthogonal"):
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")

    def init(shape: Tuple[int, ...], generator: Optional[torch.Generator] = None):
        rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * rf
        fan_out = shape[0] * rf
        if init_type == "normal":
            return torch.randn(shape, generator=generator) * init_gain
        if init_type == "xavier":
            std = init_gain * np.sqrt(2.0 / (fan_in + fan_out))
            return torch.randn(shape, generator=generator) * float(std)
        if init_type == "kaiming":
            return torch.randn(shape, generator=generator) * float(np.sqrt(2.0 / fan_in))
        out, k = shape[0], int(np.prod(shape[1:]))
        a = torch.randn((max(out, k), min(out, k)), generator=generator,
                        dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None]
        flat = q.T if k >= out else q          # [out, k]: orthonormal rows or columns
        return (flat * init_gain).to(torch.float32).reshape(shape)

    return init


class _Norm(nn.Module):
    """batch | instance | none normalization over NCHW feature maps
    (``afcm_tpu/nn/pix2pix.py:45-87``). Batch norm: affine ``scale`` ~
    N(1, init_gain) and ``bias`` 0, running ``mean`` and ``var`` buffers at
    momentum 0.1, eps 1e-5. Instance norm: no affine, no statistics. With a
    ``data_group`` (``parallel.attach``) the batch norm's train-mode
    statistics are the global batch's, so the running ones move alike on
    every rank."""

    data_group = None

    def __init__(self, features: int, kind: str = "batch", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in ("batch", "instance", "none"):
            raise NotImplementedError(f"normalization layer [{kind}] is not found")
        self.kind = kind
        # differentiable_statistics: the running statistics as graph tensors
        self.keep_graph = False
        self.graph_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if kind == "batch":
            self.scale = nn.Parameter(
                1.0 + init_gain * torch.randn((features,), generator=generator))
            self.bias = nn.Parameter(torch.zeros(features))
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if self.kind == "none":
            return x
        if self.kind == "instance":
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
            return (x - mean) * torch.rsqrt(var + 1e-5)
        if train:
            group = self.data_group
            if group is None:
                mean = x.mean(dim=(0, 2, 3))
                var = x.var(dim=(0, 2, 3), unbiased=False)
            else:   # the global batch's, differentiable across the ranks
                mean = group.sum(x.mean(dim=(0, 2, 3))) / group.world
                var = group.sum(torch.square(x - mean[None, :, None, None])
                                .mean(dim=(0, 2, 3))) / group.world
            if update_stats:
                momentum = 0.1
                run_mean, run_var = self.graph_stats or (self.mean, self.var)
                new_mean = (1 - momentum) * run_mean + momentum * mean
                new_var = (1 - momentum) * run_var + momentum * var
                if self.keep_graph:
                    self.graph_stats = (new_mean, new_var)
                with torch.no_grad():
                    self.mean.copy_(new_mean)
                    self.var.copy_(new_var)
        else:
            mean, var = self.graph_stats or (self.mean, self.var)
        x = (x - mean[None, :, None, None]) * torch.rsqrt(var[None, :, None, None] + 1e-5)
        return x * self.scale[None, :, None, None] + self.bias[None, :, None, None]


@contextlib.contextmanager
def differentiable_statistics(net: nn.Module):
    """Within the block, the batch norms of ``net`` keep the running
    statistics that their train-mode forwards move as graph tensors (the
    buffers move as always), and their eval-mode forwards read those, so a
    gradient reaches the parameters before a norm through its statistics,
    as it does in the JAX step's gradient penalty. Leaving the block drops
    them."""
    norms = [m for m in net.modules() if isinstance(m, _Norm)]
    for m in norms:
        m.keep_graph = True
    try:
        yield
    finally:
        for m in norms:
            m.keep_graph, m.graph_stats = False, None


class UnetSkipConnectionBlock(nn.Module):
    """One level of the UNet (``afcm_tpu/nn/pix2pix.py:118-166``). The
    level below is not a child: ``forward`` takes it as a callable, so that
    the generator holds every level as its own child."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 outermost: bool = False, innermost: bool = False,
                 norm: str = "batch", use_dropout: bool = False,
                 init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        winit = make_weight_init(init_type, init_gain)
        input_nc = input_nc if input_nc is not None else outer_nc
        self.outermost, self.innermost = outermost, innermost
        self.use_bias = norm == "instance"
        self.use_dropout = use_dropout
        self.down_w = nn.Parameter(winit((inner_nc, input_nc, 4, 4), generator))
        if self.use_bias:  # upstream builds every downconv with bias=use_bias
            self.down_b = nn.Parameter(torch.zeros(inner_nc))
        if not (outermost or innermost):
            self.down_norm = _Norm(inner_nc, norm, init_gain, generator)
        up_in = inner_nc if innermost else inner_nc * 2
        self.up_w = nn.Parameter(winit((up_in, outer_nc, 4, 4), generator))
        if outermost or self.use_bias:
            self.up_b = nn.Parameter(torch.zeros(outer_nc))
        if not outermost:
            self.up_norm = _Norm(outer_nc, norm, init_gain, generator)

    def forward(self, x, submodule: Optional[Callable] = None, train: bool = True,
                update_stats: bool = True, keep_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        norm = dict(train=train, update_stats=update_stats)
        h = x if self.outermost else _lrelu(x)
        h = F.conv2d(h, self.down_w, stride=2, padding=1)
        if self.use_bias:
            h = _bias(h, self.down_b)
        if not (self.outermost or self.innermost):
            h = self.down_norm(h, **norm)
        if submodule is not None:
            h = submodule(h)
        # torch ConvTranspose2d(k=4, s=2, p=1) on the [in, out, 4, 4] weight:
        # the JAX package's _deconv (:33-42)
        h = F.conv_transpose2d(torch.relu(h), self.up_w, stride=2, padding=1)
        if self.outermost:
            return torch.tanh(_bias(h, self.up_b))
        if self.use_bias:
            h = _bias(h, self.up_b)
        h = self.up_norm(h, **norm)
        if self.use_dropout:
            h = dropout(h, 0.5, train, generator, keep_mask)
        return torch.cat([x, h], dim=1)


class UnetGenerator(nn.Module):
    """unet_256 (8 downsamplings) or unet_128 (7), ``afcm_tpu/nn/pix2pix.py:169-201``."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 8,
                 ngf: int = 64, norm: str = "batch", use_dropout: bool = True,
                 init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_downs = num_downs
        kw = dict(norm=norm, init_type=init_type, init_gain=init_gain,
                  generator=generator)
        # built innermost first, as the JAX package draws them
        self.inner = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        mids = [f"mid{i}" for i in range(num_downs - 5)]
        for name in mids:
            self.add_module(name, UnetSkipConnectionBlock(
                ngf * 8, ngf * 8, use_dropout=use_dropout, **kw))
        self.up4 = UnetSkipConnectionBlock(ngf * 4, ngf * 8, **kw)
        self.up2 = UnetSkipConnectionBlock(ngf * 2, ngf * 4, **kw)
        self.up1 = UnetSkipConnectionBlock(ngf, ngf * 2, **kw)
        self.outer = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             outermost=True, **kw)
        # outermost first: each level runs the next one as its submodule
        self.levels = ["outer", "up1", "up2", "up4", *reversed(mids), "inner"]

    @property
    def dropout_blocks(self):
        """Names of the levels that apply dropout (the ``mid{i}`` blocks)."""
        return [n for n in self.levels if getattr(self, n).use_dropout]

    def forward(self, x, train: bool = True, update_stats: bool = True,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """``dropout_masks`` maps a ``mid{i}`` level to its keep mask (the
        tests pass flax's); levels without one draw from ``generator``."""
        masks = dropout_masks or {}

        def run(i, h):
            name = self.levels[i]
            sub = (lambda t: run(i + 1, t)) if i + 1 < len(self.levels) else None
            return getattr(self, name)(h, sub, train=train, update_stats=update_stats,
                                       keep_mask=masks.get(name), generator=generator)

        return run(0, x)


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN at ``n_layers`` 3 (``afcm_tpu/nn/pix2pix.py:204-251``)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", init_type: str = "normal",
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        winit = make_weight_init(init_type, init_gain)
        self.n_layers = n_layers
        self.use_bias = norm == "instance"
        self.w0 = nn.Parameter(winit((ndf, input_nc, 4, 4), generator))
        self.b0 = nn.Parameter(torch.zeros(ndf))
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            self.register_parameter(f"w{n}", nn.Parameter(
                winit((ndf * nf_mult, ndf * nf_prev, 4, 4), generator)))
            if self.use_bias:
                self.register_parameter(f"b{n}", nn.Parameter(torch.zeros(ndf * nf_mult)))
            self.add_module(f"norm{n}", _Norm(ndf * nf_mult, norm, init_gain, generator))
        nf_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        self.w_last = nn.Parameter(winit((ndf * nf_mult, ndf * nf_prev, 4, 4), generator))
        if self.use_bias:
            self.b_last = nn.Parameter(torch.zeros(ndf * nf_mult))
        self.norm_last = _Norm(ndf * nf_mult, norm, init_gain, generator)
        self.w_out = nn.Parameter(winit((1, ndf * nf_mult, 4, 4), generator))
        self.b_out = nn.Parameter(torch.zeros(1))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        norm = dict(train=train, update_stats=update_stats)
        x = _lrelu(_bias(conv2d_any_order(x, self.w0, stride=2, padding=1), self.b0))
        for n in range(1, self.n_layers):
            x = conv2d_any_order(x, getattr(self, f"w{n}"), stride=2, padding=1)
            if self.use_bias:
                x = _bias(x, getattr(self, f"b{n}"))
            x = _lrelu(getattr(self, f"norm{n}")(x, **norm))
        x = conv2d_any_order(x, self.w_last, stride=1, padding=1)
        if self.use_bias:
            x = _bias(x, self.b_last)
        x = _lrelu(self.norm_last(x, **norm))
        return _bias(conv2d_any_order(x, self.w_out, stride=1, padding=1), self.b_out)


class PixelDiscriminator(nn.Module):
    """1x1 PixelGAN (``afcm_tpu/nn/pix2pix.py:254-284``)."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "batch",
                 init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        winit = make_weight_init(init_type, init_gain)
        self.use_bias = norm == "instance"
        self.w0 = nn.Parameter(winit((ndf, input_nc, 1, 1), generator))
        self.b0 = nn.Parameter(torch.zeros(ndf))
        self.w1 = nn.Parameter(winit((ndf * 2, ndf, 1, 1), generator))
        if self.use_bias:
            self.b1 = nn.Parameter(torch.zeros(ndf * 2))
        self.norm1 = _Norm(ndf * 2, norm, init_gain, generator)
        self.w2 = nn.Parameter(winit((1, ndf * 2, 1, 1), generator))
        if self.use_bias:
            self.b2 = nn.Parameter(torch.zeros(1))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = _lrelu(_bias(conv2d_any_order(x, self.w0), self.b0))
        x = conv2d_any_order(x, self.w1)
        if self.use_bias:
            x = _bias(x, self.b1)
        x = _lrelu(self.norm1(x, train=train, update_stats=update_stats))
        x = conv2d_any_order(x, self.w2)
        return _bias(x, self.b2) if self.use_bias else x
