"""The check that W ranks take the step one process takes: one train step of
a GAN config on a global batch, in one process or as a rank of the process
group (over a model axis too), and the per-net error between two such
steps' gradients. ``chip_smoke.py`` (phases 15b and 20),
``scripts/torch_data_parallel.py`` and ``scripts/torch_tensor_parallel.py``
run it."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .group import DataGroup
from .tensor import ModelGroup, sharded_weights


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step_check(cfg, batch: Dict[str, np.ndarray], device, *, seed: int,
                     draw_seed: int, group: Optional[DataGroup] = None,
                     model_group: Optional[ModelGroup] = None,
                     nudge_seed: Optional[int] = None) -> dict:
    """One train step of ``cfg`` (the GAN family) on the global ``batch``
    (this rank's rows with a ``group``): the weights from ``seed``, the
    draws from a generator on the device seeded with ``draw_seed``, at the
    matmul precision of ``cfg.tpu.compute_dtype``. With ``nudge_seed`` every
    weight and input is first nudged by a relative 2^-24 drawn from it (the
    rounding floor). Returns the losses, each net's gradient as its
    optimizer steps it (all-reduced over the ranks, whole again over a
    ``model_group``) under the keys ``"<G|D>.grad.<parameter>"`` on the
    CPU, K1/K2 launches, the step's ms, the groups' census and, on a card,
    the step's peak of allocated bytes."""
    from ..evaluate import set_matmul_precision
    from ..models import build_model
    from ..ops.cuda import filtered_lrelu as k1
    from ..train import init_cublas, to_device

    device = torch.device(device)
    set_matmul_precision(cfg.tpu.compute_dtype)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    if nudge_seed is not None:
        eps = 2.0 ** -24
        nudge = torch.Generator().manual_seed(nudge_seed)
        with torch.no_grad():
            for p in [*model.generator.parameters(), *model.discriminator.parameters()]:
                p.mul_(1 + eps * torch.randn(p.shape, generator=nudge))
        batch = {k: (torch.from_numpy(v) * (1 + eps * torch.randn(v.shape, generator=nudge)))
                 .numpy() if k in ("A", "B") else v for k, v in batch.items()}
    model.to(device)
    init_cublas(device)
    rows = slice(None)
    if group is not None:
        model.distribute(group, model_group)
        rows = group.rows(len(batch["A"]) // group.world)
    grads = {}
    # over a model axis the slices stay on the device until they are gathered
    keep = torch.Tensor.clone if model_group is not None else torch.Tensor.cpu
    for net, opt, module in (("G", model.opt_G, model.generator),
                             ("D", model.opt_D, model.discriminator)):
        names = [n for n, _ in module.named_parameters()]
        opt.register_step_pre_hook(lambda o, args, kwargs, net=net, names=names: grads.update(
            {f"{net}.grad.{n}": keep(p.grad.detach()) for n, p in zip(
                names, (p for g in o.param_groups for p in g["params"]))}))
    k1.launches = k1.bwd_launches = 0
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    metrics = model.train_step(to_device({k: v[rows] for k, v in batch.items()}, device),
                               float(len(batch["A"])),
                               generator=torch.Generator(device=device).manual_seed(draw_seed))
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    census = {}
    for g in (group, model_group):
        census.update(g.take_census() if g is not None else {})
    if model_group is not None:
        # the sharded gradients whole, as one process holds them
        for net, module in (("G", model.generator), ("D", model.discriminator)):
            for name in sharded_weights(module):
                key = f"{net}.grad.{name}"
                grads[key] = model_group.gather_dim0(grads[key], "check")
        model_group.take_census()           # those gathers are the check's, not the step's
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: v.cpu() for k, v in grads.items()},
           "launches": (k1.launches, k1.bwd_launches), "ms": ms, "census": census}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del model, metrics
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def grad_errors(got, want) -> Dict[str, float]:
    """||got - want|| / ||want|| over all the gradients of each net: the
    keys "<net>.grad.<parameter>", grouped by <net>."""
    sums = {}
    for k in want:
        if ".grad." in k:
            net = k.split(".grad.")[0]
            num, den = sums.get(net, (0.0, 0.0))
            sums[net] = (
                num + float((got[k].double().cpu() - want[k].double().cpu()).square().sum()),
                den + float(want[k].double().square().sum()))
    return {net: (num / max(den, 1e-300)) ** 0.5 for net, (num, den) in sums.items()}
