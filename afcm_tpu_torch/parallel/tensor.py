"""Tensor parallelism over the mesh's model axis (``afcm_tpu/parallel/mesh.py:
91-115,168-178``).

``afcm_tpu`` places each parameter by its shape (``infer_param_sharding``)
and lets GSPMD insert the gathers. Here a config's ``tpu.mesh_shape [D, M]``
runs D·M ranks: rank r has data index ``r // M`` and model index ``r % M``
(``make_mesh``'s row-major grid), and ``make_groups`` gives every rank its
**data group** (the D ranks of its model index, a ``DataGroup``) and its
**model group** (the M ranks of its data row, a ``ModelGroup``).

``shard_module`` keeps dim 0 (the output dim) of each parameter the rule
shards as this rank's slice and tells its layer so (``layer.tp``). A
sharded layer runs the Megatron pattern: it ``enter``s its full input (the
identity; its backward sums the input's gradient over the model group),
computes its slice of output channels and the per-channel operations on it
(bias, activation, ``filtered_lrelu``, the FIR resampling, the noise of a
modulated conv), then ``gather_channels`` (all ranks' slices in model-rank
order; its backward takes this rank's slice back). An embedding table is
sharded on its rows: its lookup gathers the whole table (``gather_dim0``,
purpose ``tp_table``; its backward takes this rank's rows). Everything
between two sharded layers runs whole, and alike, on every rank of the row.
A replicated parameter's gradient then comes out whole on every rank, but
for those each rank applies to its own slice alone (``partial_parameters``:
the biases of sharded layers and the noise strengths of sharded modulated
convs).
After the backward ``reduce_replicated_`` sums those parts over the model
group and averages the whole gradients, in one all-reduce: on a card
the ranks' whole gradients differ in the last bits (cuDNN's reductions are
not deterministic; phase 20 of chip_smoke.py saw it at float32), and the
mean keeps every rank's copy of a replicated parameter equal. Adam and the
EMA act element by element on the slices.

The two collectives and their adjoints are each other's, so the R1
penalty's double backward crosses them. Every collective is one counted
``all_reduce`` (gloo runs only ``all_reduce`` and ``broadcast`` on CUDA
tensors), by purpose: ``tp_gather``, ``tp_styles`` (the styles of a
modulated conv, gathered before their normalization), ``tp_table``,
``tp_enter``, ``tp_partial_grads`` and ``tp_state`` (``full_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .group import DataGroup

SHARD = "shard dim 0"
REPLICATE = "replicate"


def infer_param_sharding(name: str, shape, model_size: int) -> str:
    """The placement rule of ``afcm_tpu/parallel/mesh.py:91-115``: with a
    model axis of more than 1, a parameter of at least 2 dims whose dim 0
    (its output dim) divides by the axis and holds at least 8 per rank is
    sharded on dim 0; biases, small and indivisible tensors are replicated.
    ``name`` is not read (the rule goes by shape, as there)."""
    if model_size <= 1 or len(shape) < 2:
        return REPLICATE
    out_dim = int(shape[0])
    if out_dim % model_size != 0 or out_dim < 8 * model_size:
        return REPLICATE
    return SHARD


class ModelGroup:
    """The ranks of one data row: the model axis of a step."""

    def __init__(self, process_group, rank: int, size: int):
        self.process_group = process_group
        self.rank = rank
        self.size = size
        self.census: Dict[str, Dict[str, int]] = {}

    def take_census(self) -> Dict[str, Dict[str, int]]:
        """The collectives counted since the last call, by purpose."""
        census, self.census = self.census, {}
        return census

    def _all_reduce(self, tensor: torch.Tensor, purpose: str) -> torch.Tensor:
        """Sum ``tensor`` over the model group, in place; count the call."""
        entry = self.census.setdefault(purpose, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += tensor.numel() * tensor.element_size()
        dist.all_reduce(tensor, group=self.process_group)
        return tensor

    def channels(self, n_global: int) -> slice:
        """This rank's slice of ``n_global`` output channels."""
        n = n_global // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; its backward sums the gradient over the group."""
        return _Enter.apply(x, self)

    def gather_channels(self, x: torch.Tensor, purpose: str = "tp_gather") -> torch.Tensor:
        """Every rank's slice of dim 1, in model-rank order; its backward
        takes this rank's slice."""
        return _Gather.apply(x, self, purpose, 1)

    def sum_(self, tensors: List[torch.Tensor], purpose: str) -> None:
        """Sum equally placed tensors over the group in one flat all-reduce."""
        if not tensors:
            return
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self._all_reduce(flat, purpose)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def reduce_replicated_(self, net: nn.Module, params: List[nn.Parameter],
                           grads: List[torch.Tensor]) -> None:
        """The gradients (``grads``, of ``params`` of ``net``) of the
        parameters that are not sharded, as one process has them, equal on
        every rank: the partial ones summed over the group, the whole ones
        averaged, in one flat all-reduce (``tp_partial_grads``)."""
        sharded = {id(m.weight) for m in sharded_layers(net)}
        partial = {id(p) for p in partial_parameters(net)}
        shares = []
        for p, g in zip(params, grads):
            if id(p) in sharded:
                continue
            if id(p) not in partial:
                g.div_(self.size)
            shares.append(g)
        self.sum_(shares, "tp_partial_grads")

    def gather_dim0(self, x: torch.Tensor, purpose: str = "tp_state") -> torch.Tensor:
        """The whole tensor of which ``x`` is this rank's dim-0 slice; its
        backward takes this rank's rows."""
        return _Gather.apply(x, self, purpose, 0)


def _contiguous_clone(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


class _Enter(torch.autograd.Function):
    """Identity forward, sum over the group backward; adjoint of ``_Reduce``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group (partial values to the whole); its adjoint hands
    the whole gradient to every rank's part, ``_Enter``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._all_reduce(_contiguous_clone(x), "tp_enter")

    @staticmethod
    def backward(ctx, grad):
        return _Enter.apply(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (0 or 1) as an all-reduce of the rank's
    slice placed in zeros (exact in any dtype); adjoint of ``_Split``."""

    @staticmethod
    def forward(ctx, x, group, purpose, dim):
        ctx.group, ctx.purpose, ctx.dim = group, purpose, dim
        shape = list(x.shape)
        shape[dim] *= group.size
        out = x.new_zeros(shape)
        out.narrow(dim, group.rank * x.shape[dim], x.shape[dim]).copy_(x)
        return group._all_reduce(out, purpose)

    @staticmethod
    def backward(ctx, grad):
        return _Split.apply(grad, ctx.group, ctx.purpose, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor whole on every rank;
    adjoint of ``_Gather``."""

    @staticmethod
    def forward(ctx, x, group, purpose, dim):
        ctx.group, ctx.purpose, ctx.dim = group, purpose, dim
        n = x.shape[dim] // group.size
        return _contiguous_clone(x.narrow(dim, group.rank * n, n))

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.group, ctx.purpose, ctx.dim), None, None, None


# -- the groups of a mesh -----------------------------------------------------------

def make_groups(model_size: int) -> Tuple[Optional[DataGroup], Optional[ModelGroup]]:
    """The data and model groups of this rank in the process group this
    process belongs to, for a model axis of ``model_size`` (the world is
    D·M ranks). Every rank creates every subgroup, in the same order.
    Without a process group: (None, None); with a model axis of 1 the data
    group is the whole world, as it is without tensor parallelism, and
    there is no model group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    if model_size <= 1:
        return DataGroup(), None
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_size:
        raise ValueError(f"{world} ranks do not divide into a model axis of {model_size}")
    data_size = world // model_size
    data_groups = [dist.new_group([i * model_size + j for i in range(data_size)])
                   for j in range(model_size)]
    model_groups = [dist.new_group([i * model_size + j for j in range(model_size)])
                    for i in range(data_size)]
    data_index, model_index = divmod(rank, model_size)
    return (DataGroup(data_groups[model_index], data_index, data_size),
            ModelGroup(model_groups[data_index], model_index, model_size))


# -- sharding a network -----------------------------------------------------------------

def sharded_layers(net: nn.Module) -> Iterable[nn.Module]:
    """The layers of ``net`` whose weight ``shard_module`` sharded."""
    return (m for m in net.modules() if getattr(m, "tp", None) is not None)


def partial_parameters(net: nn.Module) -> List[nn.Parameter]:
    """The replicated parameters each rank applies to its slice alone, so
    that its gradient is partial: those a sharded layer names in
    ``tp_partial`` (its bias; a modulated conv's noise strength too)."""
    return [p for m in sharded_layers(net) for p in
            (getattr(m, name, None) for name in m.tp_partial) if p is not None]


def shard_module(net: nn.Module, group: ModelGroup,
                 optimizer: Optional[torch.optim.Optimizer] = None) -> nn.Module:
    """Keep this rank's dim-0 slice of every parameter of ``net`` that
    ``infer_param_sharding`` shards, in place (the same ``Parameter``
    objects, so an optimizer built on them stays valid; its moments, if it
    has any, are sliced alike), and tell each such layer its model group
    (``layer.tp``) and its whole output size (``layer.tp_out``). Buffers
    stay whole. A layer that shards must be one of the tensor-parallel
    layers (the ``weight`` of a module with a ``tp`` attribute, the
    ``nn.layers.TensorParallel`` layers); any other parameter the rule
    shards raises, naming its layer's class."""
    for module_name, module in net.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if infer_param_sharding(name, p.shape, group.size) != SHARD:
                continue
            if name != "weight" or not hasattr(module, "tp"):
                kind = type(module).__name__
                raise NotImplementedError(
                    f"{kind} {module_name}.{name} {tuple(p.shape)}: the placement "
                    f"rule shards it and {kind} has no tensor-parallel forward")
            rows = group.channels(p.shape[0])
            module.tp, module.tp_out = group, int(p.shape[0])
            with torch.no_grad():
                p.data = p.data[rows].clone()
            if optimizer is not None:
                for value in optimizer.state.get(p, {}).values():
                    if torch.is_tensor(value) and value.ndim == p.ndim:
                        value.data = value.data[rows].clone()
    return net


def sharded_weights(net: nn.Module) -> Dict[str, ModelGroup]:
    """The state-dict names of ``net``'s sharded weights, with their group."""
    return {f"{name}.weight" if name else "weight": m.tp
            for name, m in net.named_modules() if getattr(m, "tp", None) is not None}


def full_state_dict(net: nn.Module, group: Optional[ModelGroup]) -> Dict[str, torch.Tensor]:
    """``net.state_dict()`` with every sharded parameter whole again (the
    inverse of ``shard_module``; every rank of the group takes part)."""
    state = net.state_dict()
    if group is None:
        return state
    sharded = sharded_weights(net)
    return {k: group.gather_dim0(v) if k in sharded else v for k, v in state.items()}


def load_full_state_dict(net: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole (one-process) state dict into a sharded ``net``,
    strictly: each sharded parameter takes this rank's slice."""
    sharded = sharded_weights(net)
    net.load_state_dict({k: v[sharded[k].channels(v.shape[0])] if k in sharded else v
                         for k, v in state.items()}, strict=True)
