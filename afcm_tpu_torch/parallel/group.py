"""Data-parallel training over a process group: one rank per device of the
mesh's data axis, each with a contiguous slice of every global batch.

``afcm_tpu`` computes the sharded step on one logical array, so its step
on N devices is its single-device step on the global batch. The port's
ranks reproduce that:

- every draw per sample (z, dropout keep-masks, noise, the gradient
  penalty's interpolation) is made for the global batch from the step's
  generator, which has the same seed on every rank, and sliced
  (``GlobalDraws``, ``rand``, ``randn``);
- what couples samples across the batch (the discriminator's minibatch
  std, pix2pix's batch norm, the mapper's ``w_avg``) takes its statistics
  over the global batch through the differentiable ``DataGroup.gather`` and
  ``DataGroup.sum``, whose adjoints are each other's, so the R1 penalty's
  double backward crosses the ranks too;
- each net's gradient is averaged over the ranks in one flat all-reduce
  before it is scrubbed (``DataGroup.average_``), and the losses returned as
  metrics are averaged.

Every collective goes through ``DataGroup._all_reduce``: one kind,
``all_reduce``, which every backend supports on every device (gloo has no
reduce-scatter), and it counts each call and its bytes by purpose in
``census``. ``torch.distributed.nn`` would gather without that count.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

# torch's own default for a process group's collectives
GROUP_TIMEOUT_S = 1800


class DataGroup:
    """The ranks of the data axis of a step: the default process group, or,
    with a model axis (``tensor.make_groups``), the subgroup of the ranks of
    one model index, where this rank is ``rank`` of ``world``."""

    def __init__(self, process_group=None, rank: Optional[int] = None,
                 world: Optional[int] = None):
        self.process_group = process_group
        self.rank = dist.get_rank() if rank is None else rank
        self.world = dist.get_world_size() if world is None else world
        self.census: Dict[str, Dict[str, int]] = {}

    @classmethod
    def current(cls) -> Optional["DataGroup"]:
        """The group of the process group this process belongs to, if any."""
        return cls() if dist.is_available() and dist.is_initialized() else None

    def take_census(self) -> Dict[str, Dict[str, int]]:
        """The collectives counted since the last call, by purpose."""
        census, self.census = self.census, {}
        return census

    def _all_reduce(self, tensor: torch.Tensor, purpose: str,
                    process_group=None) -> torch.Tensor:
        """Sum ``tensor`` over the ranks (of ``process_group`` when given),
        in place; count the call."""
        entry = self.census.setdefault(purpose, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += tensor.numel() * tensor.element_size()
        dist.all_reduce(tensor, group=self.process_group if process_group is None
                        else process_group)
        return tensor

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``world * n_local``."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    def local(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's contiguous slice of a global-batch tensor."""
        if x is None:
            return None
        return x[self.rows(x.shape[0] // self.world)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of ``x`` (rank order along dim 0), differentiable."""
        return _Gather.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, differentiable."""
        return _Sum.apply(x, self)

    def mean_(self, x: torch.Tensor, purpose: str) -> torch.Tensor:
        """``x`` averaged over the ranks, in place, outside autograd."""
        with torch.no_grad():
            return self._all_reduce(x, purpose).div_(self.world)

    def average_(self, tensors: Sequence[torch.Tensor], purpose: str) -> None:
        """Average equally shaped lists of tensors over the ranks in one flat
        all-reduce (the gradients of one net)."""
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self._all_reduce(flat, purpose).div_(self.world)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def barrier(self) -> None:
        """Wait for every rank of the process group, those of the other
        model indices too (an all-reduce of one element, which every
        backend runs on the device the ranks compute on)."""
        self._all_reduce(torch.zeros(1, device=_device_of_group()), "barrier",
                         dist.group.WORLD)


def _device_of_group() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _Gather(torch.autograd.Function):
    """All-gather along dim 0 as an all-reduce of the rank's rows placed in
    zeros; its adjoint is ``_Scatter``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_zeros((group.world * x.shape[0], *x.shape[1:]))
        out[group.rows(x.shape[0])] = x
        return group._all_reduce(out, "gather")

    @staticmethod
    def backward(ctx, grad):
        return _Scatter.apply(grad, ctx.group), None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along dim 0: the sum over the ranks, this rank's rows;
    its adjoint is ``_Gather``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = group._all_reduce(x.clone(), "scatter")
        return out[group.rows(x.shape[0] // group.world)].clone()

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.group), None


class _Sum(torch.autograd.Function):
    """All-reduce sum; self-adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._all_reduce(x.clone(), "sum")

    @staticmethod
    def backward(ctx, grad):
        return _Sum.apply(grad, ctx.group), None


def attach(net: torch.nn.Module, group: Optional[DataGroup]) -> None:
    """Let the modules of ``net`` that take statistics over the batch
    (those with a ``data_group`` attribute) take them over ``group``'s
    global batch; None takes them over the local batch."""
    for module in net.modules():
        if hasattr(module, "data_group"):
            module.data_group = group


# -- draws for the global batch ------------------------------------------------

class GlobalDraws:
    """A ``torch.Generator`` whose per-sample draws (``rand``, ``randn``
    below) are made for the global batch of ``group`` and sliced to this
    rank's rows: every rank holds the same generator state, and W ranks
    draw what one process draws at the global batch."""

    def __init__(self, generator: torch.Generator, group: DataGroup):
        self.generator = generator
        self.group = group


def _draw(fn, shape, generator, device):
    if isinstance(generator, GlobalDraws):
        group = generator.group
        full = fn((shape[0] * group.world, *shape[1:]), generator=generator.generator,
                  device=device)
        return full[group.rows(shape[0])]
    return fn(tuple(shape), generator=generator, device=device)


def rand(shape, generator, device=None) -> torch.Tensor:
    """``torch.rand`` of a batch-leading ``shape`` (see ``GlobalDraws``)."""
    return _draw(torch.rand, shape, generator, device)


def randn(shape, generator, device=None) -> torch.Tensor:
    """``torch.randn`` of a batch-leading ``shape`` (see ``GlobalDraws``)."""
    return _draw(torch.randn, shape, generator, device)


# -- starting the ranks ----------------------------------------------------------

def init_process_group(backend: str, init_method: str, rank: int, world: int,
                       timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` with a bounded timeout. A
    failed init raises: NCCL never falls back to gloo."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _run_rank(rank, fn, world, backend, init_method, device_type, threads, timeout_s,
              args):
    if threads:
        torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_process_group(backend, init_method, rank, world, timeout_s or GROUP_TIMEOUT_S)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), *, backend: str,
          init_file: str, device_type: str = "cuda", threads: int = 0,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined in
    one process group (``backend``, a ``FileStore`` at ``init_file``). Rank
    r on ``cuda`` computes on card ``r mod count``. Raises when a rank fails
    (``torch.multiprocessing`` then stops the others and carries the rank's
    traceback) or when ``timeout_s`` runs out (killing all); every process
    is gone when it returns. ``timeout_s`` bounds the ranks' collectives
    too (else ``GROUP_TIMEOUT_S``)."""
    init_method = "file://" + os.path.abspath(init_file)
    context = torch.multiprocessing.start_processes(
        _run_rank, args=(fn, world, backend, init_method, device_type, threads, timeout_s,
                         tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not context.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join(10)
