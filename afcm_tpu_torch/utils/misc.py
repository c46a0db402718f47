"""Runtime-contract and inspection helpers (``afcm_tpu/utils/misc.py``;
reference: torch_utils/misc.py).

``assert_shape`` is the reference's runtime shape contract (misc.py:82-95).
``print_module_summary`` lists a module's parameters and buffers by the
names of their ``state_dict``, which are the JAX package's variable paths
(``utils/port.py``). ``check_replica_consistency`` is the port's
``check_ddp_consistency`` (misc.py:180-191): across the module copies of
``parallel.replicate_state`` or across the ranks of a process group.
``InfiniteSampler`` is a plain copy (numpy).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import parallel


def assert_shape(tensor, ref_shape: Iterable[Optional[int]]):
    """Assert tensor shape matches ref (None entries = wildcard)."""
    ref_shape = tuple(ref_shape)
    if tensor.ndim != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {tensor.ndim}, "
            f"expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(tensor.shape, ref_shape)):
        if ref_size is not None and size != ref_size:
            raise AssertionError(
                f"Wrong size for dimension {idx}: got {size}, "
                f"expected {ref_size}")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _tensors(params: Union[nn.Module, Mapping[str, torch.Tensor]]):
    """(name, tensor) of a module's parameters and buffers, or of a
    state_dict."""
    if isinstance(params, nn.Module):
        return list(params.named_parameters()) + list(params.named_buffers())
    return list(params.items())


def num_params(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters (not its buffers), or of every
    tensor of a state_dict."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(v.shape)) for v in params.values())


def print_module_summary(module: Union[nn.Module, Mapping[str, torch.Tensor]],
                         max_rows: int = 200) -> str:
    """Per-tensor table (name, shape, count) and total of a module's
    parameters and buffers, or of a state_dict."""
    rows = [(name, tuple(t.shape), int(np.prod(t.shape))) for name, t in _tensors(module)]
    total = sum(r[2] for r in rows)
    width = max((len(r[0]) for r in rows[:max_rows]), default=10)
    lines = [f"{'Parameter':<{width}}  {'Shape':<20}  Count"]
    for name, shape, count in rows[:max_rows]:
        lines.append(f"{name:<{width}}  {str(shape):<20}  {count}")
    if len(rows) > max_rows:
        lines.append(f"... ({len(rows) - max_rows} more)")
    lines.append(f"Total parameters: {total:,}")
    out = "\n".join(lines)
    print(out)
    return out


def check_replica_consistency(replicas: Union[nn.Module, Sequence[nn.Module]],
                              group: Optional[parallel.DataGroup] = None) -> bool:
    """Verify that replicas of a module hold identical parameters and
    buffers: the copies of ``parallel.replicate_state`` (a sequence of
    modules, one per device), or one module's copies on the ranks of
    ``group`` (default: the process group this process belongs to; alone,
    there is nothing to compare). The ranks' copies are gathered through
    the group's counted all-reduce."""
    if isinstance(replicas, nn.Module):
        group = group or parallel.DataGroup.current()
        if group is None:
            return True
        with torch.no_grad():
            for name, t in _tensors(replicas):
                every = group.gather(t.detach().reshape(1, -1))
                for rank in range(1, group.world):
                    if not torch.equal(every[rank], every[0]):
                        raise AssertionError(f"Replica mismatch at {name} on rank {rank}")
        return True
    first = _tensors(replicas[0])
    for replica in replicas[1:]:
        for (name, a), (_, b) in zip(first, _tensors(replica)):
            if not torch.equal(a.detach().cpu(), b.detach().cpu()):
                raise AssertionError(f"Replica mismatch at {name} on device {b.device}")
    return True


class InfiniteSampler:
    """Rank-aware infinite shuffled index stream
    (reference: misc.py:111-142)."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert dataset_size > 0
        assert 0 <= rank < num_replicas
        assert 0 <= window_size <= 1
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1
