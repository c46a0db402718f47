"""The device mesh of the port (``afcm_tpu/parallel/mesh.py``).

``afcm_tpu`` names a ``jax.sharding.Mesh`` of (data, model) devices and lets
GSPMD split each batch over the data axis and insert the gradient
all-reduces. Here the mesh is a plain grid of ``torch.device`` with the same
names and shape, and the two uses of its data axis are explicit:

- serving runs in one process: ``replicate_state`` puts one copy of the
  generator on each device of the data axis and ``shard_batch`` cuts each
  batch into contiguous chunks, one per device (``P("data")``);
- training runs one process per device of the data axis, each with its
  contiguous slice of every global batch (``parallel.group``).

A model axis larger than 1 (tensor parallelism) runs one process per
device of the whole mesh, data row by data row (``parallel.tensor``).
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of devices: ``devices`` is a numpy object array
    of ``torch.device``, ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices of the data axis (the first of each model row)."""
        return list(self.devices[:, 0])


def visible_devices() -> List[torch.device]:
    """``cuda:0 .. cuda:n-1``, every card torch sees (none without CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(mesh_shape: Sequence[int] = (0, 1), devices=None) -> Mesh:
    """A (data, model) mesh; data size 0 means every device that remains.
    ``devices`` defaults to every visible card; a caller may pass a list
    (two CPU devices in the tests, ``cuda:0`` twice on a one-card machine)."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    data, model = (int(v) for v in mesh_shape)
    if model <= 0:
        model = 1
    if data <= 0:
        data = len(devices) // model
    if data < 1 or data * model > len(devices):
        raise ValueError(
            f"mesh {list(mesh_shape)} cannot be built from {len(devices)} devices "
            f"(resolved data={data}, model={model})")
    grid = np.empty((data, model), dtype=object)
    for i, device in enumerate(devices[:data * model]):
        grid[i // model, i % model] = device
    return Mesh(grid)


def make_mesh_for_batch(mesh_shape: Sequence[int], batch_size: int,
                        devices=None) -> Mesh:
    """Like ``make_mesh``, but clamps the data axis to the largest divisor
    of the global batch size, with a warning that names the idle devices."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    data, model = (int(v) for v in mesh_shape)
    if model <= 0:
        model = 1
    max_data = max(len(devices) // model, 1) if data <= 0 else data
    requested = max_data
    while max_data > 1 and batch_size % max_data != 0:
        max_data -= 1
    if max_data < requested:
        logging.getLogger(__name__).warning(
            "make_mesh_for_batch: batch %d not divisible by data axis %d; "
            "clamping to %d — %d of %d devices will sit idle. Pick a batch "
            "size divisible by the data-parallel degree for full utilization.",
            batch_size, requested, max_data, (requested - max_data) * model,
            len(devices))
    return make_mesh((max_data, model), devices)


def local_batch_size(global_batch: int, mesh_or_size) -> int:
    """The batch each device of the data axis takes."""
    n_data = (mesh_or_size.shape[DATA_AXIS] if isinstance(mesh_or_size, Mesh)
              else int(mesh_or_size))
    if global_batch % n_data:
        raise ValueError(f"batch {global_batch} not divisible by data-parallel "
                         f"size {n_data}")
    return global_batch // n_data


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> List[Dict[str, Any]]:
    """A batch cut along dim 0 into one contiguous chunk per device of the
    data axis, each chunk's tensors on its device (numpy arrays are sliced)."""
    devices = mesh.data_devices
    n = local_batch_size(len(next(iter(batch.values()))), len(devices))
    chunks = []
    for i, device in enumerate(devices):
        chunk = {}
        for k, v in batch.items():
            v = v[i * n:(i + 1) * n]
            chunk[k] = v.to(device, non_blocking=True) if torch.is_tensor(v) else v
        chunks.append(chunk)
    return chunks


def replicate_state(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One copy of ``module`` on each device of the data axis; the first is
    ``module`` itself, moved to the first device."""
    devices = mesh.data_devices
    replicas = [module.to(devices[0])]
    for device in devices[1:]:
        replicas.append(copy.deepcopy(module).to(device))
    return replicas


def resolve_mesh(mesh_shape: Sequence[int], batch_size: int,
                 device: torch.device) -> Optional[Mesh]:
    """The mesh of a config on ``device``'s type: the visible cards for
    ``cuda``; for the CPU the mesh as the config gives it (a data axis of 0
    is one row). None when it holds one device."""
    if device.type == "cuda":
        devices = visible_devices()
    else:
        devices = [torch.device("cpu")] * (max(int(mesh_shape[0]), 1)
                                           * max(int(mesh_shape[1]), 1))
    mesh = make_mesh_for_batch(mesh_shape, batch_size, devices)
    return mesh if mesh.devices.size > 1 else None
