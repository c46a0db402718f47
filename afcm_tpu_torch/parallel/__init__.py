"""Data parallelism of the port (``afcm_tpu/parallel``): the device mesh,
serving replicas, and training ranks in a process group."""

from .group import DataGroup, GlobalDraws, attach, rand, randn, spawn
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, local_batch_size, make_mesh,
                   make_mesh_for_batch, replicate_state, resolve_mesh, shard_batch,
                   visible_devices)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DataGroup", "GlobalDraws", "Mesh", "attach",
           "local_batch_size", "make_mesh", "make_mesh_for_batch", "rand", "randn",
           "replicate_state", "resolve_mesh", "shard_batch", "spawn", "visible_devices"]
