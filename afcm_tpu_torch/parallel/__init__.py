"""Parallelism of the port (``afcm_tpu/parallel``): the device mesh,
serving replicas, training ranks in a process group over the data axis,
and tensor parallelism over the model axis (``tensor``)."""

from .group import DataGroup, GlobalDraws, attach, rand, randn, spawn
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, local_batch_size, make_mesh,
                   make_mesh_for_batch, replicate_state, resolve_mesh, shard_batch,
                   visible_devices)
from .tensor import (ModelGroup, full_state_dict, infer_param_sharding,
                     load_full_state_dict, make_groups, shard_module)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DataGroup", "GlobalDraws", "Mesh", "ModelGroup",
           "attach", "full_state_dict", "infer_param_sharding", "load_full_state_dict",
           "local_batch_size", "make_groups", "make_mesh", "make_mesh_for_batch",
           "rand", "randn", "replicate_state", "resolve_mesh",
           "shard_batch", "shard_module", "spawn", "visible_devices"]
