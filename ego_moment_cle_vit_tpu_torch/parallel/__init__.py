"""Data x model parallelism on ``torch.distributed``: the mesh, the sharding
rules, the collectives the model needs, and the mesh context the
batch-mixing layers read."""

from .collectives import copy_to_model, gather_batch, reduce_from_model, sum_over_data
from .mesh import Mesh, create_mesh, local_device_count, mesh_shape
from .shard_kernels import active_kernel_mesh, check_local_batch, kernel_mesh
from .sharding import (
    DEFAULT_RULES,
    gather_params,
    load_params,
    param_sharding_rules,
    param_specs,
    replicate,
    shard_params,
    sharded_params,
)

__all__ = [
    "DEFAULT_RULES",
    "Mesh",
    "active_kernel_mesh",
    "check_local_batch",
    "copy_to_model",
    "create_mesh",
    "gather_batch",
    "gather_params",
    "kernel_mesh",
    "load_params",
    "local_device_count",
    "mesh_shape",
    "param_sharding_rules",
    "param_specs",
    "reduce_from_model",
    "replicate",
    "shard_params",
    "sharded_params",
    "sum_over_data",
]
