"""Parallelism layer: the (data, model) device mesh over one process per
card, Megatron tensor-parallel sharding by parameter name, and the
collectives GSPMD inserts in the JAX package, written out."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    auto_mesh,
    axis_group,
    axis_index,
    axis_size,
    data_sharding,
    effective_platform_devices,
    make_mesh,
    replicated,
)
from .multihost import host_local_batch_slice, initialize_multihost
from .sharding import (
    gather_params,
    gather_rows,
    param_specs,
    shard_batch,
    shard_decode_inputs,
    shard_opt_state,
    shard_params,
)
__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "auto_mesh",
    "effective_platform_devices",
    "make_mesh",
    "replicated",
    "data_sharding",
    "axis_size",
    "axis_index",
    "axis_group",
    "param_specs",
    "shard_params",
    "shard_batch",
    "shard_decode_inputs",
    "shard_opt_state",
    "gather_params",
    "gather_rows",
    "initialize_multihost",
    "host_local_batch_slice",
]
