"""Data parallelism over ``torch.distributed``: the port of the JAX
package's ``parallel`` module (:mod:`.mesh`) and the launcher of one process
per rank (:mod:`.launch`)."""

from stylex_tpu_torch.parallel.launch import launch, resolve_num_devices
from stylex_tpu_torch.parallel.mesh import (
    GRAD_ALL_REDUCE,
    Mesh,
    all_reduce_,
    all_reduce_grads,
    coordinate_sharding,
    data_sharding,
    gather,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "launch",
    "resolve_num_devices",
    "GRAD_ALL_REDUCE",
    "Mesh",
    "all_reduce_",
    "all_reduce_grads",
    "coordinate_sharding",
    "data_sharding",
    "gather",
    "make_mesh",
    "replicated",
    "shard_batch",
]
