"""Data-parallel and row-partitioned training over ``torch.distributed``
(PyTorch port of ``ecologysemanticsegmentation_tpu/parallel``): the
``(data, model)`` rank grid and the collectives, with gradients, that the
step runs."""

from .collectives import all_gather_rows, all_reduce_grads, all_reduce_sum, halo_exchange
from .mesh import (
    Mesh,
    Spatial,
    batch_block,
    broadcast_state,
    create_mesh,
    local_batch_to_global,
    row_block,
    shard_batch,
)

__all__ = [
    "Mesh", "Spatial", "all_gather_rows", "all_reduce_grads", "all_reduce_sum",
    "batch_block", "broadcast_state", "create_mesh", "halo_exchange",
    "local_batch_to_global", "row_block", "shard_batch",
]
