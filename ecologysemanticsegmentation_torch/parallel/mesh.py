"""The ``(data, model)`` rank grid (PyTorch port of
``ecologysemanticsegmentation_tpu/parallel/mesh.py``).

The JAX package lays its devices out on a ``jax.sharding.Mesh`` and lets
GSPMD partition the step; here every rank is one process of an initialized
``torch.distributed`` world, and the step's collectives are written out
(:mod:`.collectives`).  Ranks form a ``(data, model)`` grid with ``model``
varying fastest, as the JAX mesh's devices do: rank ``r`` sits at
``(r // model, r % model)``.

* ``data`` splits the batch; the ranks of one data group hold one block of
  images.
* ``model`` splits image rows (``--spatial_partition``): the ranks of one
  model group hold the row blocks of the same images.  A ``(data, 1)`` grid
  is plain data parallelism.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Spatial:
    """What a module needs to run on this rank's part of a batch.

    ``stats_group``: the group over which BatchNorm sums are all-reduced
    (the world: every rank holds a part of the global batch).
    ``row_group``: the ranks holding the other row blocks of this rank's
    images, with this rank's block ``row_index`` of ``row_count``; None where
    a module sees whole images (a ``(data, 1)`` grid, or a stage whose rows
    were gathered)."""

    stats_group: dist.ProcessGroup
    row_group: dist.ProcessGroup | None = None
    row_index: int = 0
    row_count: int = 1

    def whole_rows(self) -> "Spatial":
        """The same statistics group, with whole images."""
        return dataclasses.replace(self, row_group=None, row_index=0, row_count=1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` grid and the groups it
    communicates in: ``world`` (every rank), ``data_group`` (the ranks of
    this rank's model index: one per batch block) and ``model_group`` (the
    ranks of this rank's data index: the row blocks of one batch block).
    ``device`` is this rank's device."""

    data: int
    model: int
    rank: int
    device: torch.device
    world: dist.ProcessGroup
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def spatial(self) -> Spatial:
        """The partition the model runs under: statistics over the world,
        rows over the model group when it has more than one rank."""
        if self.model == 1:
            return Spatial(self.world)
        return Spatial(self.world, self.model_group, self.model_index, self.model)


def create_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The ``(world // model_parallel, model_parallel)`` grid over the
    initialized default process group, for this rank on ``device`` (CUDA
    unless ``device="cpu"``).  Every rank must call it, in the same order
    as its other group creations: ``new_group`` is collective."""
    from .. import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialized torch.distributed process group")
    world_size, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world_size % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world of "
                         f"{world_size} ranks")
    data = world_size // model_parallel
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model_groups = [dist.new_group([d * model_parallel + m for m in range(model_parallel)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model_parallel + m for d in range(data)])
                   for m in range(model_parallel)]
    return Mesh(data=data, model=model_parallel, rank=rank, device=dev,
                world=dist.group.WORLD, data_group=data_groups[rank % model_parallel],
                model_group=model_groups[rank // model_parallel])


def local_batch_to_global(batch_size: int, mesh: Mesh) -> int:
    """Round a requested batch size up to a multiple of the data axis."""
    return int(math.ceil(batch_size / mesh.data) * mesh.data)


def batch_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global batch (leading axis) ``x``."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"batch {n} does not split over {mesh.data} data ranks")
    per = n // mesh.data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def row_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows (axis 1, NHWC) of ``x``."""
    rows = x.shape[1]
    if rows % mesh.model:
        raise ValueError(f"{rows} rows do not split over {mesh.model} model ranks")
    per = rows // mesh.model
    return x[:, mesh.model_index * per:(mesh.model_index + 1) * per]


def shard_batch(x: torch.Tensor, mesh: Mesh, spatial: bool = False) -> torch.Tensor:
    """This rank's ``(batch, rows)`` block of the global NHWC batch ``x``
    (the counterpart of ``batch_sharding(mesh, spatial)``): the batch block
    of its data index, and with ``spatial`` the row block of its model
    index."""
    x = batch_block(x, mesh)
    return row_block(x, mesh) if spatial else x


@torch.no_grad()
def broadcast_state(module: torch.nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s (the
    counterpart of ``replicated_sharding``)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=mesh.world)


__all__ = [
    "Mesh", "Spatial", "batch_block", "broadcast_state", "create_mesh",
    "local_batch_to_global", "row_block", "shard_batch",
]
