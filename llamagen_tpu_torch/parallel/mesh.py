"""The device mesh and this rank's rows (PyTorch port of
`llamagen_tpu/parallel/mesh.py`).

Axes, as JAX names them:
  dp   - data parallel: parameters replicated, gradients all-reduced (DDP);
  fsdp - fully sharded data parallel: parameters sharded, gathered on use,
         gradients reduce-scattered (FSDP2 `fully_shard`, ZeRO-3, the
         reference's FULL_SHARD); both above 1: HSDP, replicated over dp
         and sharded over fsdp;
  tp   - tensor parallel: attention heads, the FFN hidden dim and the
         vocabulary sharded, Megatron's layout (`parallel/tp_decode.py`
         for serving, `parallel/partition.py::shard_gpt` for training).

The mesh is a `DeviceMesh` over every rank of the process group, dims
("dp", "fsdp", "tp"), tp innermost: the ranks of one TP group are adjacent
(global ranks r * tp .. r * tp + tp - 1), as JAX's `reshape(dp, fsdp,
tp)` places its devices. The batch splits over dp and fsdp only: the
ranks of a TP group hold the same rows. Each data-parallel rank holds the
rows of its stride of the global batch (`shard_batch` with
`data_rank_world`), which is what the data loaders give with `num_hosts`
= the data-parallel world and `host_id` = the data-parallel rank, so the
ranks together hold the one-process batch (JAX `put_batch` assembles the
same global array from the hosts' rows).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from llamagen_tpu_torch.parallel import distributed

MESH_AXES = ("dp", "fsdp", "tp")


def mesh_shape(dp: int, fsdp: int, tp: int,
               world: int) -> Tuple[int, int, int]:
    """(dp, fsdp, tp) for `world` ranks; one of them may be -1 to absorb
    the rest (JAX `make_mesh`). The product must equal the world size."""
    sizes = [dp, fsdp, tp]
    if sizes.count(-1) > 1:
        raise ValueError("at most one of dp, fsdp and tp may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known < 1 or world % known:
            raise ValueError(f"{world} ranks do not divide by {known}")
        sizes[sizes.index(-1)] = world // known
    if min(sizes) < 1 or int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {world} "
                         f"ranks")
    return sizes[0], sizes[1], sizes[2]


def make_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("dp", "fsdp", "tp") `DeviceMesh` over the process group's ranks."""
    shape = mesh_shape(dp, fsdp, tp, distributed.world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def tp_size(mesh: Optional[DeviceMesh]) -> int:
    """The mesh's TP degree; 1 without a mesh."""
    return 1 if mesh is None else mesh["tp"].size()


def data_rank_world(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(this rank's index among the data-parallel ranks, their number):
    the (dp, fsdp) coordinate flattened, dp * fsdp. The ranks of one TP
    group share it. Without a mesh: this process's rank and world size."""
    if mesh is None:
        return distributed.rank(), distributed.world_size()
    dp_i, fsdp_i, _ = mesh.get_coordinate()
    fsdp = mesh["fsdp"].size()
    return dp_i * fsdp + fsdp_i, mesh["dp"].size() * fsdp


def local_batch_size(global_batch: int, world: int) -> int:
    """Rows per rank; the global batch must divide by the world size (JAX
    `host_batch`)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide by "
                         f"{world} ranks")
    return global_batch // world


def rank_rows(x: Any, rank: int, world: int) -> Any:
    """Rows `rank::world` (numpy array or tensor; None passes)."""
    return None if x is None else x[rank::world]


def shard_batch(batch: Any, rank: int = None, world: int = None,
                mesh: Optional[DeviceMesh] = None) -> Any:
    """This rank's rows of a global batch: a tensor or array, or a
    NamedTuple of them (None fields pass). Defaults: the data-parallel
    rank and world of `mesh` (`data_rank_world`), without one this
    process's rank and the world size (one process: the batch itself)."""
    d_rank, d_world = data_rank_world(mesh)
    rank = d_rank if rank is None else rank
    world = d_world if world is None else world
    if world == 1:
        return batch
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(rank_rows(x, rank, world) for x in batch))
    return rank_rows(batch, rank, world)

