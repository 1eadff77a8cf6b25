"""The data-parallel device mesh and this rank's rows (PyTorch port of
`llamagen_tpu/parallel/mesh.py`).

Axes, as JAX names them:
  dp   - data parallel: parameters replicated, gradients all-reduced (DDP);
  fsdp - fully sharded data parallel: parameters sharded, gathered on use,
         gradients reduce-scattered (FSDP2 `fully_shard`, ZeRO-3, the
         reference's FULL_SHARD); both above 1: HSDP, replicated over dp
         and sharded over fsdp;
  tp   - tensor parallel: not ported for training (ROADMAP item 9).

The mesh is a `DeviceMesh` over every rank of the process group, dims
("dp", "fsdp"). The batch splits over both axes: each rank holds the rows
of its stride of the global batch (`shard_batch`), which is what the data
loaders give with `num_hosts = world size` and `host_id = rank`, so the
ranks together hold the one-process batch (JAX `put_batch` assembles the
same global array from the hosts' rows).
"""

from __future__ import annotations

from typing import Any, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from llamagen_tpu_torch.parallel import distributed

MESH_AXES = ("dp", "fsdp")
TP_REFUSAL = ("tensor-parallel training (--tp > 1) is not ported: "
              "ROADMAP.md, Queue 1 item 9")


def mesh_shape(dp: int, fsdp: int, tp: int, world: int) -> Tuple[int, int]:
    """(dp, fsdp) for `world` ranks; one of them may be -1 to absorb the
    rest (JAX `make_mesh`). The product must equal the world size."""
    if tp != 1:
        raise NotImplementedError(TP_REFUSAL)
    sizes = [dp, fsdp]
    if sizes.count(-1) > 1:
        raise ValueError("at most one of dp and fsdp may be -1")
    if -1 in sizes:
        known = sizes[1 - sizes.index(-1)]
        if known < 1 or world % known:
            raise ValueError(f"{world} ranks do not divide by {known}")
        sizes[sizes.index(-1)] = world // known
    if min(sizes) < 1 or sizes[0] * sizes[1] != world:
        raise ValueError(f"mesh {sizes[0]}x{sizes[1]} != {world} ranks")
    return sizes[0], sizes[1]


def make_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("dp", "fsdp") `DeviceMesh` over the process group's ranks."""
    shape = mesh_shape(dp, fsdp, tp, distributed.world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


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


def shard_batch(batch: Any, rank: int = None, world: int = None) -> Any:
    """This rank's rows of a global batch: a tensor or array, or a
    NamedTuple of them (None fields pass). Defaults: this process's rank
    and the world size (one process: the batch itself)."""
    rank = distributed.rank() if rank is None else rank
    world = distributed.world_size() if world is None else world
    if world == 1:
        return batch
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(rank_rows(x, rank, world) for x in batch))
    return rank_rows(batch, rank, world)

