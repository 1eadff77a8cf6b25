"""How each model spreads over the mesh (PyTorch port of
`llamagen_tpu/parallel/partition.py`).

JAX writes a PartitionSpec per parameter (`gpt_param_specs`,
`vq_param_specs`) and lets XLA insert the collectives. PyTorch wraps
modules instead:

- `shard_gpt` (JAX `gpt_param_specs`): FSDP2 `fully_shard` on every
  `TransformerBlock`, then on the root (embeddings, norm, head), so one
  block's parameters are gathered at a time (the reference's FULL_SHARD
  wrapping of its blocks); HSDP on the (dp, fsdp) mesh when dp and fsdp
  are both above 1; DDP when only dp is. FSDP2 shards each parameter
  along its dim 0, where JAX shards a layer's input features: the layout
  changes which rank holds which element, not a value, because every
  parameter is gathered whole before use and each gradient is the mean
  over ranks either way.
- Tensor parallelism (JAX's `tp` entries) comes first: the model a rank
  wraps is already its TP shard (`parallel/tp_decode.py::shard_tp_params`:
  wqkv head-major and w1 / w3 column-sharded, wo / w2 row-sharded, the
  head over the vocabulary, norms and embeddings whole), whose forward
  runs Megatron's conjugate collectives over the TP group
  (`parallel/collectives.py`: `copy_to_tp`, `reduce_from_tp`,
  `gather_from_tp`). FSDP2,
  HSDP or DDP then shard or replicate those shards over the (dp, fsdp)
  ranks that hold the same TP rank. JAX shards the embeddings' features
  over tp too; here they stay whole, which moves no value (GSPMD's values
  do not depend on the layout). A (1, 1, tp) mesh has no data-parallel
  ranks: nothing is wrapped.
- `replicate_vq` (JAX `vq_param_specs`: replicate everything): the VQ
  model and the discriminator stay whole on every rank; `mean_gradients`
  all-reduces their gradients after each backward. Not DDP: the VQ-GAN
  step runs the discriminator three times per update (once frozen) and
  takes `torch.autograd.grad` of two loss terms with a retained graph,
  while DDP's reducer expects one backward for each forward.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.nn.parallel import DistributedDataParallel

BUCKET_BYTES = 64 << 20  # gradients per all-reduce in `mean_gradients`


def shard_gpt(model: nn.Module, mesh: DeviceMesh) -> Optional[nn.Module]:
    """Shard or replicate a `gpt.Transformer` in place over `mesh`.

    dp == 1: `fully_shard` over the fsdp ranks (at one rank FSDP2 only
    copies); dp, fsdp > 1: HSDP; fsdp == 1 < dp: DDP over the dp ranks;
    dp == fsdp == 1 < tp: nothing (the TP shard is the whole of what the
    rank holds). `model` is the rank's TP shard where tp > 1. Returns the
    DDP module that runs `model`'s forward, or None where `model` itself
    is called (FSDP2 hooks its own `__call__`)."""
    dp, fsdp = mesh["dp"].size(), mesh["fsdp"].size()
    if dp * fsdp == 1 and mesh["tp"].size() > 1:
        return None
    if fsdp == 1 and dp > 1:
        dev = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=mesh["dp"].get_group(),
            find_unused_parameters=_has_optional_parameters(model))
    shard_mesh = mesh["dp", "fsdp"] if dp > 1 else mesh["fsdp"]
    for layer in model.layers:
        fully_shard(layer, mesh=shard_mesh)
    fully_shard(model, mesh=shard_mesh)
    return None


def _has_optional_parameters(model: nn.Module) -> bool:
    """A t2i model uses its null caption only under class dropout."""
    cfg = model.cfg
    return cfg.model_type == "t2i" and cfg.class_dropout_prob == 0


def replicate_vq(modules: Iterable[nn.Module]) -> None:
    """Make every rank hold rank 0's parameters and buffers of each module
    (the seeded inits already agree; this guards a run against one that
    does not)."""
    for module in modules:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)


@torch.no_grad()
def mean_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in
    buckets of up to `BUCKET_BYTES` (a missing gradient counts as 0, as the
    optimizer's update does)."""
    buckets: List[List[torch.Tensor]] = [[]]
    size = 0
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        if buckets[-1] and (size + g.nbytes > BUCKET_BYTES
                            or g.dtype != buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.nbytes
    world = dist.get_world_size()
    for bucket in filter(None, buckets):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat /= world
        for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(v.view_as(g))
