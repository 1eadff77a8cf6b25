"""Class-conditional GPT training step (PyTorch port of
`llamagen_tpu/train/c2i.py`): loss, backward, global-norm clip, AdamW,
EMA, in place on a `TrainState`, on one device or across the ranks of a
device mesh (`parallel/mesh.py`: DDP, FSDP2 or HSDP over (dp, fsdp),
`parallel/partition.py::shard_gpt`, and tensor parallelism over tp,
`parallel/tp_decode.py::shard_tp_params`).

Across ranks each data-parallel rank feeds its rows of the global batch
(`parallel/mesh.py::shard_batch`, JAX's `shard_batch` / `put_batch`; the
ranks of a TP group feed the same rows) and the step computes the
one-process step on that batch: DDP averages the gradients and FSDP2
reduce-scatters their mean, the global norm and clip span every shard
(a parameter whole on every TP rank counted once), the reported loss is
the mean over ranks, and t2i's `valid` weights divide by their global sum
(`gpt.forward_train`'s `group`).

One difference from JAX: JAX draws dropout masks (class, token, resid /
ffn, drop-path) for the global batch from one key; here each
data-parallel rank draws for its own rows from the stream of `seed *
world + rank` of its data-parallel rank and world (upstream's per-rank
seed), so the ranks' masks differ and a run's masks depend on the number
of data-parallel ranks. The ranks of a TP group draw alike, as the
activations they hold whole must agree. Without dropout the sharded step
equals one process's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.parallel.mesh import data_rank_world, tp_size
from llamagen_tpu_torch.parallel.partition import shard_gpt
from llamagen_tpu_torch.parallel.tp_decode import shard_tp_params
from llamagen_tpu_torch.train.train_state import (Optimizer, TrainState,
                                                  ema_update,
                                                  init_train_state)
from llamagen_tpu_torch.utils import profiling

StepFn = Callable[[TrainState, Any, int],
                  Tuple[TrainState, Dict[str, torch.Tensor]]]
# loss(model, batch, generator, compute_dtype, remat, group) -> scalar
# loss; `model` is the module to call, `group` the data-parallel group
LossFn = Callable[..., torch.Tensor]


class Batch(NamedTuple):
    """One training batch of pre-extracted codes."""
    labels: torch.Tensor   # [B] class ids
    tokens: torch.Tensor   # [B, block_size] code ids
    valid: Optional[torch.Tensor] = None  # [B] sample weights


def loss_fn(model: torch.nn.Module, batch: Batch,
            generator: Optional[torch.Generator],
            compute_dtype: torch.dtype = torch.bfloat16,
            remat: gpt.Remat = "full",
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Teacher-forced cross-entropy over the code grid, through the
    model's call (`gpt.Transformer.forward`)."""
    _, loss = model(batch.labels, batch.tokens[:, :-1], targets=batch.tokens,
                    valid=batch.valid, generator=generator, train=True,
                    compute_dtype=compute_dtype, remat=remat, group=group)
    return loss


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout stream of one step: a function of (seed, step) only, so
    a resumed run draws what an unbroken one would."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def rank_seed(seed: int, rank: int, world: int) -> int:
    """Each data-parallel rank's dropout seed (upstream's `global_seed *
    world_size + rank`, of the data-parallel rank and world: the ranks of
    a TP group share it); at one rank the seed itself."""
    return seed * world + rank


def make_train_step(ema_decay: Optional[float] = 0.9999,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: gpt.Remat = "full",
                    loss: LossFn = loss_fn,
                    mesh: Optional[DeviceMesh] = None) -> StepFn:
    """train_step(state, batch, seed) -> (state, {"loss", "grad_norm"}):
    one update in place; grad_norm is the norm before the clip. The
    metrics stay on the device (reading them waits for the step). `loss`
    is c2i's `loss_fn` or another of its signature (t2i's). With a `mesh`,
    `batch` is this rank's rows and the metrics are the global batch's."""
    group = None if mesh is None else dist.group.WORLD
    rank, world = (0, 1) if mesh is None else data_rank_world(mesh)
    n_ranks = 1 if mesh is None else dist.get_world_size()

    def train_step(state: TrainState, batch: Any, seed: int):
        state.optimizer.zero_grad()
        with profiling.span("train.forward", samples=len(batch[0])):
            value = loss(state.forward_module, batch,
                         step_generator(rank_seed(seed, rank, world),
                                        state.step),
                         compute_dtype, remat, group)
        # the thread blocks here while autograd launches the backward
        with profiling.span("train.backward"):
            value.backward()
        with profiling.span("train.update"):
            grad_norm = state.optimizer.step(state.step)
            if state.ema is not None and ema_decay is not None:
                ema_update(state.ema, state.model, ema_decay)
        state.step += 1
        value = value.detach()
        if group is not None:  # a TP group's ranks hold the same loss
            value = value.clone()
            dist.all_reduce(value)
            value /= n_ranks
        return state, {"loss": value, "grad_norm": grad_norm}

    return train_step


def build_trainer(cfg: GPTConfig, device: torch.device, *, lr: float = 1e-4,
                  weight_decay: float = 5e-2, beta1: float = 0.9,
                  beta2: float = 0.95, max_grad_norm: float = 1.0,
                  warmup_steps: int = 0, use_ema: bool = True,
                  ema_decay: float = 0.9999, seed: int = 0,
                  param_dtype: torch.dtype = torch.float32,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  remat: gpt.Remat = "full",
                  loss: LossFn = loss_fn,
                  mesh: Optional[DeviceMesh] = None,
                  weights: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[TrainState, StepFn]:
    """A seeded model (the reference init; `weights`, a state dict, in its
    place) on `device`, its optimizer and EMA, and the step function (of
    `loss`). With a `mesh` every rank builds the same model, keeps its TP
    shard where tp > 1 (`shard_tp_params`), then `shard_gpt` shards
    (FSDP2, HSDP) or wraps (DDP) it; the optimizer and EMA take the
    sharded parameters."""
    model = gpt.init_weights(gpt.Transformer(cfg, device=device,
                                             dtype=param_dtype), seed=seed)
    if weights is not None:
        model.load_state_dict(weights)
    if tp_size(mesh) > 1:
        shard_tp_params(model, mesh.get_local_rank("tp"), tp_size(mesh),
                        mesh["tp"].get_group())
    wrapper = None if mesh is None else shard_gpt(model, mesh)
    opt = Optimizer(model, lr, weight_decay, beta1, beta2, max_grad_norm,
                    warmup_steps)
    state = init_train_state(model, opt, use_ema=use_ema)
    state.mesh, state.wrapper = mesh, wrapper
    step_fn = make_train_step(ema_decay if use_ema else None, compute_dtype,
                              remat, loss, mesh)
    return state, step_fn
