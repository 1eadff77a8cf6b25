"""Optimizer and train state of the GPT trainer (PyTorch port).

Counterpart of `llamagen_tpu/train/train_state.py`, with optax's semantics:
`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1, b2,
weight_decay, mask=decay_mask))`.

- The clip scales every gradient by `max_norm / norm` only when the global
  norm is at least `max_norm`, as `(g / norm) * max_norm`; it adds no
  `1e-6` as `torch.nn.utils.clip_grad_norm_` does, so it is written out.
- AdamW (`torch.optim.AdamW`, two parameter groups) decays only the names
  `decay_mask` admits: not norms, scales or biases; embeddings and the head
  decay. Decay is decoupled and scaled by the learning rate, as in optax.
- Gradients sharded by FSDP2 are `DTensor`s: the global norm sums over
  their shards and the clip scales each rank's shard (`global_norm`).
  A TP shard's sharded parameters (`tp_decode.is_tp_sharded`) add their
  squares over the TP group; the ones every TP rank holds whole (norms,
  embeddings) count once.
- With `warmup_steps > 0` the learning rate is `optax.linear_schedule(0,
  lr, warmup_steps)` of the number of earlier updates, so the first update
  has learning rate 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from llamagen_tpu_torch.parallel.tp_decode import is_tp_sharded


def decay_mask(name: str) -> bool:
    """True where weight decay applies (JAX `_no_decay` on the same
    names: upstream keys such as `layers.0.attention_norm.weight`)."""
    return not ("norm" in name or "scale" in name or name.endswith("bias"))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view: writes reach the DTensor),
    or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_groups(t: torch.Tensor):
    """The process groups over which a DTensor's shards split its
    elements (FSDP2: the fsdp dim; HSDP's dp dim holds replicas)."""
    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.get_group(d) for d, pl in enumerate(t.placements)
                 if pl.is_shard() and mesh.size(d) > 1)


def global_norm(tensors: List[torch.Tensor],
                tp_sharded: Optional[List[bool]] = None,
                tp_group: Optional[dist.ProcessGroup] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32, on the device;
    the sums in f64, so that a norm over shards equals the one over the
    whole tensor: the CPU's f32 sum over a 16384 x 128 gradient is off by
    ~4e-4).

    Sharded tensors (FSDP2 `DTensor`s) count every shard: each tensor's
    squared norm is summed over the ranks that shard it (one all-reduce),
    so every rank gets the one-process norm; plain tensors (one process,
    DDP's all-reduced gradients) need no collective. With a `tp_group`,
    the squares of the tensors `tp_sharded` marks are summed over it too
    (the others are whole on every TP rank, and count once)."""
    norms = [torch.linalg.vector_norm(_local(t), dtype=torch.float64)
             for t in tensors]
    groups = [_shard_groups(t) for t in tensors]
    sharded = [i for i, g in enumerate(groups) if g]
    if sharded:
        # by their ranks: DTensor's cached sharding may hand a gradient the
        # mesh of an earlier trainer in this process, equal but not the same
        if len({tuple(map(tuple, map(dist.get_process_group_ranks,
                                     groups[i]))) for i in sharded}) > 1:
            raise ValueError("the tensors are sharded over different groups")
        sq = torch.stack([norms[i] for i in sharded]) ** 2
        for group in groups[sharded[0]]:
            dist.all_reduce(sq, group=group)
        for i, v in zip(sharded, sq.sqrt()):
            norms[i] = v
    if tp_group is None:
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    sq = torch.stack(norms) ** 2
    mask = torch.tensor(tp_sharded, device=sq.device)
    part = sq[mask].sum()
    dist.all_reduce(part, group=tp_group)
    return (part + sq[~mask].sum()).sqrt().float()


class Optimizer:
    """Global-norm clip + AdamW with a linear warmup over a module's
    parameters; `step(count)` updates them in place from their `.grad`."""

    def __init__(self, model: nn.Module, lr: float = 1e-4,
                 weight_decay: float = 5e-2, beta1: float = 0.9,
                 beta2: float = 0.95, max_grad_norm: float = 1.0,
                 warmup_steps: int = 0):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        # the parameters' names in the order of the optimizer's indices
        # (its state_dict's "state" keys): the decayed group, then the rest
        self.names = ([n for n, _ in named if decay_mask(n)]
                      + [n for n, _ in named if not decay_mask(n)])
        self.tp_group = getattr(model, "tp_group", None)
        self.tp_sharded = [is_tp_sharded(n) for n, _ in named]
        self.lr, self.warmup_steps = lr, warmup_steps
        self.max_grad_norm = max_grad_norm
        self.opt = torch.optim.AdamW(
            [{"params": [p for n, p in named if decay_mask(n)],
              "weight_decay": weight_decay},
             {"params": [p for n, p in named if not decay_mask(n)],
              "weight_decay": 0.0}],
            lr=lr, betas=(beta1, beta2), eps=1e-8)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after `count` earlier ones."""
        if self.warmup_steps <= 0:
            return self.lr
        return self.lr * min(count, self.warmup_steps) / self.warmup_steps

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        """Clip the gradients, then one AdamW update; returns the global
        norm of the gradients before the clip."""
        for p in self.params:  # optax updates every leaf, unused ones too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads, self.tp_sharded, self.tp_group)
        keep = norm < self.max_grad_norm
        for g in map(_local, grads):
            g.copy_(torch.where(keep, g, g / norm * self.max_grad_norm))
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(count)
        self.opt.step()
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state)


@dataclass
class TrainState:
    """The model (f32 master weights), its optimizer, the EMA copy of the
    parameters (by name) and the number of updates taken.

    Across ranks: `mesh` is the device mesh; `model` holds this rank's
    parameters under their own names (FSDP2: `DTensor` shards, and the
    EMA is sharded alike; DDP: whole), and `wrapper` is the DDP module
    that runs its forward (None where `model` itself is called)."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    mesh: Optional[DeviceMesh] = None
    wrapper: Optional[nn.Module] = None

    @property
    def forward_module(self) -> nn.Module:
        """The module whose call runs the training forward."""
        return self.model if self.wrapper is None else self.wrapper


def init_train_state(model: nn.Module, optimizer: Optimizer,
                     use_ema: bool = False) -> TrainState:
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if use_ema else None)
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               decay: float = 0.9999) -> None:
    """Polyak averaging in place: e = e * decay + p * (1 - decay)."""
    names = list(ema)
    params = dict(model.named_parameters())
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].to(ema[n].dtype) for n in names],
                        alpha=1.0 - decay)
