"""Class-conditional GPT training step on one device (PyTorch port).

Counterpart of `llamagen_tpu/train/c2i.py` without the mesh sharding: loss,
backward, global-norm clip, AdamW, EMA, in place on a `TrainState`.
Data and tensor parallelism (DDP / FSDP2) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.train.train_state import (Optimizer, TrainState,
                                                  ema_update,
                                                  init_train_state)

StepFn = Callable[[TrainState, Any, int],
                  Tuple[TrainState, Dict[str, torch.Tensor]]]
# loss(model, batch, generator, compute_dtype, remat) -> scalar loss
LossFn = Callable[[gpt.Transformer, Any, Optional[torch.Generator],
                   torch.dtype, gpt.Remat], torch.Tensor]


class Batch(NamedTuple):
    """One training batch of pre-extracted codes."""
    labels: torch.Tensor   # [B] class ids
    tokens: torch.Tensor   # [B, block_size] code ids
    valid: Optional[torch.Tensor] = None  # [B] sample weights


def loss_fn(model: gpt.Transformer, batch: Batch,
            generator: Optional[torch.Generator],
            compute_dtype: torch.dtype = torch.bfloat16,
            remat: gpt.Remat = "full") -> torch.Tensor:
    """Teacher-forced cross-entropy over the code grid."""
    _, loss = gpt.forward_train(
        model, batch.labels, batch.tokens[:, :-1], targets=batch.tokens,
        valid=batch.valid, generator=generator, train=True,
        compute_dtype=compute_dtype, remat=remat)
    return loss


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout stream of one step: a function of (seed, step) only, so
    a resumed run draws what an unbroken one would."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def make_train_step(ema_decay: Optional[float] = 0.9999,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: gpt.Remat = "full",
                    loss: LossFn = loss_fn) -> StepFn:
    """train_step(state, batch, seed) -> (state, {"loss", "grad_norm"}):
    one update in place; grad_norm is the norm before the clip. The
    metrics stay on the device (reading them waits for the step). `loss`
    is c2i's `loss_fn` or another of its signature (t2i's)."""

    def train_step(state: TrainState, batch: Any, seed: int):
        state.optimizer.zero_grad()
        value = loss(state.model, batch, step_generator(seed, state.step),
                     compute_dtype, remat)
        value.backward()
        grad_norm = state.optimizer.step(state.step)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, state.model, ema_decay)
        state.step += 1
        return state, {"loss": value.detach(), "grad_norm": grad_norm}

    return train_step


def build_trainer(cfg: GPTConfig, device: torch.device, *, lr: float = 1e-4,
                  weight_decay: float = 5e-2, beta1: float = 0.9,
                  beta2: float = 0.95, max_grad_norm: float = 1.0,
                  warmup_steps: int = 0, use_ema: bool = True,
                  ema_decay: float = 0.9999, seed: int = 0,
                  param_dtype: torch.dtype = torch.float32,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  remat: gpt.Remat = "full",
                  loss: LossFn = loss_fn) -> Tuple[TrainState, StepFn]:
    """A seeded model (the reference init) on `device`, its optimizer and
    EMA, and the step function (of `loss`)."""
    model = gpt.init_weights(gpt.Transformer(cfg, device=device,
                                             dtype=param_dtype), seed=seed)
    opt = Optimizer(model, lr, weight_decay, beta1, beta2, max_grad_norm,
                    warmup_steps)
    state = init_train_state(model, opt, use_ema=use_ema)
    step_fn = make_train_step(ema_decay if use_ema else None, compute_dtype,
                              remat, loss)
    return state, step_fn
