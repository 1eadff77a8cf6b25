"""Text-conditional GPT training step (PyTorch port of
`llamagen_tpu/train/t2i.py`), on one device or across the ranks of a mesh.

Images are tokenized inside the step by a frozen VQ model (online, under
`torch.no_grad()`), captions are precomputed T5 features multiplied by
their masks, and `valid` zeroes the loss of bad samples. The VQ model is
an argument of the step, not part of the train state: it is in no
optimizer, EMA or checkpoint. The update itself (clip, AdamW, EMA, the
dropout stream of `step_generator`) is `train/c2i.py`'s, and so is its
sharding: across ranks the frozen VQ is whole on every rank and encodes
only that rank's images, and the `valid`-weighted loss divides by the
weights summed over every rank, so that bad samples falling unevenly
across ranks still give the global weighted mean of one process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.models.vq import VQModel
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.train.train_state import TrainState


class T2IBatch(NamedTuple):
    images: torch.Tensor      # [B, H, W, 3] in [-1, 1]
    captions: torch.Tensor    # [B, T, caption_dim] T5 features, left-padded
    emb_masks: torch.Tensor   # [B, T] 1 = a caption token
    valid: Optional[torch.Tensor] = None  # [B] 1 = a good sample


def loss_fn(model: torch.nn.Module, vq_model: VQModel, batch: T2IBatch,
            generator: Optional[torch.Generator],
            compute_dtype: torch.dtype = torch.bfloat16,
            remat: gpt.Remat = "full",
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Teacher-forced cross-entropy over the image's codes (JAX
    `t2i_loss_fn`). The frozen VQ encodes the images, cast to the compute
    dtype, without a graph; the caption features are multiplied by their
    masks. The attention mask stays purely causal, as JAX's training
    forward: caption validity lives in the zeroed features. `model` is the
    module to call; `group` the data-parallel group (`c2i.loss_fn`)."""
    with torch.no_grad():
        idx = vq_model.encode(batch.images.to(compute_dtype))[2]
    tokens = idx.reshape(idx.shape[0], -1)
    captions = batch.captions * batch.emb_masks[..., None].to(
        batch.captions.dtype)
    _, loss = model(captions, tokens[:, :-1], targets=tokens,
                    valid=batch.valid, generator=generator, train=True,
                    compute_dtype=compute_dtype, remat=remat, group=group)
    return loss


def _vq_loss(vq_model: VQModel, compute_dtype: torch.dtype) -> c2i.LossFn:
    """`loss_fn` with `vq_model` bound, as `c2i.make_train_step` calls a
    loss; the VQ model must be whole and in the compute dtype."""
    dtype = vq_model.post_quant_conv.weight.dtype
    if vq_model.encoder is None or dtype != compute_dtype:
        got = "a decode half" if vq_model.encoder is None else dtype
        raise ValueError(f"the t2i step needs the whole VQ model in the "
                         f"compute dtype {compute_dtype} (got {got})")

    def loss(model, batch, generator, dtype, remat, group=None):
        return loss_fn(model, vq_model, batch, generator, dtype, remat,
                       group)

    return loss


def make_train_step(vq_model: VQModel, ema_decay: Optional[float] = 0.9999,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: gpt.Remat = "full",
                    mesh: Optional[DeviceMesh] = None) -> c2i.StepFn:
    """train_step(state, batch, seed) -> (state, {"loss", "grad_norm"}):
    `c2i.make_train_step`'s update on `loss_fn` over the frozen
    `vq_model` (with a `mesh`, on this rank's rows)."""
    return c2i.make_train_step(ema_decay, compute_dtype, remat,
                               _vq_loss(vq_model, compute_dtype), mesh)


def build_trainer(cfg: GPTConfig, vq_model: VQModel, device: torch.device,
                  *, compute_dtype: torch.dtype = torch.bfloat16,
                  **kw) -> Tuple[TrainState, c2i.StepFn]:
    """A seeded t2i model (the reference init) on `device`, its optimizer
    and EMA, and the step function over the frozen `vq_model`; the other
    keywords (lr, weight_decay, beta1, beta2, max_grad_norm, warmup_steps,
    use_ema, ema_decay, seed, param_dtype, remat, mesh, weights) are
    `c2i.build_trainer`'s."""
    return c2i.build_trainer(cfg, device, compute_dtype=compute_dtype,
                             loss=_vq_loss(vq_model, compute_dtype), **kw)
