"""Train-state checkpoints: `torch.save` of {step, model, optimizer, ema}.

Counterpart of `llamagen_tpu/utils/checkpoint.py` (orbax) for one device:
`ckpt_dir/step_XXXXXXXX.pt`, written under a temporary name and renamed,
so an interrupted save never leaves a truncated checkpoint under its final
name. `save_vq_step` writes a VQ-GAN train state the same way, its VQ
model's upstream state dict under "model", so the step file loads as a
tokenizer (`cli/common.py::load_vq(path, encoder=True)`).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from llamagen_tpu_torch.train.train_state import TrainState
from llamagen_tpu_torch.train.vq import VQTrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


def _save(ckpt_dir: str, step: int, payload: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_step(ckpt_dir: str, step: int, state: TrainState) -> str:
    return _save(ckpt_dir, step, {
        "step": state.step, "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(), "ema": state.ema})


def save_vq_step(ckpt_dir: str, step: int, state: VQTrainState) -> str:
    """Both models (the discriminator under upstream's "discriminator"),
    both optimizers, the EMA, the step count and the usage window."""
    return _save(ckpt_dir, step, {
        "step": state.step, "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "discriminator": state.disc.state_dict(),
        "optimizer_disc": state.disc_optimizer.state_dict(),
        "ema": state.ema, "usage_window": state.usage_window})


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
             if m]
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str, state: TrainState
                   ) -> Tuple[Optional[int], Optional[TrainState]]:
    """Load the newest checkpoint INTO `state` (its model, optimizer and
    EMA, on their devices); (None, None) when there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    dev = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(ckpt_dir, f"step_{step:08d}.pt"),
                      map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.ema is not None:
        if ckpt["ema"] is None:
            raise ValueError("the checkpoint holds no EMA")
        with torch.no_grad():
            for name, value in ckpt["ema"].items():
                state.ema[name].copy_(value)
    state.step = ckpt["step"]
    return step, state
