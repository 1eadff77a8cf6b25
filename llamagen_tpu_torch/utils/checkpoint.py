"""Train-state checkpoints (counterpart of `llamagen_tpu/utils/checkpoint.py`,
orbax).

One process: `torch.save` of {step, model, optimizer, ema} as
`ckpt_dir/step_XXXXXXXX.pt`, written under a temporary name and renamed,
so an interrupted save never leaves a truncated checkpoint under its final
name. `save_vq_step` writes a VQ-GAN train state the same way, its VQ
model's upstream state dict under "model", so the step file loads as a
tokenizer (`cli/common.py::load_vq(path, encoder=True)`).

Under a process group (a state with a `mesh`): a `torch.distributed
.checkpoint` (DCP) directory `ckpt_dir/step_XXXXXXXX/`, every rank writing
its shards of the model, optimizer and EMA (`get_state_dict`, keyed by
parameter name, not by optimizer index), beside the step and the VQ
trainer's usage window; a directory counts only once DCP has written its
`.metadata`, so an interrupted save is never resumed from. Loading reshards, as orbax's restore does: a
checkpoint of one world size resumes at another, or in one process.
`save_full_model` writes the whole model state dict (upstream keys) from
rank 0, which `cli/common.py::load_gpt` / `load_vq` load unchanged.

Tensor parallelism: a TP rank's model, optimizer and EMA entries are its
own shards under the same names as the other TP ranks', so DCP would take
them for replicas; they are saved under a `tp{r}.` scope of their own.
Such a checkpoint resumes at the same tp (resharding to another tp is not
done). `save_full_model` gathers the TP shards and writes the whole model
in upstream's `[Q | K | V]` layout.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                     get_model_state_dict,
                                                     get_state_dict,
                                                     set_state_dict)

from llamagen_tpu_torch.parallel.tp_decode import whole_tp_state
from llamagen_tpu_torch.train.train_state import TrainState
from llamagen_tpu_torch.train.vq import VQTrainState

_NAME = re.compile(r"step_(\d+)(\.pt)?$")
State = Union[TrainState, VQTrainState]


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _save(ckpt_dir: str, step: int, payload: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step) + ".pt"
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _modules(state: State):
    """(name, module, optimizer) of each trained model of the state."""
    out = [("model", state.model, state.optimizer)]
    if isinstance(state, VQTrainState):
        out.append(("discriminator", state.disc, state.disc_optimizer))
    return out


def _tp_scope(state: State) -> Optional[str]:
    """`tp{r}` for a TP rank's state, else None."""
    tp = getattr(state.model, "tp_size", 1)
    return f"tp{state.model.tp_rank}" if tp > 1 else None


def _sharded(state: State) -> Dict[str, Any]:
    """The state as DCP saves and loads it (tensors are the live ones, so
    `dcp.load` fills them in place); a TP rank's entries under its scope."""
    sd: Dict[str, Any] = {"step": state.step}
    own: Dict[str, Any] = {}
    for name, module, opt in _modules(state):
        msd, osd = get_state_dict(module, opt.opt)
        own[name], own[f"optimizer_{name}"] = msd, osd
    if state.ema is not None:
        own["ema"] = state.ema
    scope = _tp_scope(state)
    if scope is None:
        sd.update(own)
    else:
        sd[scope] = own
    if isinstance(state, VQTrainState):
        sd["usage_window"] = state.usage_window
    return sd


def _save_sharded(ckpt_dir: str, step: int, state: State) -> str:
    path = _path(ckpt_dir, step)
    dcp.save(_sharded(state), checkpoint_id=path)
    return path


def save_step(ckpt_dir: str, step: int, state: TrainState) -> str:
    if state.mesh is not None:
        return _save_sharded(ckpt_dir, step, state)
    return _save(ckpt_dir, step, {
        "step": state.step, "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(), "ema": state.ema})


def save_vq_step(ckpt_dir: str, step: int, state: VQTrainState) -> str:
    """Both models (the discriminator under upstream's "discriminator"),
    both optimizers, the EMA, the step count and the usage window."""
    if state.mesh is not None:
        return _save_sharded(ckpt_dir, step, state)
    return _save(ckpt_dir, step, {
        "step": state.step, "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "discriminator": state.disc.state_dict(),
        "optimizer_disc": state.disc_optimizer.state_dict(),
        "ema": state.ema, "usage_window": state.usage_window})


def save_full_model(path: str, state: State) -> Optional[str]:
    """The whole model state dict {"step", "model"} (upstream keys, on the
    CPU) written by rank 0 as a `.pt`; every rank must call it (FSDP2
    gathers the shards, a TP group its ranks' shards: `whole_tp_state`).
    Returns the path on rank 0, else None."""
    if _tp_scope(state) is None:
        sd = get_model_state_dict(state.model, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
    else:
        sd = whole_tp_state(state.model, get_model_state_dict(
            state.model, options=StateDictOptions(full_state_dict=True)))
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"step": state.step, "model": sd}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _complete(path: str) -> bool:
    """A `.pt` file, or a DCP directory whose save finished: DCP writes
    `.metadata` last (after every rank's shards, renamed into place), so a
    directory without it is an interrupted save."""
    if os.path.isdir(path):
        return os.path.isfile(os.path.join(path, ".metadata"))
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step of `ckpt_dir`: a `.pt` file or a DCP directory that
    was saved in full."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
             if m and _complete(os.path.join(ckpt_dir, m.group(0)))]
    return max(steps) if steps else None


def _restore_sharded(path: str, state: State) -> None:
    sd = _sharded(state)
    dcp.load(sd, checkpoint_id=path)
    scope = _tp_scope(state)
    own = sd if scope is None else sd[scope]
    for name, module, opt in _modules(state):
        set_state_dict(module, opt.opt, model_state_dict=own[name],
                       optim_state_dict=own[f"optimizer_{name}"])
    state.step = int(sd["step"])
    if isinstance(state, VQTrainState):
        state.usage_window = sd["usage_window"]


def _restore_file(path: str, state: TrainState) -> None:
    if state.mesh is not None:
        raise ValueError(f"{path} is a one-process checkpoint; a sharded "
                         f"run resumes from a DCP directory")
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.ema is not None:
        if ckpt["ema"] is None:
            raise ValueError("the checkpoint holds no EMA")
        with torch.no_grad():
            for name, value in ckpt["ema"].items():
                state.ema[name].copy_(value)
    state.step = ckpt["step"]


def restore_latest(ckpt_dir: str, state: State
                   ) -> Tuple[Optional[int], Optional[State]]:
    """Load the newest checkpoint INTO `state` (its models, optimizers,
    EMA, step and usage window, on their devices and in their sharding);
    (None, None) when there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = _path(ckpt_dir, step)
    if os.path.isfile(os.path.join(path, ".metadata")):
        _restore_sharded(path, state)
    else:
        _restore_file(path + ".pt", state)
    return step, state
