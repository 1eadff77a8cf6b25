"""Train-state checkpoints (counterpart of `llamagen_tpu/utils/checkpoint.py`,
orbax).

A checkpoint holds the state in one layout, whatever the layout of the run
that wrote it: every tensor whole and in upstream's layout (wqkv in
[Q | K | V]), the Adam moments by parameter name. So, as orbax's restore
does, a state saved at any (dp, fsdp, tp) resumes at any other the model
allows (`build_trainer` refuses the others before any load), and a
one-process run and a run of many ranks resume each other's checkpoints.

One process: `torch.save` of {step, model, optimizer, ema} as
`ckpt_dir/step_XXXXXXXX.pt`, written under a temporary name and renamed,
so an interrupted save never leaves a truncated checkpoint under its final
name. `save_vq_step` writes a VQ-GAN train state the same way, its VQ
model's upstream state dict under "model", so the step file loads as a
tokenizer (`cli/common.py::load_vq(path, encoder=True)`).

Under a process group (a state with a `mesh`): a `torch.distributed
.checkpoint` (DCP) directory `ckpt_dir/step_XXXXXXXX/` of the model,
optimizer and EMA (`get_state_dict`, keyed by parameter name), the step,
the VQ trainer's usage window and the layout it was saved at. Each rank
writes the pieces of the whole tensors that it holds, each at its offsets
in the whole tensor (`_SavePlanner`): its FSDP2 rows, and of a TP shard
the blocks `tp_decode.tp_pieces` gives (three for wqkv, whose shard is
head-major); a piece that several ranks hold (DDP and HSDP replicas, what
TP leaves whole) is written once. Loading reads each rank's pieces out of
whatever pieces the save wrote (`_LoadPlanner`). A one-process `.pt`
resumes under ranks the same way: every rank maps the file and copies out
its pieces, the optimizer's index-keyed state named through the model's
parameter order. No rank gathers a whole sharded tensor to save or to
load. A directory counts only once DCP has written its `.metadata`, so an
interrupted save is never resumed from.

`save_full_model` writes the whole model state dict (upstream keys) from
rank 0 (FSDP2 gathers its shards, a TP group its ranks' shards:
`whole_tp_state`), which `cli/common.py::load_gpt` / `load_vq` load
unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import (
    DefaultLoadPlanner, DefaultSavePlanner, create_default_local_load_plan)
from torch.distributed.checkpoint.metadata import (ChunkStorageMetadata,
                                                   MetadataIndex,
                                                   TensorProperties)
from torch.distributed.checkpoint.planner import (TensorWriteData, WriteItem,
                                                  WriteItemType)
from torch.distributed.checkpoint.planner_helpers import \
    create_read_items_for_chunk_list
from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                     get_model_state_dict,
                                                     get_state_dict,
                                                     set_state_dict)
from torch.distributed.tensor import DTensor

from llamagen_tpu_torch.parallel.mesh import MESH_AXES
from llamagen_tpu_torch.parallel.tp_decode import (Piece, tp_pieces,
                                                   whole_tp_state)
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


def layout_of(state: State) -> Optional[Tuple[int, int, int]]:
    """The state's (dp, fsdp, tp); None for one process."""
    if state.mesh is None:
        return None
    return tuple(state.mesh[a].size() for a in MESH_AXES)


def describe(layout) -> str:
    return ("one process" if layout is None
            else "(dp, fsdp, tp) = ({}, {}, {})".format(*layout))


# ---------------------------------------------------------------------------
# Each rank's pieces of the whole tensors
# ---------------------------------------------------------------------------


class _Entry(NamedTuple):
    """A state tensor's whole shape and the pieces of it a rank holds."""
    whole: Tuple[int, ...]
    pieces: List[Piece]


def _rows(pieces: List[Piece], start: int, n: int) -> List[Piece]:
    """The parts of `pieces` in rows [start, start + n) of the local
    tensor, as pieces of the tensor that holds only those rows (a rank's
    FSDP2 shard of its TP shard)."""
    out = []
    for p in pieces:
        lo, hi = max(p.rows.start, start), min(p.rows.stop, start + n)
        if lo < hi:
            out.append(Piece(slice(lo - start, hi - start),
                             (p.offsets[0] + lo - p.rows.start,)
                             + p.offsets[1:], (hi - lo,) + p.sizes[1:]))
    return out


def _entry(t: torch.Tensor, name: str,
           module: torch.nn.Module) -> Tuple[torch.Tensor, _Entry]:
    """(the rank's local tensor of `t`, an entry of parameter `name` of
    `module`: its weight, an Adam moment or its EMA; where the local
    tensor's pieces lie in the whole tensor)."""
    tp = getattr(module, "tp_size", 1)
    whole, pieces = tp_pieces(name, getattr(module, "cfg", None), tp,
                              getattr(module, "tp_rank", 0), t.shape)
    if isinstance(t, DTensor):  # FSDP2 / HSDP: rows of the TP shard
        (chunk,) = t.__create_chunk_list__()
        if any(chunk.offsets[1:]):
            raise ValueError(f"{name}: sharded along a dim other than 0")
        local = t.to_local()
        if local.dim():
            pieces = _rows(pieces, chunk.offsets[0], local.shape[0])
        return local, _Entry(whole, pieces)
    return t, _Entry(whole, pieces)


def _view(local: torch.Tensor, piece: Piece) -> torch.Tensor:
    return local if piece.rows is None else local[piece.rows]


def _find(entry: _Entry, offsets) -> Piece:
    for p in entry.pieces:
        if tuple(p.offsets) == tuple(offsets):
            return p
    raise KeyError(f"no piece at {tuple(offsets)}")


def _transfer(state: State):
    """(live, sd, entries): `live` the state's trees as `get_state_dict`
    gives them (what `set_state_dict` takes back); `sd` the same trees with
    each tensor replaced by the rank's local tensor (which shares its
    memory), beside the step and the usage window; `entries` {id(local):
    _Entry}."""
    live: Dict[str, Any] = {}
    sd: Dict[str, Any] = {"step": state.step}
    entries: Dict[int, _Entry] = {}

    def put(t, name, module):
        if not isinstance(t, torch.Tensor):
            return t
        local, entry = _entry(t, name, module)
        entries[id(local)] = entry
        return local

    for key, module, opt in _modules(state):
        msd, osd = get_state_dict(module, opt.opt)
        live[key], live[f"optimizer_{key}"] = msd, osd
        sd[key] = {n: put(t, n, module) for n, t in msd.items()}
        sd[f"optimizer_{key}"] = {
            "state": {n: {k: put(v, n, module) for k, v in s.items()}
                      for n, s in osd["state"].items()},
            "param_groups": osd["param_groups"]}
    if state.ema is not None:
        sd["ema"] = {n: put(t, n, state.model) for n, t in state.ema.items()}
    if isinstance(state, VQTrainState):
        sd["usage_window"] = put(state.usage_window, "usage_window",
                                 state.model)
    return live, sd, entries


def _set(state: State, live: Dict[str, Any], sd: Dict[str, Any]) -> None:
    """Hand the filled trees back to the models and optimizers."""
    for key, module, opt in _modules(state):
        osd = dict(live[f"optimizer_{key}"],
                   param_groups=sd[f"optimizer_{key}"]["param_groups"])
        set_state_dict(module, opt.opt, model_state_dict=live[key],
                       optim_state_dict=osd)
    state.step = int(sd["step"])


class _SavePlanner(DefaultSavePlanner):
    """Writes each local tensor of `entries` as its pieces, each at its
    offsets in the whole tensor; DCP's dedup keeps one of the copies
    several ranks hold of a piece."""

    def __init__(self, entries: Dict[int, _Entry]):
        super().__init__()
        self.entries = entries

    def create_local_plan(self):
        plan = super().create_local_plan()
        mine = {fqn: (t, self.entries[id(t)])
                for fqn, t in self.state_dict.items()
                if id(t) in self.entries}
        items = [i for i in plan.items if i.index.fqn not in mine]
        for fqn, (t, entry) in mine.items():
            props = TensorProperties.create_from_tensor(t)
            for p in entry.pieces:
                off = torch.Size(p.offsets)
                items.append(WriteItem(
                    index=MetadataIndex(fqn, off), type=WriteItemType.SHARD,
                    tensor_data=TensorWriteData(
                        chunk=ChunkStorageMetadata(off, torch.Size(p.sizes)),
                        properties=props, size=torch.Size(entry.whole))))
        self.plan = dataclasses.replace(plan, items=items)
        return self.plan

    def resolve_data(self, write_item):
        t = self.state_dict[write_item.index.fqn]
        entry = self.entries.get(id(t))
        if entry is None:
            return super().resolve_data(write_item)
        return _view(t, _find(entry, write_item.index.offset))


class _LoadPlanner(DefaultLoadPlanner):
    """Reads each local tensor of `entries` piece by piece, from whatever
    chunks the save wrote."""

    def __init__(self, entries: Dict[int, _Entry]):
        super().__init__()
        self.entries = entries

    def create_local_plan(self):
        mine = {fqn: self.entries[id(t)] for fqn, t in self.state_dict.items()
                if id(t) in self.entries}
        plan = create_default_local_load_plan(
            {k: v for k, v in self.state_dict.items() if k not in mine},
            self.metadata, not self.allow_partial_load)
        saved = self.metadata.state_dict_metadata
        for fqn, entry in mine.items():
            if fqn not in saved:
                raise RuntimeError(f"Missing key in checkpoint state_dict: "
                                   f"{fqn}.")
            if tuple(saved[fqn].size) != entry.whole:
                raise ValueError(f"{fqn}: saved {tuple(saved[fqn].size)}, "
                                 f"whole here {entry.whole}")
            plan.items.extend(create_read_items_for_chunk_list(
                fqn, saved[fqn], [ChunkStorageMetadata(
                    torch.Size(p.offsets), torch.Size(p.sizes))
                    for p in entry.pieces]))
        return plan

    def resolve_tensor(self, read_item):
        t = self.state_dict[read_item.dest_index.fqn]
        entry = self.entries.get(id(t))
        if entry is None:
            return super().resolve_tensor(read_item)
        out = _view(t, _find(entry, read_item.dest_index.offset))
        for dim, (o, n) in enumerate(zip(read_item.dest_offsets,
                                         read_item.lengths)):
            out = out.narrow(dim, o, n)
        return out


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _save_sharded(ckpt_dir: str, step: int, state: State) -> str:
    path = _path(ckpt_dir, step)
    _, sd, entries = _transfer(state)
    sd["layout"] = list(layout_of(state))
    dcp.save(sd, checkpoint_id=path, planner=_SavePlanner(entries))
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
    if getattr(state.model, "tp_size", 1) == 1:
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


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


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


def _restore_sharded(path: str, state: State) -> str:
    """Load a DCP directory into `state`; the layout it was saved at."""
    live, sd, entries = _transfer(state)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if "layout" in saved:
        sd["layout"] = []
    dcp.load(sd, checkpoint_id=path, planner=_LoadPlanner(entries))
    _set(state, live, sd)
    return describe(sd["layout"]) if "layout" in saved else "a mesh"


def _fill(dst: Dict[str, Any], src: Dict[str, Any],
          entries: Dict[int, _Entry], where: str = "") -> None:
    """Copy each rank's pieces of the whole tensors of `src` into the local
    tensors of `dst` (the same tree)."""
    for key, value in dst.items():
        if not isinstance(value, (dict, torch.Tensor)):
            continue
        if key not in src or src[key] is None:
            raise ValueError(f"the checkpoint lacks {where}{key}")
        if isinstance(value, dict):
            _fill(value, src[key], entries, f"{where}{key}.")
            continue
        entry, whole = entries[id(value)], src[key]
        if tuple(whole.shape) != entry.whole:
            raise ValueError(f"{where}{key}: saved {tuple(whole.shape)}, "
                             f"whole here {entry.whole}")
        with torch.no_grad():
            for p in entry.pieces:
                _view(value, p).copy_(whole[tuple(
                    slice(o, o + n) for o, n in zip(p.offsets, p.sizes))])


def _by_name(saved: Dict[str, Any], opt) -> Dict[str, Any]:
    """A one-process `optimizer.state_dict()` as `get_state_dict` keys it:
    its state by parameter name (`Optimizer.names` gives the order of the
    indices)."""
    groups = [len(g["params"]) for g in saved["param_groups"]]
    if groups != [len(g["params"]) for g in opt.opt.param_groups]:
        raise ValueError(f"the checkpoint's optimizer has parameter groups "
                         f"of {groups}, this model's "
                         f"{[len(g['params']) for g in opt.opt.param_groups]}")
    order = [i for g in saved["param_groups"] for i in g["params"]]
    name = dict(zip(order, opt.names))
    return {"state": {name[i]: s for i, s in saved["state"].items()}}


def _restore_file(path: str, state: State) -> str:
    """Load a one-process `.pt` into `state`, one process or a rank of any
    layout: each rank maps the file and copies out its pieces."""
    ckpt = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    live, sd, entries = _transfer(state)
    src = {"model": ckpt["model"],
           "optimizer_model": _by_name(ckpt["optimizer"], state.optimizer)}
    groups = {"model": ckpt["optimizer"]["param_groups"]}
    if isinstance(state, VQTrainState):
        src["discriminator"] = ckpt["discriminator"]
        src["optimizer_discriminator"] = _by_name(ckpt["optimizer_disc"],
                                                  state.disc_optimizer)
        src["usage_window"] = ckpt["usage_window"]
        groups["discriminator"] = ckpt["optimizer_disc"]["param_groups"]
    if state.ema is not None:
        if ckpt.get("ema") is None:
            raise ValueError("the checkpoint holds no EMA")
        src["ema"] = ckpt["ema"]
    _fill(sd, src, entries)
    for key, saved in groups.items():  # the hyperparameters, by position
        osd = sd[f"optimizer_{key}"]
        osd["param_groups"] = [
            dict(g, **{k: v for k, v in s.items() if k != "params"})
            for g, s in zip(osd["param_groups"], saved)]
    sd["step"] = ckpt["step"]
    _set(state, live, sd)
    return describe(None)


def restore_latest(ckpt_dir: str, state: State,
                   log: Optional[Callable[[str], None]] = None
                   ) -> Tuple[Optional[int], Optional[State]]:
    """Load the newest checkpoint INTO `state` (its models, optimizers,
    EMA, step and usage window, on their devices and in their layout,
    whatever layout the checkpoint was saved at); (None, None) when there
    is none. `log` gets one line naming both layouts."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = _path(ckpt_dir, step)
    if os.path.isdir(path):
        saved = _restore_sharded(path, state)
    else:
        path += ".pt"
        saved = _restore_file(path, state)
    if log is not None:
        log(f"resumed step {step} from {path}: saved at {saved}, loaded at "
            f"{describe(layout_of(state))}")
    return step, state
