"""Tensor parallelism over `torch.distributed` (PyTorch port of
`llamagen_tpu/parallel/tp_decode.py`): Megatron's layout of the GPT, its
shards and per-shard W4 packing.

Layout (JAX's `tp_param_specs`), one process per TP rank, each holding
its shard as an ordinary `gpt.Transformer` (`shard_tp_params`):
  - wqkv column-parallel in head-major order (`_head_major`): rank r's
    columns are the q | k | v of its own heads, so decode attention is
    local to the rank (K1 runs unchanged on its `[B, S, 2 * F_kv / tp]`
    cache); with GQA each rank owns whole kv heads;
  - wo and w2 row-parallel: each rank's partial `[B, D]` output is summed
    over the TP group (`reduce_from_tp`), in the compute dtype, as JAX's
    `psum` of the bf16 product; a W8A16 row shard keeps the whole
    per-column scale, which commutes with the sum;
  - w1 and w3 column-parallel; the output head column-parallel over the
    vocabulary, its f32 logits gathered in rank order (`gather_from_tp`);
  - norms, embeddings and the t2i caption embedder whole on every rank.
Two all-reduces per layer and one gather per step
(`parallel/collectives.py`, with Megatron's conjugate backward for
training). Sampling runs replicated: the gathered logits are bit-identical
on every rank, so every rank samples the same tokens from a generator
seeded alike. The TP decode step is `gpt.decode_step` on the shard (JAX
`make_tp_decode_step`), over a cache `gpt.init_cache(...,
kv_heads=model.n_local_kv_heads)`: one token on the rank's local heads
through K1.

Checkpoints: `tp_pieces` says where each piece of a rank's shard (and of
its Adam moments and EMA) lies in the whole tensor, in upstream's layout,
so that `utils/checkpoint.py` saves and loads a TP state without a
gather and at any other tp.

Per-shard W4 (`quantize_gpt_params_w4k_tp`): the W4 block layout does not
slice along heads or the hidden dim, so each rank's shard is packed by
`pack_w4` on its own; a key whose shard width has no W4 block width (or
an odd K) falls back to W8A16 by JAX's rule, key for key. JAX's 128-lane
alignment asserts are the TPU's and are not ported.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.quant_matmul import quantize_weight
from llamagen_tpu_torch.ops.w4_matmul import (SEG_ROWS, _pick_bn, pack_w4,
                                              w4_dequant)
from llamagen_tpu_torch.parallel.collectives import Group, gather_last

COL_KEYS = ("wqkv", "w1", "w3")  # column-parallel
ROW_KEYS = ("wo", "w2")          # row-parallel


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def _check_tp(cfg: GPTConfig, tp: int) -> None:
    """JAX's semantic asserts: whole heads and whole kv heads per rank."""
    if tp < 1 or cfg.n_head % tp:
        raise ValueError(f"{cfg.n_head} heads do not divide by tp {tp}")
    if cfg.kv_heads % tp:
        raise ValueError(f"GQA under TP needs kv_heads % tp == 0 (each rank "
                         f"owns whole kv heads): {cfg.kv_heads} % {tp}")


def _head_major(arr: torch.Tensor, cfg: GPTConfig, tp: int) -> torch.Tensor:
    """[..., qs + 2 ks] from [Q | K | V] to per-rank [(q | k | v) of rank 0
    | rank 1 | ...], so that a plain column shard gives each rank whole
    heads of q, k and v (JAX `_head_major`). Rank i gets query heads
    [i * hpg, (i + 1) * hpg) and kv heads [i * kv_hpg, (i + 1) * kv_hpg):
    query head h reads kv head h // rep on its own rank. A column
    permutation commutes with per-column quantisation, so it applies to
    int8 columns and to their scales alike."""
    qs = cfg.n_head * cfg.head_dim
    ks = cfg.kv_heads * cfg.head_dim
    lead = arr.shape[:-1]
    q = arr[..., :qs].reshape(*lead, tp, qs // tp)
    k = arr[..., qs:qs + ks].reshape(*lead, tp, ks // tp)
    v = arr[..., qs + ks:].reshape(*lead, tp, ks // tp)
    return torch.cat([q, k, v], dim=-1).reshape(*lead, qs + 2 * ks)


def _head_major_inv(arr: torch.Tensor, cfg: GPTConfig,
                    tp: int) -> torch.Tensor:
    """Inverse of `_head_major`: per-rank groups back to [Q | K | V]."""
    qs = cfg.n_head * cfg.head_dim
    ks = cfg.kv_heads * cfg.head_dim
    hq, hk = qs // tp, ks // tp
    lead = arr.shape[:-1]
    grp = arr.reshape(*lead, tp, hq + 2 * hk)
    q = grp[..., :hq].reshape(*lead, qs)
    k = grp[..., hq:hq + hk].reshape(*lead, ks)
    v = grp[..., hq + hk:].reshape(*lead, ks)
    return torch.cat([q, k, v], dim=-1)


def _linears(model: nn.Module):
    """(key, state-dict name, Linear) of every layer's five matmuls."""
    for i, layer in enumerate(model.layers):
        a, f = layer.attention, layer.feed_forward
        for key, lin, owner in (("wqkv", a.wqkv, "attention"),
                                ("wo", a.wo, "attention"),
                                ("w1", f.w1, "feed_forward"),
                                ("w3", f.w3, "feed_forward"),
                                ("w2", f.w2, "feed_forward")):
            yield key, f"layers.{i}.{owner}.{key}", lin


def is_tp_sharded(name: str) -> bool:
    """Whether a `gpt.Transformer` parameter (by its state-dict name) is
    split over the TP ranks: the five layer matmuls and the head; norms,
    embeddings and the caption embedder are whole on every rank."""
    return name == "output.weight" or name.endswith(tuple(
        f".{k}.weight" for k in COL_KEYS + ROW_KEYS))


class Piece(NamedTuple):
    """Rows `rows` (dim 0) of a rank's local tensor, which lie at `offsets`
    in the whole tensor and span `sizes` there (the local tensor's other
    dims whole); a 0-d tensor has one piece with `rows` None."""
    rows: Optional[slice]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]


def tp_pieces(name: str, cfg: GPTConfig, tp: int, rank: int,
              shape: Sequence[int]) -> Tuple[Tuple[int, ...], List[Piece]]:
    """(the whole tensor's shape, the pieces of TP rank `rank`'s local
    tensor of `shape`) for the `gpt.Transformer` parameter `name` (its
    state-dict name, so its Adam moments and EMA too), in upstream's
    layout (wqkv in [Q | K | V]), as `shard_tp_params` cut it:
      - the head and the column-parallel w1 / w3: one block of rows;
      - the row-parallel wo / w2: one block of columns;
      - wqkv: three blocks of rows (`_head_major`): the rank's q heads at
        r * qs / tp, its kv heads of K at qs + r * ks / tp and of V at
        qs + ks + r * ks / tp (ks = kv_heads * head_dim);
      - everything `is_tp_sharded` leaves whole: the tensor itself.
    Pure: no process group, no data."""
    shape = tuple(shape)
    if not shape:
        return shape, [Piece(None, (), ())]
    n = shape[0]
    if tp == 1 or not is_tp_sharded(name):
        return shape, [Piece(slice(0, n), (0,) * len(shape), shape)]
    rest = shape[1:]
    zeros = (0,) * len(rest)
    if name.endswith((".wo.weight", ".w2.weight")):
        k = shape[1]
        return (n, k * tp), [Piece(slice(0, n), (0, rank * k), shape)]
    if not name.endswith(".wqkv.weight"):
        return (n * tp,) + rest, [Piece(slice(0, n), (rank * n,) + zeros,
                                        shape)]
    qs = cfg.n_head * cfg.head_dim
    ks = cfg.kv_heads * cfg.head_dim
    hq, hk = qs // tp, ks // tp
    if n != hq + 2 * hk:
        raise ValueError(f"{name}: {n} local rows, not {hq + 2 * hk}")
    pieces = [Piece(slice(start, start + rows), (off,) + zeros,
                    (rows,) + rest)
              for start, rows, off in ((0, hq, rank * hq),
                                       (hq, hk, qs + rank * hk),
                                       (hq + hk, hk, qs + ks + rank * hk))]
    return (qs + 2 * ks,) + rest, pieces


def _take(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def _shard_linear(lin: nn.Module, key: str, cfg: GPTConfig, rank: int,
                  tp: int, head_major: bool) -> None:
    """One Linear's TP shard, in place: columns for COL_KEYS and the head
    ("output"), rows for ROW_KEYS. `head_major`: permute wqkv first."""
    col = key != "wo" and key != "w2"
    if lin.weight_w4b is not None:
        if lin.weight_w4b.dim() != 4:
            raise ValueError(
                "a one-card W4 layout cannot be TP-sharded (its blocks do not "
                "slice along heads or the hidden dim): pack per shard with "
                "parallel.tp_decode.quantize_gpt_params_w4k_tp")
        lin.weight_w4b = lin.weight_w4b[rank].contiguous()
        lin.weight_w4s = lin.weight_w4s[rank].contiguous()
        return
    if lin.weight_q is not None:  # W8A16: q [K, N], per-column scale [N]
        q, s = lin.weight_q, lin.weight_scale
        if head_major:
            q, s = _head_major(q, cfg, tp), _head_major(s, cfg, tp)
        if col:
            lin.weight_q, lin.weight_scale = (_take(q, 1, rank, tp),
                                              _take(s, 0, rank, tp))
        else:  # the scale is the column's: whole on every rank
            lin.weight_q = _take(q, 0, rank, tp)
        return
    w = lin.weight.detach()  # [N, K]
    if head_major:
        w = _head_major(w.t(), cfg, tp).t()
    w = _take(w, 0 if col else 1, rank, tp)
    lin.weight = nn.Parameter(w, requires_grad=lin.weight.requires_grad)


def shard_tp_params(model: nn.Module, rank: int, tp: int,
                    group: Group = None) -> nn.Module:
    """Rank `rank`'s TP shard of a whole `gpt.Transformer`, in place (JAX
    `shard_tp_params`): bf16 / f32 weights, W8A16 (`quantize_gpt_params`,
    an int8 head too) or per-shard W4 (`quantize_gpt_params_w4k_tp`, whose
    W8A16 fallback keys are already head-major). `group`: the TP process
    group whose ranks hold the other shards; every forward of a model
    with tp > 1 needs it (a layout-only shard may leave it out). Returns
    the model."""
    cfg = model.cfg
    _check_tp(cfg, tp)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp {tp}")
    if model.tp_size != 1:
        raise ValueError("the model is a TP shard already")
    if group is not None and dist.get_world_size(group) != tp:
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks "
                         f"for tp {tp}")
    if any(lin.weight_q4 is not None for lin in
           [lin for _, _, lin in _linears(model)] + [model.output]):
        raise ValueError("an int4 storage (bits=4) model has no TP layout "
                         "(JAX's tp_decode has no rule for `_q4` keys): "
                         "shard the bf16 / f32 model, or W8A16 / W4")
    packed = model.tp_packed
    if packed not in (None, tp):
        raise ValueError(f"W4 packed for tp {packed}, sharded for tp {tp}")
    for key, _, lin in _linears(model):
        _shard_linear(lin, key, cfg, rank, tp,
                      head_major=key == "wqkv" and packed is None)
    _shard_linear(model.output, "output", cfg, rank, tp, False)
    model.tp_size, model.tp_rank, model.tp_group = tp, rank, group
    model.tp_packed = None
    for layer in model.layers:
        layer.attention.n_head = cfg.n_head // tp
        layer.attention.n_kv_head = cfg.kv_heads // tp
        layer.attention.tp_group = layer.feed_forward.tp_group = group
    return model


@torch.no_grad()
def whole_tp_state(model: nn.Module,
                   sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A TP shard's state dict `sd` (every rank of the group calls it) ->
    the whole model's on the CPU, wqkv back in upstream's [Q | K | V]
    layout: the sharded entries gathered over the group on the model's
    device (`gather_last`), the others as they are."""
    cfg, group, tp = model.cfg, model.tp_group, model.tp_size
    dev = model.freqs_cis.device
    out = {}
    for name, t in sd.items():
        t = t.to(dev)
        if is_tp_sharded(name):
            row = name.endswith((".wo.weight", ".w2.weight"))
            w = t.t() if not row else t  # the sharded dim last
            w = gather_last(w.contiguous(), group)
            w = w if row else w.t()
            if name.endswith(".wqkv.weight"):
                w = _head_major_inv(w.t(), cfg, tp).t()
            t = w
        out[name] = t.contiguous().cpu()
    return out


# ---------------------------------------------------------------------------
# Per-shard W4
# ---------------------------------------------------------------------------


def _n_alignable(n: int) -> bool:
    try:
        _pick_bn(n)
        return True
    except ValueError:
        return False


@torch.no_grad()
def quantize_gpt_params_w4k_tp(model: nn.Module, tp: int, *,
                               per_channel: bool = False,
                               group_size: int = SEG_ROWS) -> nn.Module:
    """W4 packed per TP shard, in place on a whole bf16 / f32 model (JAX
    `quantize_gpt_params_w4k_tp`): column-parallel weights (wqkv
    head-major, w1, w3) split along N into `tp` shards, row-parallel ones
    (wo, w2) along K (each shard's nibble pairing and groups inside its
    own K), each packed by `pack_w4`; a Linear then holds `weight_w4b
    [tp, NB, K/2, BN]` and `weight_w4s [tp, ...]`, rank r's pack at [r].
    A key whose shard N has no W4 block width, or whose K (column) or
    shard K (row) is odd, becomes W8A16 over the whole matrix (wqkv
    head-major) instead, as JAX's rule has it. The head keeps its dtype.
    `shard_tp_params` then takes a rank's shard. Returns the model."""
    cfg = model.cfg
    _check_tp(cfg, tp)
    if model.tp_size != 1:
        raise ValueError("pass the whole model, not a TP shard")
    for key, _, lin in _linears(model):
        if lin.weight is None:
            raise ValueError("pass an unquantised model: W4 is packed per "
                             "shard here")
        w = lin.weight.detach().t()  # [K, N]
        if key == "wqkv":
            w = _head_major(w, cfg, tp)
        k, n = w.shape
        if key in COL_KEYS:
            fallback = n % tp or not _n_alignable(n // tp) or k % 2
            dim = 1
        else:
            fallback = k % tp or (k // tp) % 2 or not _n_alignable(n)
            dim = 0
        if fallback:
            lin.weight_q, lin.weight_scale = quantize_weight(w)
            lin.weight_q = lin.weight_q.contiguous()
        else:
            packs = [pack_w4(_take(w, dim, r, tp), per_channel=per_channel,
                             group_size=group_size) for r in range(tp)]
            lin.weight_w4b = torch.stack([b for b, _ in packs])
            lin.weight_w4s = torch.stack([s for _, s in packs])
        lin.weight = None
    model.tp_packed = tp
    return model


@torch.no_grad()
def unshard_w4_tp_for_reference(model: nn.Module, tp: int) -> nn.Module:
    """A `quantize_gpt_params_w4k_tp` model -> a new whole f32 model of its
    dequantised weights (JAX `unshard_w4_tp_for_reference`): each shard's
    groups exactly as packed, wqkv back in [Q | K | V]; the numerics
    oracle of the per-shard W4 engine."""
    cfg = model.cfg
    ref = gpt.Transformer(cfg, device=model.freqs_cis.device,
                          dtype=torch.float32)
    sd = {k: v.float() for k, v in model.state_dict().items()
          if not k.endswith(("weight_w4b", "weight_w4s", "weight_q",
                             "weight_scale"))}
    for key, name, lin in _linears(model):
        if lin.weight_w4b is not None:
            full = torch.cat([w4_dequant(lin.weight_w4b[r], lin.weight_w4s[r])
                              for r in range(tp)],
                             dim=1 if key in COL_KEYS else 0)
        elif lin.weight_q is not None:
            full = lin.weight_q.float() * lin.weight_scale.float()
        else:
            full = lin.weight.float().t()
        if key == "wqkv" and model.tp_packed is not None:
            full = _head_major_inv(full, cfg, tp)
        sd[f"{name}.weight"] = full.t().contiguous()
    if model.output.weight is None:  # an int8 head
        o = model.output
        sd["output.weight"] = (o.weight_q.float() * o.weight_scale).t()
    ref.load_state_dict(sd)
    return ref.eval()


__all__: List[str] = [
    "shard_tp_params", "whole_tp_state", "is_tp_sharded", "tp_pieces",
    "Piece",
    "quantize_gpt_params_w4k_tp", "unshard_w4_tp_for_reference"]
