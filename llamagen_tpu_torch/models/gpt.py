"""Llama-style autoregressive transformer over VQ code grids, in PyTorch:
inference (prefill, decode) and the training forward.

Counterpart of `llamagen_tpu/models/gpt.py`. The module tree uses the
upstream LlamaGen state-dict keys (`tok_embeddings.weight`,
`cls_embedding.embedding_table.weight` for c2i, `cls_embedding.cap_proj.
fc{1,2}.weight` and `cls_embedding.uncond_embedding` for t2i,
`layers.{i}.attention.wqkv.weight`,
`layers.{i}.feed_forward.w1.weight`, `norm.weight`, `output.weight`, ...), so
a released `.pt` loads with `load_state_dict`.

The KV cache is the JAX one (not the `{'k','v'}` layout of that module's
docstring): per layer one `[B, S, 2 * F_kv]` buffer, k in lanes
`[0, F_kv)`, v in `[F_kv, 2 * F_kv)`; int8 caches add per-row k/v scales and
a 32-row exact tail (`ops/attention.py`). The cache is updated in place.

`forward_train` is the teacher-forced full-sequence forward of training.
Its attention runs the training-attention kernel (`ops/train_attention.py`)
unless attention-probability dropout is on; dropout masks come from
per-layer seeds drawn before the layer loop, so a layer recomputed under
`torch.utils.checkpoint` draws the same masks.

Tensor parallelism (JAX's `tp_axis`): a model made a TP shard by
`parallel/tp_decode.py::shard_tp_params` holds its rank's heads and FFN
columns (`Attention.n_head`, `n_kv_head`) and its TP process group
(`Transformer.tp_group`); every forward here then runs on the local
heads, sums wo's and w2's partial outputs over the group in the compute
dtype and gathers the logits along the vocabulary. Training adds the
conjugate backward (`parallel/collectives.py`: `copy_to_tp` before wqkv,
w1, w3 and the head).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.ops.attention import (TAIL, batch_positions,
                                              decode_attention, quantize_rows)
from llamagen_tpu_torch.ops.quant_matmul import (matmul_any, quantize_weight,
                                                 quantize_weight_int4)
from llamagen_tpu_torch.ops.train_attention import (TRAIN_ATTENTION_OP,
                                                    causal_attention_padded)
from llamagen_tpu_torch.ops.w4_matmul import SEG_ROWS, pack_w4
from llamagen_tpu_torch.parallel.collectives import (copy_to_tp,
                                                     gather_from_tp,
                                                     reduce_from_tp)


# ---------------------------------------------------------------------------
# Rotary embeddings and norms
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _freqs_cis_2d_np(grid_size: int, head_dim: int, base: float,
                     cls_token_num: int) -> np.ndarray:
    """2D RoPE table [cls_token_num + grid**2, head_dim//2, 2] (f32).

    Half the head dim rotates with the x coordinate, half with y; the
    condition positions get zero rows (a copy of the JAX table).
    """
    half_dim = head_dim // 2
    freqs = 1.0 / (base ** (np.arange(0, half_dim, 2)[: half_dim // 2]
                            / half_dim))
    t = np.arange(grid_size)
    freqs = np.outer(t, freqs)  # [grid, head_dim//4]
    fx = np.broadcast_to(freqs[:, None, :],
                         (grid_size, grid_size, freqs.shape[1]))
    fy = np.broadcast_to(freqs[None, :, :],
                         (grid_size, grid_size, freqs.shape[1]))
    grid = np.concatenate([fx, fy], axis=-1)  # [g, g, head_dim//2]
    cache = np.stack([np.cos(grid), np.sin(grid)], axis=-1)
    cache = cache.reshape(grid_size * grid_size, half_dim, 2)
    cond = np.zeros((cls_token_num, half_dim, 2), dtype=np.float32)
    return np.concatenate([cond, cache]).astype(np.float32)


def rope_heads(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation in f32. x [..., H, D]; freqs broadcastable
    to [..., D//2, 2] without the head axis ([D//2, 2] for one position,
    [B, D//2, 2] per row, [S, D//2, 2] for a sequence)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    cos = freqs[..., None, :, 0]
    sin = freqs[..., None, :, 1]
    real = xf[..., 0] * cos - xf[..., 1] * sin
    imag = xf[..., 1] * cos + xf[..., 0] * sin
    return torch.stack([real, imag], dim=-1).reshape(x.shape).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """f32 normalisation, cast to x's dtype, then times the weight there."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def split_heads(qkv: torch.Tensor, h_q: int, h_kv: int, head_dim: int):
    """[..., (h_q + 2*h_kv)*d] -> (q [..., h_q, d], k [..., h_kv, d],
    v [..., h_kv*d] flat)."""
    lead = qkv.shape[:-1]
    qs, ks = h_q * head_dim, h_kv * head_dim
    q = qkv[..., :qs].reshape(*lead, h_q, head_dim)
    k = qkv[..., qs:qs + ks].reshape(*lead, h_kv, head_dim)
    return q, k, qkv[..., qs + ks:]


# ---------------------------------------------------------------------------
# Modules (upstream state-dict keys)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """Bias-free linear layer, `weight [out, in]`. After `quantize_()` it
    holds W8A16 `weight_q [in, out]` int8 + `weight_scale [out]` f32 and
    runs on the int8 kernel (`ops.quant_matmul`); after `quantize_w4_()` it
    holds W4 `weight_w4b [NB, in/2, BN]` int8 + `weight_w4s [NB, R, BN]`
    f32 and runs on the W4 kernel (`ops.w4_matmul`) for rank-2 inputs;
    after `quantize_int4_()` it holds int4 storage `weight_q4 [in, out/2]`
    int8 nibble pairs + `weight_gs [G, out]` f32 (`ops.quant_matmul
    .int4_matmul`, plain PyTorch)."""

    QUANT_KEYS = ("weight_q", "weight_scale", "weight_w4b", "weight_w4s",
                  "weight_q4", "weight_gs")

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device, dtype=dtype))
        for key in self.QUANT_KEYS:
            self.register_buffer(key, None)

    def quantize_(self) -> None:
        q, s = quantize_weight(self.weight.detach().t())
        self.weight = None
        self.weight_q, self.weight_scale = q.contiguous(), s

    def quantize_w4_(self, per_channel: bool = False,
                     group_size: int = SEG_ROWS) -> None:
        self.weight_w4b, self.weight_w4s = pack_w4(
            self.weight.detach().t(), per_channel=per_channel,
            group_size=group_size)
        self.weight = None

    def quantize_int4_(self, group_size: int = 128) -> None:
        self.weight_q4, self.weight_gs = quantize_weight_int4(
            self.weight.detach().t(), group_size=group_size)
        self.weight = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_any(x, self.weight, self.weight_q, self.weight_scale,
                          self.weight_w4b, self.weight_w4s, self.weight_q4,
                          self.weight_gs)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    """wqkv and wo; `n_head` / `n_kv_head` are the heads this module holds
    (a TP shard's local ones) and `tp_group` the group of its shards."""

    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        qkv_out = (cfg.n_head + 2 * cfg.kv_heads) * cfg.head_dim
        self.wqkv = Linear(cfg.dim, qkv_out, **kw)
        self.wo = Linear(cfg.dim, cfg.dim, **kw)
        self.n_head, self.n_kv_head = cfg.n_head, cfg.kv_heads
        self.tp_group: Optional[dist.ProcessGroup] = None


class FeedForward(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.w1 = Linear(cfg.dim, cfg.ffn_hidden_dim, **kw)
        self.w3 = Linear(cfg.dim, cfg.ffn_hidden_dim, **kw)
        self.w2 = Linear(cfg.ffn_hidden_dim, cfg.dim, **kw)
        self.tp_group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_tp(x, self.tp_group)
        return reduce_from_tp(self.w2(F.silu(self.w1(x)) * self.w3(x)),
                              self.tp_group)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.attention = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.feed_forward = FeedForward(cfg, **kw)

    def forward(self, h: torch.Tensor, freqs: torch.Tensor,
                seed: Optional[int] = None,
                drop_path_rate: Optional[float] = None,
                remat: "Remat" = False) -> torch.Tensor:
        """The training layer `_train_block`, recomputed in the backward
        under `remat` ("full" or "save_attn"). A call through the module,
        so that FSDP2 gathers this layer's parameters around it."""
        if not remat:
            return _train_block(self, h, freqs, self.cfg, seed,
                                drop_path_rate)
        ckpt = {}
        if remat == "save_attn":
            ckpt["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_attention)
        return checkpoint(_train_block, self, h, freqs, self.cfg, seed,
                          drop_path_rate, use_reentrant=False, **ckpt)


class LabelEmbedder(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        rows = cfg.num_classes + (1 if cfg.class_dropout_prob > 0 else 0)
        self.embedding_table = nn.Embedding(rows, cfg.dim, **kw)


class CaptionEmbedder(nn.Module):
    """t2i conditioning (upstream `CaptionEmbedder`): an MLP over T5
    features, `cap_proj.fc1 [dim, caption_dim]` and `cap_proj.fc2
    [dim, dim]` (no biases), and the learned null caption
    `uncond_embedding [cls_token_num, caption_dim]` for CFG."""

    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.cap_proj = nn.Module()
        self.cap_proj.fc1 = Linear(cfg.caption_dim, cfg.dim, **kw)
        self.cap_proj.fc2 = Linear(cfg.dim, cfg.dim, **kw)
        self.uncond_embedding = nn.Parameter(torch.empty(
            cfg.cls_token_num, cfg.caption_dim, **kw))


class Transformer(nn.Module):
    """GPT (inference and the training forward) for c2i (class labels) or
    t2i (caption features). `cfg` is the port's `GPTConfig`. A TP shard
    (`tp_size` > 1) is rank `tp_rank`'s of the group `tp_group`."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        if cfg.model_type not in ("c2i", "t2i"):
            raise ValueError(f"model_type {cfg.model_type!r}")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.cls_embedding = (LabelEmbedder(cfg, **kw)
                              if cfg.model_type == "c2i"
                              else CaptionEmbedder(cfg, **kw))
        self.layers = nn.ModuleList(TransformerBlock(cfg, **kw)
                                    for _ in range(cfg.n_layer))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.output = Linear(cfg.dim, cfg.vocab_size, **kw)
        freqs = _freqs_cis_2d_np(cfg.grid_size, cfg.head_dim, cfg.rope_base,
                                 cfg.cls_token_num)
        self.register_buffer("freqs_cis",
                             torch.tensor(freqs, device=device),
                             persistent=False)
        self.tp_size, self.tp_rank = 1, 0
        self.tp_group: Optional[dist.ProcessGroup] = None
        self.tp_packed: Optional[int] = None  # per-shard W4, not yet sharded

    @property
    def n_local_heads(self) -> int:
        return self.layers[0].attention.n_head

    @property
    def n_local_kv_heads(self) -> int:
        return self.layers[0].attention.n_kv_head

    def embed_condition(self, cond: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Class labels [B] (c2i) -> [B, 1, dim], or caption features
        [B, T, caption_dim] (t2i) -> GELU-tanh(cap fc1) fc2, the first
        `cls_token_num` rows [B, cls_token_num, dim] (JAX
        `embed_condition`). With a `generator` (training) each label is
        replaced by the null class `num_classes`, each whole caption by
        `uncond_embedding`, with probability `class_dropout_prob` (CFG
        dropout)."""
        p = self.cfg.class_dropout_prob
        drop = None
        if generator is not None and p > 0:
            drop = torch.rand(cond.shape[:1], generator=generator,
                              device=cond.device) < p
        if self.cfg.model_type == "c2i":
            if drop is not None:
                cond = torch.where(drop, self.cfg.num_classes, cond)
            return F.embedding(
                cond, self.cls_embedding.embedding_table.weight)[:, None, :]
        ce = self.cls_embedding
        if drop is not None:
            cond = torch.where(drop[:, None, None],
                               ce.uncond_embedding.to(cond.dtype), cond)
        h = F.gelu(ce.cap_proj.fc1(cond), approximate="tanh")
        return ce.cap_proj.fc2(h)[:, :self.cfg.cls_token_num]

    def forward(self, cond: torch.Tensor, idx: torch.Tensor,
                **kw) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The training forward, `forward_train(self, cond, idx, **kw)`,
        through the module (DDP and FSDP2 hook `__call__`)."""
        return forward_train(self, cond, idx, **kw)


@torch.no_grad()
def init_weights(model: Transformer, seed: int = 0) -> Transformer:
    """The reference init (gpt.py:790-826): normal(0.02) matmul and
    embedding weights, unit norms, a t2i null caption of normal(1) /
    sqrt(caption_dim), and a ZEROED output head (every logit 0: give the
    head weights before greedy decoding means anything)."""
    dev = model.freqs_cis.device
    g = torch.Generator(device=dev).manual_seed(seed)
    std = model.cfg.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name == "output.weight":
            p.zero_()
        elif name == "cls_embedding.uncond_embedding":
            p.normal_(0.0, model.cfg.caption_dim ** -0.5, generator=g)
        else:
            p.normal_(0.0, std, generator=g)
    return model


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Per-layer cache buffers, updated in place.

    kv:       [B, S, 2 * F_kv] per layer (bf16 / f32 / int8)
    kv_scale: int8 only, bf16 [B, S, 2] per layer (k, v row scales)
    tail:     int8 only, [B, 32, 2 * F_kv] per layer, exact rows
              [32 * (pos // 32), pos] in compute dtype
    """

    kv: List[torch.Tensor]
    kv_scale: Optional[List[torch.Tensor]] = None
    tail: Optional[List[torch.Tensor]] = None

    @property
    def quantized(self) -> bool:
        return self.kv_scale is not None


def init_cache(cfg: GPTConfig, batch: int, max_seq_len: int,
               dtype: torch.dtype, device,
               compute_dtype: torch.dtype = torch.bfloat16,
               kv_heads: Optional[int] = None) -> KVCache:
    """Zeroed bf16/f32 cache, or an empty int8 cache (`dtype` torch.int8):
    zero rows, bf16 scales of 1.0 and a zero tail in `compute_dtype`, as
    JAX `init_cache` + `init_recent` start the serving engine's cache. An
    int8 cache after a prefill comes from `quantize_cache`. `kv_heads`: a
    TP shard's local kv heads (default: the config's)."""
    f2 = 2 * (kv_heads or cfg.kv_heads) * cfg.head_dim

    def per_layer(shape, dt, fill=0.0):
        return [torch.full(shape, fill, dtype=dt, device=device)
                for _ in range(cfg.n_layer)]

    kv = per_layer((batch, max_seq_len, f2), dtype)
    if dtype != torch.int8:
        return KVCache(kv)
    return KVCache(kv, kv_scale=per_layer((batch, max_seq_len, 2),
                                          torch.bfloat16, 1.0),
                   tail=per_layer((batch, TAIL, f2), compute_dtype))


def quantize_cache(cache: KVCache, cfg: GPTConfig,
                   max_seq_len: int) -> KVCache:
    """Exact cache (e.g. after prefill) -> int8 cache of `max_seq_len` rows,
    per-row k/v scales stored bf16, padded rows with scale 1.0 (as
    `gpt.quantize_cache` in JAX). The tail is left unset: the caller seeds
    it from the exact rows."""
    kv, scales = [], []
    for ckv in cache.kv:
        b, src_len, f2 = ckv.shape
        f = f2 // 2  # a TP shard's cache: its own heads
        kq, ks = quantize_rows(ckv[..., :f])
        vq, vs = quantize_rows(ckv[..., f:])
        q8 = torch.zeros(b, max_seq_len, 2 * f, dtype=torch.int8,
                         device=ckv.device)
        q8[:, :src_len] = torch.cat([kq, vq], dim=-1)
        sc = torch.ones(b, max_seq_len, 2, dtype=torch.bfloat16,
                        device=ckv.device)
        sc[:, :src_len] = torch.stack([ks, vs], dim=-1).to(torch.bfloat16)
        kv.append(q8)
        scales.append(sc)
    return KVCache(kv, kv_scale=scales)


# ---------------------------------------------------------------------------
# Forward: the shared layer loop, prefill and decode
# ---------------------------------------------------------------------------


Attend = Callable[[int, torch.Tensor], torch.Tensor]


def tp_group_of(model: Transformer) -> Optional[dist.ProcessGroup]:
    """The model's TP group (None for a whole model); a TP shard without
    one raises: its partial sums would be taken for the whole."""
    if model.tp_size > 1 and model.tp_group is None:
        raise ValueError(f"a TP shard (rank {model.tp_rank} of "
                         f"{model.tp_size}) runs only with its process "
                         f"group: shard_tp_params(..., group=)")
    return model.tp_group


def decode_stack(model: Transformer, h: torch.Tensor, attend: Attend,
                 flatten: bool = True, last_only: bool = False,
                 group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The layer loop + final norm + output head. h [..., D];
    attend(l, qkv) -> [..., F] owns rope, the cache update and attention.
    Returns f32 logits [..., V], or with `last_only` (prefill) the head of
    the last position only, [B, V] for h [B, T, D] (JAX `prefill`).

    group: the TP group of a TP shard (JAX's `tp_axis`): wo's and w2's
    partial outputs are summed over it in the compute dtype, then cast to
    h's dtype, and the f32 logits are gathered along the vocabulary in
    rank order (JAX gpt.py:604-620).

    flatten: run every matmul on x flattened to rank 2, as JAX's
    `decode_stack` does (gpt.py:598-602), so W4 weights take the W4 kernel
    on every decode, draft and verify step. Prefill passes False: JAX runs
    it through `_run_layers` on rank-3 x, where W4 weights take the
    dequantised fallback (which does not round x to bf16)."""
    lead = h.shape[:-1]

    def mm(lin: Linear, x: torch.Tensor) -> torch.Tensor:
        if not flatten:
            return lin(x)
        out = lin(x.reshape(-1, x.shape[-1]))
        return out.reshape(*lead, out.shape[-1])

    def red(x: torch.Tensor) -> torch.Tensor:
        return reduce_from_tp(x, group)

    for l, layer in enumerate(model.layers):
        x = layer.attention_norm(h)
        attn = attend(l, mm(layer.attention.wqkv, x))
        h = h + red(mm(layer.attention.wo, attn.to(x.dtype))).to(h.dtype)
        ff = layer.feed_forward
        x = layer.ffn_norm(h)
        h = h + red(mm(ff.w2, F.silu(mm(ff.w1, x)) * mm(ff.w3, x))) \
            .to(h.dtype)
    if last_only:  # rank 3, as JAX's `_logits(h[:, -1:])`
        logits = model.output(model.norm(h[:, -1:])).float()[:, 0]
    else:
        logits = mm(model.output, model.norm(h)).float()
    return gather_from_tp(logits, group)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, bf16_scores: bool = False,
          dropout_p: float = 0.0,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H*D]: f32 scores and
    softmax, probabilities cast back to q's dtype (JAX `_sdpa`).

    bf16_scores (the training path under bf16 compute): the scores are
    formed and masked in bf16 and upcast for the softmax. dropout_p with a
    generator: attention-probability dropout on the cast probabilities."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = q.shape[-1] ** -0.5
    if bf16_scores and q.dtype == torch.bfloat16:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        scores = scores.masked_fill(~mask, -3e38).float()
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * scale
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if generator is not None and dropout_p > 0:
        probs = _dropout(probs, dropout_p, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(*q.shape[:2], -1)


@torch.no_grad()
def prefill(model: Transformer, cond: torch.Tensor, cache: KVCache,
            compute_dtype: torch.dtype = torch.bfloat16,
            prefix_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the condition tokens; writes cache rows [0, T) in place and
    returns the logits at the last position [B, V] (f32). The cache must be
    bf16/f32 (int8 runs prefill into an exact cache, then quantises).

    cond: [B] labels (c2i) or [B, T, caption_dim] caption features (t2i).
    prefix_mask: optional [B, T] bool caption validity (t2i left padding):
    query i attends to key j <= i where j is valid or j == i (JAX
    `causal & (allow | eye)`), so a pad row attends to itself only."""
    if cache.quantized:
        raise ValueError("prefill into an exact cache, then quantize_cache")
    cfg = model.cfg
    group = tp_group_of(model)
    t = cfg.cls_token_num
    h = model.embed_condition(cond).to(compute_dtype)
    freqs = model.freqs_cis[:t]
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    if prefix_mask is not None:
        eye = torch.eye(t, dtype=torch.bool, device=h.device)
        causal = causal & (prefix_mask.bool()[:, None, None, :] | eye)
    hn, kvh = model.n_local_heads, model.n_local_kv_heads
    f_kv = kvh * cfg.head_dim

    def attend(l, qkv):
        b = qkv.shape[0]
        q, k, v = split_heads(qkv, hn, kvh, cfg.head_dim)
        q, k = rope_heads(q, freqs), rope_heads(k, freqs)
        ckv = cache.kv[l]
        ckv[:, :t] = torch.cat([k.reshape(b, t, f_kv), v], dim=-1) \
            .to(ckv.dtype)
        # attend to what the cache holds, as JAX does
        kk = ckv[:, :t, :f_kv].reshape(b, t, kvh, cfg.head_dim)
        vv = ckv[:, :t, f_kv:].reshape(b, t, kvh, cfg.head_dim)
        return _sdpa(q, kk.to(q.dtype), vv.to(q.dtype), causal)

    return decode_stack(model, h, attend, flatten=False, last_only=True,
                        group=group)


@torch.no_grad()
def decode_step_slots(model: Transformer, emb: torch.Tensor,
                      pos: torch.Tensor, cache: KVCache,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      prefix_pad: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One step with a position per row (JAX `_decode_step_slots_pallas`,
    serve/engine.py:160-172): emb [B, D] input embeddings (token, class or
    null), pos int32 [B]. Rope rows come from `freqs_cis[pos]`; the
    decode-attention kernel runs in every layer and updates the cache in
    place. The caller keeps every pos inside the cache: a position tensor
    is not read back to the host. prefix_pad: optional int32 [B], positions
    below it are masked. A TP shard runs its local heads (the cache is its
    own, `[B, S, 2 * F_kv / tp]`) and its group's collectives. Returns f32
    logits [B, V]."""
    cfg = model.cfg
    group = tp_group_of(model)
    b = emb.shape[0]
    h = emb.to(compute_dtype)
    freqs = model.freqs_cis[pos]  # [B, D//2, 2]
    hn, kvh = model.n_local_heads, model.n_local_kv_heads
    f, f_kv = hn * cfg.head_dim, kvh * cfg.head_dim

    def attend(l, qkv):
        q, k, v = split_heads(qkv, hn, kvh, cfg.head_dim)
        q = rope_heads(q, freqs).reshape(b, f)
        k = rope_heads(k, freqs).reshape(b, f_kv)
        return decode_attention(
            q, torch.cat([k, v], dim=-1), cache.kv[l], pos, hn,
            prefix_pad=prefix_pad,
            kv_scale=cache.kv_scale[l] if cache.quantized else None,
            tail=cache.tail[l] if cache.quantized else None)

    return decode_stack(model, h, attend, group=group)


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, pos: int,
                cache: KVCache,
                compute_dtype: torch.dtype = torch.bfloat16,
                prefix_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row at position `pos` (`decode_step_slots` with the
    token embeddings and one position for every row); prefix_pad: optional
    int32 [B] left-pad counts of t2i captions. Returns f32 logits
    [B, V]."""
    if not 0 <= pos < cache.kv[0].shape[1]:  # the kernel writes row pos
        raise ValueError(f"pos {pos} outside the cache")
    emb = model.tok_embeddings.weight[token]
    return decode_step_slots(model, emb,
                             batch_positions(pos, token.shape[0], emb.device),
                             cache, compute_dtype, prefix_pad=prefix_pad)


# ---------------------------------------------------------------------------
# Training forward (JAX gpt.py:214-504)
# ---------------------------------------------------------------------------


Remat = Union[bool, str]  # False, "full" or "save_attn"


def _save_attention(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """remat "save_attn": keep each layer's training-attention output (and
    its log-sum-exp) and recompute everything else, so the recompute does
    not run the attention forward again (JAX's "attn_core" policy). The
    plain attention of CPU tensors and the attention-dropout path are not
    this operator: there everything is recomputed, as under "full"."""
    return (CheckpointPolicy.MUST_SAVE if op is TRAIN_ATTENTION_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dropout(x: torch.Tensor, p: float,
             generator: torch.Generator) -> torch.Tensor:
    """Keep each element with probability 1 - p, scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _drop_path(x: torch.Tensor, rate: float,
               generator: torch.Generator) -> torch.Tensor:
    """Per-sample stochastic depth: keep a whole batch row with
    probability 1 - rate, scaled by 1 / (1 - rate)."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _layer_generator(seed: Optional[int],
                     device: torch.device) -> Optional[torch.Generator]:
    """A fresh generator from a seed drawn OUTSIDE the checkpointed layer:
    `torch.utils.checkpoint` restores only the default RNG states, so a
    recomputed layer must reseed its own generator to draw the same
    masks."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _train_attention(attn: Attention, x: torch.Tensor, freqs: torch.Tensor,
                     cfg: GPTConfig,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Full-sequence causal attention + wo on the module's heads (a TP
    shard's local ones, wo's partial outputs summed over its group). The
    training-attention kernel unless attention-probability dropout is on
    (JAX gpt.py:284-307)."""
    b, s, _ = x.shape
    hn, kvh = attn.n_head, attn.n_kv_head
    q, k, v = split_heads(attn.wqkv(copy_to_tp(x, attn.tp_group)), hn, kvh,
                          cfg.head_dim)
    v = v.reshape(b, s, kvh, cfg.head_dim)  # a view: row stride 3F
    q, k = rope_heads(q, freqs), rope_heads(k, freqs)
    if generator is not None and cfg.attn_dropout_p > 0:
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = _sdpa(q, k, v, causal, bf16_scores=True,
                    dropout_p=cfg.attn_dropout_p, generator=generator)
    else:
        rep = hn // kvh
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = causal_attention_padded(q, k, v, cfg.head_dim ** -0.5) \
            .reshape(b, s, -1)
    return reduce_from_tp(attn.wo(out), attn.tp_group)


def _train_block(layer: TransformerBlock, h: torch.Tensor,
                 freqs: torch.Tensor, cfg: GPTConfig, seed: Optional[int],
                 drop_path_rate: Optional[float]) -> torch.Tensor:
    """One layer (JAX `_block`): attention and SwiGLU with resid/ffn
    dropout and drop-path drawn from the layer's own seed. Those act on
    activations every TP rank holds whole, so its ranks draw the same
    masks; attention-probability dropout acts on the rank's own heads and
    draws from the seed offset by the TP rank (Megatron's model-parallel
    stream)."""
    gen = _layer_generator(seed, h.device)
    attn_gen = gen
    group = layer.attention.tp_group
    if group is not None and seed is not None:
        attn_gen = _layer_generator(
            (seed + 1 + dist.get_rank(group)) % 2 ** 62, h.device)
    attn = _train_attention(layer.attention, layer.attention_norm(h), freqs,
                            cfg, attn_gen)
    if gen is not None:
        if cfg.resid_dropout_p > 0:
            attn = _dropout(attn, cfg.resid_dropout_p, gen)
        if drop_path_rate is not None:
            attn = _drop_path(attn, drop_path_rate, gen)
    h = h + attn
    ffn = layer.feed_forward(layer.ffn_norm(h))
    if gen is not None:
        if cfg.ffn_dropout_p > 0:
            ffn = _dropout(ffn, cfg.ffn_dropout_p, gen)
        if drop_path_rate is not None:
            ffn = _drop_path(ffn, drop_path_rate, gen)
    return h + ffn


def _leading_zero_rows(cond_emb: torch.Tensor, s: int) -> torch.Tensor:
    """[B, s, 1] bool: the leading run of all-zero condition rows of each
    sample (a t2i caption's left pad), False past it.

    Such rows stay exactly 0 through every layer for any weights: each
    attends only to rows of the run (the mask is causal), whose values are
    0, and every projection is bias-free. So their activation gradient adds
    exactly 0 to every parameter gradient (it only ever meets their zero
    inputs), yet it grows by RMSNorm's 1 / sqrt(eps) ~ 316 at each norm it
    crosses and overflows f32 within ~20-36 layers, where 0 * inf makes the
    weight gradients NaN (JAX's forward_train does so at GPT-XL depth).
    `forward_train` stops the gradient at these rows before each layer."""
    zero = (cond_emb == 0).all(dim=-1).int().cumprod(dim=1).bool()
    return F.pad(zero, (0, s - zero.shape[1]))[..., None]


def forward_train(model: Transformer, cond: torch.Tensor, idx: torch.Tensor,
                  targets: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  train: bool = True,
                  compute_dtype: torch.dtype = torch.float32,
                  remat: Remat = False,
                  group: Optional[dist.ProcessGroup] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Teacher-forced full-sequence forward (JAX `gpt.forward_train`).

    cond: [B] class labels (c2i) or [B, T, caption_dim] caption features
    (t2i; masked rows already zeroed: the attention stays causal); idx:
    [B, L] token ids (callers pass tokens[:, :-1]); targets: [B,
    block_size] ids for the CE loss; valid: optional [B] sample weights.
    Returns (logits [B, S, V] f32 from the last condition position on,
    loss or None).

    Dropout (class, token, resid/ffn, drop-path, attention) runs when
    `train` and a `generator` is given: the generator (any device) draws
    one seed for the condition, the tokens and each layer, and the masks
    are drawn on the activations' device from generators seeded with them.
    remat: False; "full" to recompute each layer in the backward
    (`torch.utils.checkpoint`); or "save_attn" to recompute all but the
    attention kernel's output (`_save_attention`).

    t2i: the gradient stops at the left-pad rows (`_leading_zero_rows`):
    the values and the parameter gradients are JAX's, finite at any depth.

    group: the process group whose ranks hold the other rows of the
    global batch (their gradients are averaged). With `valid`, the loss
    then divides by the weights summed over every rank (times the group's
    size), so the mean of the ranks' losses and gradients is the global
    batch's weighted mean, as one process computes it.
    """
    cfg = model.cfg
    if remat not in (False, "full", "save_attn"):
        raise ValueError(f"unknown remat {remat!r}")
    seeds: List[Optional[int]] = [None] * (cfg.n_layer + 2)
    if train and generator is not None:
        seeds = torch.randint(0, 2 ** 62, (cfg.n_layer + 2,),
                              generator=generator,
                              device=generator.device).tolist()
    dev = idx.device
    cond_emb = model.embed_condition(cond, _layer_generator(seeds[0], dev))
    tok_emb = F.embedding(idx, model.tok_embeddings.weight)
    h = torch.cat([cond_emb, tok_emb], dim=1).to(compute_dtype)
    if seeds[1] is not None and cfg.token_dropout_p > 0:
        h = _dropout(h, cfg.token_dropout_p, _layer_generator(seeds[1], dev))

    freqs = model.freqs_cis[:h.shape[1]]
    rates = [None] * cfg.n_layer
    if seeds[2] is not None and cfg.drop_path_rate > 0:
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.n_layer).tolist()
    pads = _leading_zero_rows(cond_emb, h.shape[1]) \
        if cfg.model_type == "t2i" else None
    tp_group = tp_group_of(model)
    for layer, seed, rate in zip(model.layers, seeds[2:], rates):
        if pads is not None:
            h = torch.where(pads, h.detach(), h)
        h = layer(h, freqs, seed, rate, remat)
    logits = gather_from_tp(model.output(copy_to_tp(model.norm(h), tp_group)),
                            tp_group).float()
    # predictions for grid tokens start at the last condition position
    logits = logits[:, cfg.cls_token_num - 1:]

    loss = None
    if targets is not None:
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1).long(), reduction="none") \
            .reshape(targets.shape)
        if valid is not None:
            w = valid[:, None].float().expand_as(nll)
            total = w.sum()
            if group is not None:  # the weights of every rank's rows
                total = total.detach().clone()
                dist.all_reduce(total, group=group)
            world = 1 if group is None else dist.get_world_size(group)
            loss = (nll * w).sum() * world / total.clamp_min(1.0)
        else:
            loss = nll.mean()
    return logits, loss
