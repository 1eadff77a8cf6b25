"""Llama-style autoregressive transformer over VQ code grids: the inference
half, in PyTorch.

Counterpart of `llamagen_tpu/models/gpt.py`. The module tree uses the
upstream LlamaGen state-dict keys (`tok_embeddings.weight`,
`cls_embedding.embedding_table.weight`, `layers.{i}.attention.wqkv.weight`,
`layers.{i}.feed_forward.w1.weight`, `norm.weight`, `output.weight`, ...), so
a released `.pt` loads with `load_state_dict`.

The KV cache is the JAX one (not the `{'k','v'}` layout of that module's
docstring): per layer one `[B, S, 2 * F_kv]` buffer, k in lanes
`[0, F_kv)`, v in `[F_kv, 2 * F_kv)`; int8 caches add per-row k/v scales and
a 32-row exact tail (`ops/attention.py`). The cache is updated in place.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.ops.attention import (TAIL, batch_positions,
                                              decode_attention, quantize_rows)
from llamagen_tpu_torch.ops.quant_matmul import matmul_any, quantize_weight


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
    holds W8A16 `weight_q [in, out]` int8 + `weight_scale [out]` f32
    instead, and runs on the int8 kernel (`ops.quant_matmul`)."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device, dtype=dtype))
        self.register_buffer("weight_q", None)
        self.register_buffer("weight_scale", None)

    def quantize_(self) -> None:
        q, s = quantize_weight(self.weight.detach().t())
        self.weight = None
        self.weight_q, self.weight_scale = q.contiguous(), s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_any(x, self.weight, self.weight_q, self.weight_scale)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        qkv_out = (cfg.n_head + 2 * cfg.kv_heads) * cfg.head_dim
        self.wqkv = Linear(cfg.dim, qkv_out, **kw)
        self.wo = Linear(cfg.dim, cfg.dim, **kw)


class FeedForward(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.w1 = Linear(cfg.dim, cfg.ffn_hidden_dim, **kw)
        self.w3 = Linear(cfg.dim, cfg.ffn_hidden_dim, **kw)
        self.w2 = Linear(cfg.ffn_hidden_dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.attention = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.feed_forward = FeedForward(cfg, **kw)


class LabelEmbedder(nn.Module):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        rows = cfg.num_classes + (1 if cfg.class_dropout_prob > 0 else 0)
        self.embedding_table = nn.Embedding(rows, cfg.dim, **kw)


class Transformer(nn.Module):
    """c2i GPT (inference). `cfg` is the JAX package's `GPTConfig`."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        if cfg.model_type != "c2i":
            raise NotImplementedError("t2i conditioning is not ported yet")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.cls_embedding = LabelEmbedder(cfg, **kw)
        self.layers = nn.ModuleList(TransformerBlock(cfg, **kw)
                                    for _ in range(cfg.n_layer))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.output = Linear(cfg.dim, cfg.vocab_size, **kw)
        freqs = _freqs_cis_2d_np(cfg.grid_size, cfg.head_dim, cfg.rope_base,
                                 cfg.cls_token_num)
        self.register_buffer("freqs_cis",
                             torch.tensor(freqs, device=device),
                             persistent=False)

    def embed_condition(self, labels: torch.Tensor) -> torch.Tensor:
        """Class labels [B] -> condition embeddings [B, 1, dim]."""
        return self.cls_embedding.embedding_table.weight[labels][:, None, :]


@torch.no_grad()
def init_weights(model: Transformer, seed: int = 0) -> Transformer:
    """The reference init (gpt.py:790-826): normal(0.02) matmul and
    embedding weights, unit norms, and a ZEROED output head (every logit 0:
    give the head weights before greedy decoding means anything)."""
    dev = model.freqs_cis.device
    g = torch.Generator(device=dev).manual_seed(seed)
    std = model.cfg.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name == "output.weight":
            p.zero_()
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
               dtype: torch.dtype, device) -> KVCache:
    """Zeroed bf16/f32 cache. An int8 cache comes from `quantize_cache`."""
    f2 = 2 * cfg.kv_heads * cfg.head_dim
    return KVCache([torch.zeros(batch, max_seq_len, f2, dtype=dtype,
                                device=device) for _ in range(cfg.n_layer)])


def quantize_cache(cache: KVCache, cfg: GPTConfig,
                   max_seq_len: int) -> KVCache:
    """Exact cache (e.g. after prefill) -> int8 cache of `max_seq_len` rows,
    per-row k/v scales stored bf16, padded rows with scale 1.0 (as
    `gpt.quantize_cache` in JAX). The tail is left unset: the caller seeds
    it from the exact rows."""
    f = cfg.kv_heads * cfg.head_dim
    kv, scales = [], []
    for ckv in cache.kv:
        b, src_len, _ = ckv.shape
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


def decode_stack(model: Transformer, h: torch.Tensor,
                 attend: Attend) -> torch.Tensor:
    """The layer loop + final norm + output head. h [..., D];
    attend(l, qkv) -> [..., F] owns rope, the cache update and attention.
    Returns f32 logits [..., V]."""
    for l, layer in enumerate(model.layers):
        x = layer.attention_norm(h)
        attn = attend(l, layer.attention.wqkv(x))
        h = h + layer.attention.wo(attn.to(x.dtype)).to(h.dtype)
        h = h + layer.feed_forward(layer.ffn_norm(h)).to(h.dtype)
    return model.output(model.norm(h)).float()


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H*D]: f32 scores and
    softmax, probabilities cast back to q's dtype (JAX `_sdpa`)."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(*q.shape[:2], -1)


@torch.no_grad()
def prefill(model: Transformer, cond: torch.Tensor, cache: KVCache,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the condition tokens; writes cache rows [0, T) in place and
    returns the logits at the last position [B, V] (f32). The cache must be
    bf16/f32 (int8 runs prefill into an exact cache, then quantises)."""
    if cache.quantized:
        raise ValueError("prefill into an exact cache, then quantize_cache")
    cfg = model.cfg
    t = cfg.cls_token_num
    h = model.embed_condition(cond).to(compute_dtype)
    freqs = model.freqs_cis[:t]
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    f_kv = cfg.kv_heads * cfg.head_dim

    def attend(l, qkv):
        b = qkv.shape[0]
        q, k, v = split_heads(qkv, cfg.n_head, cfg.kv_heads, cfg.head_dim)
        q, k = rope_heads(q, freqs), rope_heads(k, freqs)
        ckv = cache.kv[l]
        ckv[:, :t] = torch.cat([k.reshape(b, t, f_kv), v], dim=-1) \
            .to(ckv.dtype)
        # attend to what the cache holds, as JAX does
        kk = ckv[:, :t, :f_kv].reshape(b, t, cfg.kv_heads, cfg.head_dim)
        vv = ckv[:, :t, f_kv:].reshape(b, t, cfg.kv_heads, cfg.head_dim)
        return _sdpa(q, kk.to(q.dtype), vv.to(q.dtype), causal)

    return decode_stack(model, h, attend)[:, -1]


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, pos: int,
                cache: KVCache,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One token per row at position `pos`; runs the decode-attention
    kernel in every layer and updates the cache in place. Returns f32
    logits [B, V]."""
    cfg = model.cfg
    b = token.shape[0]
    if not 0 <= pos < cache.kv[0].shape[1]:  # the kernel writes row pos
        raise ValueError(f"pos {pos} outside the cache")
    h = model.tok_embeddings.weight[token].to(compute_dtype)
    pos_t = batch_positions(pos, b, h.device)
    freqs = model.freqs_cis[pos]
    f, f_kv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def attend(l, qkv):
        q, k, v = split_heads(qkv, cfg.n_head, cfg.kv_heads, cfg.head_dim)
        q = rope_heads(q, freqs).reshape(b, f)
        k = rope_heads(k, freqs).reshape(b, f_kv)
        return decode_attention(
            q, torch.cat([k, v], dim=-1), cache.kv[l], pos_t, cfg.n_head,
            kv_scale=cache.kv_scale[l] if cache.quantized else None,
            tail=cache.tail[l] if cache.quantized else None)

    return decode_stack(model, h, attend)
