"""T5 text encoder for t2i conditioning (flan-t5-xl's encoder, 2048 wide).

PyTorch counterpart of `llamagen_tpu/text/t5.py`. The JAX package runs
HF's `FlaxT5EncoderModel`; the port has its own encoder, `T5Encoder`, in
plain PyTorch (the GPU machine has no `transformers`), under HF's torch
state-dict keys, so a released flan-t5 `pytorch_model*.bin` or
`*.safetensors` loads with `load_state_dict`:

- T5 RMS layer norm (no mean, no bias), variance in f32, eps 1e-6;
- unscaled attention scores plus a bucketed bidirectional relative
  position bias, computed by block 0 and shared by every layer, and a key
  padding mask from `attention_mask`;
- a gated-gelu (tanh) feed-forward.

`T5TextEncoder` tokenizes with `transformers.AutoTokenizer` (host-side
text processing, imported in its constructor), fixed length
`model_max_length = 120` with an attention mask, as upstream LlamaGen
does. `left_pad_embeddings` is the t2i samplers' left-padding convention
(valid tokens right-aligned, zeros outside the mask).
"""

from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass, fields
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.text.cleaning import text_preprocessing


@dataclass(frozen=True)
class T5EncoderConfig:
    """The encoder fields of an HF `T5Config` (`config.json`); the defaults
    are flan-t5-xl's."""
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @classmethod
    def from_dict(cls, d: Mapping) -> "T5EncoderConfig":
        return cls(**{f.name: d[f.name] for f in fields(cls) if f.name in d})


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 buckets of `key - query` offsets (int64): half the
    buckets for each sign, exact below num_buckets // 4, logarithmic up to
    max_distance, f32 arithmetic as in HF's encoders."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        x = (x.float() * torch.rsqrt(var + self.eps)).to(self.weight.dtype)
        return self.weight * x


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **kw)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **kw)

    def position_bias(self, length: int) -> torch.Tensor:
        """[1, H, T, T] relative position bias (block 0's table)."""
        pos = torch.arange(length, device=self.q.weight.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv
        q, k, v = (lin(x).view(b, t, h, d).transpose(1, 2)
                   for lin in (self.q, self.k, self.v))
        # T5 scores are q . k unscaled, plus the bias (position + mask)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                             scale=1.0)
        return self.o(out.transpose(1, 2).reshape(b, t, h * d))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)


class T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.DenseReluDense = T5DenseGatedGelu(cfg, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias, **kw),
                                    T5LayerFF(cfg, **kw)])

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        h = h + attn.SelfAttention(attn.layer_norm(h), bias)
        return h + ff.DenseReluDense(ff.layer_norm(h))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0, **kw)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon, **kw)


class T5Encoder(nn.Module):
    """T5 encoder (HF `T5EncoderModel`'s forward and torch keys):
    `forward(input_ids [B, T], attention_mask [B, T]) -> [B, T, d_model]`
    in the module's dtype. Only gated-gelu feed-forwards (flan-t5)."""

    def __init__(self, cfg: T5EncoderConfig = T5EncoderConfig(),
                 device=None, dtype=None):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise ValueError(f"feed_forward_proj {cfg.feed_forward_proj!r}: "
                             f"only gated-gelu (flan-t5) is ported")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = T5Stack(cfg, **kw)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, t = input_ids.shape
        h = self.shared(input_ids)
        bias = self.encoder.block[0].layer[0].SelfAttention \
            .position_bias(t).expand(b, -1, -1, -1)
        if attention_mask is not None:  # padded keys: the dtype's minimum
            pad = attention_mask[:, None, None, :] == 0
            bias = bias.masked_fill(pad, torch.finfo(bias.dtype).min)
        for block in self.encoder.block:
            h = block(h, bias)
        return self.encoder.final_layer_norm(h)


@torch.no_grad()
def init_weights(model: T5Encoder, seed: int = 0) -> T5Encoder:
    """Seeded random weights at HF's T5 init scales (factor 1): normal(1)
    embeddings; q normal((d_model d_kv)^-1/2), k, v normal(d_model^-1/2),
    o normal((H d_kv)^-1/2); wi normal(d_model^-1/2), wo normal(d_ff^-1/2);
    the bias table normal(d_model^-1/2); unit norms."""
    cfg = model.cfg
    g = torch.Generator(device=model.shared.weight.device).manual_seed(seed)
    std = {"q": (cfg.d_model * cfg.d_kv) ** -0.5, "k": cfg.d_model ** -0.5,
           "v": cfg.d_model ** -0.5, "o": (cfg.num_heads * cfg.d_kv) ** -0.5,
           "wi_0": cfg.d_model ** -0.5, "wi_1": cfg.d_model ** -0.5,
           "wo": cfg.d_ff ** -0.5,
           "relative_attention_bias": cfg.d_model ** -0.5, "shared": 1.0}
    for name, p in model.named_parameters():
        if name.endswith("layer_norm.weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std[name.split(".")[-2]], generator=g)
    return model


def load_t5_state_dict(model_path: str) -> dict:
    """The encoder half of a local HF T5 checkpoint directory:
    `pytorch_model*.bin` (torch.load), else `*.safetensors` (where the
    `safetensors` package imports). Decoder keys and the tied
    `encoder.embed_tokens.weight` are dropped."""
    bins = sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))
    safe = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    sd = {}
    if bins:
        for f in bins:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    elif safe:
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{model_path} holds only .safetensors "
                              f"weights, and the safetensors package does "
                              f"not import") from e
        for f in safe:
            sd.update(load_file(f))
    else:
        raise FileNotFoundError(f"no pytorch_model*.bin or *.safetensors "
                                f"weights in {model_path}")
    if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    tied = "encoder.embed_tokens.weight"
    return {k: v for k, v in sd.items()
            if k == "shared.weight" or (k.startswith("encoder.")
                                        and k != tied)}


class T5TextEncoder:
    """Tokenize and encode captions with a local flan-t5 checkpoint
    directory (`config.json`, weights, tokenizer files)."""

    def __init__(self, model_path: str, model_max_length: int = 120,
                 use_text_preprocessing: bool = True,
                 device: torch.device = torch.device("cuda"),
                 dtype: torch.dtype = torch.bfloat16):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError("T5TextEncoder tokenizes with the "
                              "`transformers` package, which does not "
                              "import here") from e
        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        with open(os.path.join(model_path, "config.json")) as f:
            cfg = T5EncoderConfig.from_dict(json.load(f))
        self.model = T5Encoder(cfg, device=device, dtype=dtype)
        self.model.load_state_dict(load_t5_state_dict(model_path))
        self.model.eval()
        self.device = torch.device(device)
        self.model_max_length = model_max_length
        self.use_text_preprocessing = use_text_preprocessing

    def encode_ids(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] and mask [B, T] (on the model's device) ->
        last hidden state [B, T, d_model]."""
        return self.model(input_ids, attention_mask)

    def get_text_embeddings(self, texts: List[str]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """texts -> (embeddings [B, T, d_model], attention mask [B, T]),
        right-padded to `model_max_length`, on the model's device."""
        texts = [text_preprocessing(t, self.use_text_preprocessing)
                 for t in texts]
        tok = self.tokenizer(
            texts, max_length=self.model_max_length, padding="max_length",
            truncation=True, return_attention_mask=True,
            add_special_tokens=True, return_tensors="np")
        ids = torch.as_tensor(tok["input_ids"]).long().to(self.device)
        mask = torch.as_tensor(tok["attention_mask"]).long().to(self.device)
        return self.encode_ids(ids, mask), mask


def left_pad_embeddings(emb: np.ndarray, mask: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-align valid caption tokens (upstream sample_t2i.py:92-106).

    emb: [B, T, C] right-padded T5 output; mask: [B, T] 1=valid.
    Returns (left-padded embeddings with zeros outside the mask,
    left-padded mask).
    """
    emb = np.asarray(emb)
    mask = np.asarray(mask)
    b, t, _ = emb.shape
    new_emb = np.zeros_like(emb)
    new_mask = np.zeros_like(mask)
    for i in range(b):
        valid_n = int(mask[i].sum())
        new_emb[i, t - valid_n:] = emb[i, :valid_n]
        new_mask[i, t - valid_n:] = 1
    return new_emb, new_mask
