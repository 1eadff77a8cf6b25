"""Autoregressive sampling with classifier-free guidance, c2i and t2i.

Counterpart of `llamagen_tpu/ops/generate.py::generate` on its kernel path:
prefill of the [cond ‖ null] double batch, then a Python loop of
`decode_step` (decode-attention kernel in every layer) -> `cfg_mix` ->
penalties -> `sample`. t2i captions are left-padded: `emb_masks` masks the
pad rows in the prefill and, as `prefix_pad` counts, in every decode step.
The JAX scan becomes a plain loop; CUDA graphs are later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from llamagen_tpu_torch.config import find_multiple
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.attention import TAIL


def build_cfg_batch(model: gpt.Transformer, cond: torch.Tensor,
                    use_cfg: bool) -> torch.Tensor:
    """[cond ‖ null] double batch: the null class (c2i) or the learned null
    caption `uncond_embedding` broadcast to cond's shape (t2i)."""
    if not use_cfg:
        return cond
    if model.cfg.model_type == "c2i":
        null = torch.full_like(cond, model.cfg.num_classes)
    else:
        null = model.cls_embedding.uncond_embedding.to(cond.dtype)[None] \
            .expand(cond.shape)
    return torch.cat([cond, null])


def caption_masks(emb_masks: Optional[torch.Tensor], t: int, use_cfg: bool
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """t2i left-pad masks [B, T] -> (prefill `prefix_mask` [Bc, T] bool,
    decode `prefix_pad` int32 [Bc] = T - valid count), doubled under CFG;
    (None, None) without masks."""
    if emb_masks is None:
        return None, None
    m = emb_masks.bool()
    if use_cfg:
        m = torch.cat([m, m])
    return m, (t - m.sum(dim=1)).to(torch.int32)


@torch.no_grad()
def generate(model: gpt.Transformer, cond: torch.Tensor, *,
             max_new_tokens: int,
             emb_masks: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             cfg_scale: float = 1.0, cfg_interval: int = -1,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
             repetition_penalty: float = 1.0, sample_logits: bool = True,
             compute_dtype: torch.dtype = torch.bfloat16,
             cache_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Sample `max_new_tokens` code-grid tokens for class labels `cond [B]`
    (c2i) or caption features `cond [B, T, caption_dim]` (t2i), on the
    model's device; emb_masks: optional [B, T] caption validity (left
    padding). `generator` lives on that device too. cache_dtype torch.int8
    keeps an int8 KV cache with an exact 32-row tail. Returns token ids
    [B, max_new_tokens] (int64)."""
    cfg = model.cfg
    dev = cond.device
    use_cfg = cfg_scale > 1.0
    t = cfg.cls_token_num
    batch_cfg = 2 * cond.shape[0] if use_cfg else cond.shape[0]
    max_seq = find_multiple(t + max_new_tokens, 128)
    quantize_kv = cache_dtype == torch.int8
    kvh = model.n_local_kv_heads  # a TP shard's cache holds its own heads

    cond_combined = build_cfg_batch(model, cond, use_cfg)
    if quantize_kv:
        # prefill into a small exact staging cache, then quantise it and
        # seed the tail from its exact rows
        cache = gpt.init_cache(cfg, batch_cfg, find_multiple(t + TAIL, 8),
                               compute_dtype, dev, kv_heads=kvh)
    else:
        cache = gpt.init_cache(cfg, batch_cfg, max_seq, cache_dtype, dev,
                               kv_heads=kvh)
    prefix_mask, prefix_pad = caption_masks(emb_masks, t, use_cfg)
    logits = gpt.prefill(model, cond_combined, cache, compute_dtype,
                         prefix_mask=prefix_mask)
    if quantize_kv:
        stage = cache
        cache = gpt.quantize_cache(stage, cfg, max_seq)
        base = t // TAIL * TAIL
        cache.tail = [ckv[:, base:base + TAIL].clone() for ckv in stage.kv]

    use_pen = (presence_penalty != 0.0 or frequency_penalty != 0.0
               or repetition_penalty != 1.0)
    counts = (torch.zeros(cond.shape[0], cfg.vocab_size, dtype=torch.int32,
                          device=dev) if use_pen else None)
    sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                     sample_logits=sample_logits)

    def next_token(logits, enabled=True):
        if use_cfg:
            logits = sampling.cfg_mix(logits, cfg_scale, enabled=enabled)
        if use_pen:  # after the CFG mix, as in the reference sampler
            logits = sampling.apply_penalties(
                logits, counts, presence=presence_penalty,
                frequency=frequency_penalty, repetition=repetition_penalty)
        tok = sampling.sample(logits, generator, **sample_kw)
        if use_pen:
            sampling.update_output_counts(counts, tok)
        return tok

    tokens = [next_token(logits)]
    for i in range(max_new_tokens - 1):
        cur = tokens[-1]
        inp = torch.cat([cur, cur]) if use_cfg else cur
        logits = gpt.decode_step(model, inp, t + i, cache,
                                 compute_dtype=compute_dtype,
                                 prefix_pad=prefix_pad)
        tokens.append(next_token(
            logits, enabled=cfg_interval < 0 or i <= cfg_interval))
    return torch.stack(tokens, dim=1)
