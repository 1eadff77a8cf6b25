"""Speculative decoding: draft-model proposals, a (k+1)-token target verify.

PyTorch counterpart of `llamagen_tpu/ops/speculative.py` on its kernel
path. Each round the draft proposes k tokens in k + 1 single-token steps
(the extra step consumes the k-th proposal, so the draft cache holds every
row an all-accept round commits), the target scores the C = k + 1 tokens
[cur, proposals] in ONE forward, and standard speculative sampling accepts
a prefix and resamples (Leviathan et al., arXiv 2211.17192; Chen et al.,
arXiv 2302.01318): the committed tokens follow the target's distribution
exactly, and greedy decoding commits exactly the target's greedy chain.

Both the verify and the draft steps run through `verify_step_slots`, the
shared decode layer stack with the chunk-attention kernel
(`ops/chunk_attention.py`) in every layer: C = k + 1 for the verify, C = 1
for the draft steps (JAX's kernel mode, speculative.py:353-361). The
single-token kernel is not used for the draft: a rejection moves positions
backward, which the chunk kernel's cache-only state survives. Every
matmul runs on rank-2 activations, so W8A16 and W4 weights take their
kernels; "a W4-quantised copy of the target drafting for it"
(self-speculation) is the configuration that runs both K3 and K5.

The JAX `lax.while_loop` becomes a Python loop. Each round reads the
accepted counts back to the host once (the loop's condition needs them);
positions are built on the host, checked against the cache, and sent to
the device once per forward. Not supported, as in JAX: penalties,
cfg_interval and int8 KV caches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llamagen_tpu_torch.config import find_multiple
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
from llamagen_tpu_torch.ops.generate import build_cfg_batch, caption_masks


def warped_probs(logits: torch.Tensor, temperature: float, top_k: int,
                 top_p: float) -> torch.Tensor:
    """The exact probability vector `sampling.sample` draws from:
    softmax(filter(logits / T)). Acceptance must test against the same
    warped distributions the proposals were drawn from."""
    logits = logits.float() / max(temperature, 1e-5)
    logits = sampling.filter_logits(logits, top_k=top_k, top_p=top_p)
    return torch.softmax(logits, dim=-1)


@torch.no_grad()
def verify_step_slots(model: gpt.Transformer, toks: torch.Tensor,
                      pos: torch.Tensor, cache: gpt.KVCache,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      prefix_pad: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """C-token chunk forward with per-row positions.

    toks: [B, C] token ids at positions pos[b] .. pos[b] + C - 1; pos:
    int32 [B] on the model's device. Writes the chunk's k|v rows into the
    bf16/f32 cache in place and returns f32 logits [B, C, V]: row j is the
    target distribution for the token at position pos[b] + j + 1. The
    layer body is `gpt.decode_stack` (matmuls at [B * C, D]) with the
    chunk-attention kernel in every layer."""
    cfg = model.cfg
    b, c = toks.shape
    if cache.quantized:
        raise ValueError("speculative decoding runs bf16/f32 KV caches")
    h = model.tok_embeddings.weight[toks].to(compute_dtype)  # [B, C, D]
    posj = pos.long()[:, None] + torch.arange(c, device=toks.device)
    # rows past the table (overshoot of finished rows, never committed) take
    # its last row, as JAX's clamped gather does
    freqs = model.freqs_cis[posj.clamp(max=model.freqs_cis.shape[0] - 1)]
    f, f_kv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def attend(l, qkv):
        q, k, v = gpt.split_heads(qkv, cfg.n_head, cfg.kv_heads,
                                  cfg.head_dim)
        q = gpt.rope_heads(q, freqs).reshape(b, c, f)
        k = gpt.rope_heads(k, freqs).reshape(b, c, f_kv)
        return chunk_decode_attention(q, torch.cat([k, v], dim=-1),
                                      cache.kv[l], pos, cfg.n_head,
                                      prefix_pad=prefix_pad)

    return gpt.decode_stack(model, h, attend)


def spec_accept(proposals: torch.Tensor, q_probs: torch.Tensor,
                p_probs: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sample_logits: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative acceptance and residual resampling.

    proposals [B, k] (drawn from q_probs), q_probs [B, k, V] (the draft's
    distribution at each proposal), p_probs [B, k + 1, V] (the target's at
    the k proposal slots and the bonus slot). Returns (tokens [B, k + 1],
    n_new [B] in 1..k+1): tokens[:, :n_new - 1] are accepted proposals,
    tokens[:, n_new - 1] the residual draw at the first rejection (or the
    bonus draw when all are accepted); entries past n_new are filler.
    Greedy mode accepts while a proposal equals the target's argmax.
    """
    b, k = proposals.shape
    dev = proposals.device
    jpos = torch.arange(k + 1, device=dev)[None, :]
    prop_pad = F.pad(proposals, (0, 1))
    if not sample_logits:
        tgt = p_probs.argmax(dim=-1)                          # [B, k+1]
        acc = tgt[:, :k] == proposals
        n_acc = acc.long().cumprod(dim=1).sum(dim=1)
        final = tgt.gather(1, n_acc[:, None])[:, 0]
        return (torch.where(jpos < n_acc[:, None], prop_pad, final[:, None]),
                n_acc + 1)

    u = torch.rand((b, k), generator=generator, device=dev)
    q_at = q_probs.gather(-1, proposals[..., None])[..., 0]
    p_at = p_probs[:, :k].gather(-1, proposals[..., None])[..., 0]
    acc = u * q_at < p_at  # accept iff u < p / q (q > 0: drawn from q)
    n_acc = acc.long().cumprod(dim=1).sum(dim=1)
    # residual at the first rejected slot: normalize(max(p - q, 0)); all
    # accepted: the bonus draw from p_probs[:, k] (q := 0 makes the same
    # formula exact)
    rows = torch.arange(b, device=dev)
    p_sel = p_probs[rows, n_acc]
    q_sel = q_probs[rows, n_acc.clamp(max=k - 1)]
    q_sel = torch.where((n_acc < k)[:, None], q_sel, torch.zeros_like(q_sel))
    res = (p_sel - q_sel).clamp_min(0.0)
    tot = res.sum(dim=-1, keepdim=True)
    res = torch.where(tot > 0, res / tot.clamp_min(1e-20), p_sel)
    logp = torch.where(res > 0, torch.log(res.clamp_min(1e-30)),
                       torch.full_like(res, float("-inf")))
    final = (logp + sampling.gumbel(logp.shape, generator, dev)).argmax(-1)
    return (torch.where(jpos < n_acc[:, None], prop_pad, final[:, None]),
            n_acc + 1)


@torch.no_grad()
def generate_speculative(model: gpt.Transformer, draft: gpt.Transformer,
                         cond: torch.Tensor, *, max_new_tokens: int,
                         k: int = 4,
                         emb_masks: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         cfg_scale: float = 1.0, temperature: float = 1.0,
                         top_k: int = 0, top_p: float = 1.0,
                         sample_logits: bool = True,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         force_accept: Optional[int] = None
                         ) -> Tuple[torch.Tensor, int]:
    """Speculative sampling of `max_new_tokens` grid tokens for class
    labels `cond [B]` or caption features `cond [B, T, caption_dim]` with
    optional left-pad masks `emb_masks [B, T]` (on the models' device).

    Drop-in for `ops.generate.generate` (same conditioning, CFG and warp
    semantics, minus penalties and cfg_interval): `model` is the target,
    `draft` the cheap proposal model, e.g. a W4-quantised copy of the
    target (self-speculation). Caches are compute_dtype (bf16/f32).

    Returns (tokens [B, max_new_tokens] int64, rounds): rounds is the number
    of verify forwards. force_accept (benchmark harness only) commits
    exactly min(force_accept, k) proposals + 1 per round whatever the
    accept test says, keeping every other computation real; its tokens are
    not target-distributed.
    """
    cfg, dcfg = model.cfg, draft.cfg
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError("the draft and the target vocabularies must match")
    if dcfg.cls_token_num != cfg.cls_token_num \
            or dcfg.model_type != cfg.model_type:
        raise ValueError("the draft must share the conditioning geometry")
    dev = cond.device
    use_cfg = cfg_scale > 1.0
    t = cfg.cls_token_num
    batch = cond.shape[0]
    batch_cfg = 2 * batch if use_cfg else batch
    c = k + 1
    # the verify writes k rows past the last committed one
    max_seq = find_multiple(t + max_new_tokens + c + 16, 128)

    tcache = gpt.init_cache(cfg, batch_cfg, max_seq, compute_dtype, dev)
    dcache = gpt.init_cache(dcfg, batch_cfg, max_seq, compute_dtype, dev)
    prefix_mask, prefix_pad = caption_masks(emb_masks, t, use_cfg)
    tlogits = gpt.prefill(model, build_cfg_batch(model, cond, use_cfg),
                          tcache, compute_dtype, prefix_mask=prefix_mask)
    gpt.prefill(draft, build_cfg_batch(draft, cond, use_cfg), dcache,
                compute_dtype, prefix_mask=prefix_mask)
    sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                     sample_logits=sample_logits)
    if use_cfg:
        tlogits = sampling.cfg_mix(tlogits, cfg_scale)
    cur = sampling.sample(tlogits, generator, **sample_kw)    # [B]

    # column max_new_tokens is the trash slot of overshoot writes
    out = torch.zeros(batch, max_new_tokens + 1, dtype=torch.long,
                      device=dev)
    out[:, 0] = cur
    n_out = np.ones(batch, np.int64)  # committed tokens per row (host)
    jc = np.arange(c)

    def dbl(x):
        return torch.cat([x, x]) if use_cfg else x

    def positions(p: np.ndarray, width: int) -> torch.Tensor:
        if p.max() + width > max_seq:
            raise ValueError(f"position {p.max()} + {width} outside the "
                             f"cache of {max_seq} rows")
        return dbl(torch.as_tensor(p, dtype=torch.int32)).to(dev)

    rounds = 0
    while (n_out < max_new_tokens).any() and rounds < max_new_tokens:
        p = t + n_out - 1  # position of cur, not yet in either cache
        props, qps, cur_d = [], [], cur
        for j in range(k + 1):
            logits = verify_step_slots(draft, dbl(cur_d)[:, None],
                                       positions(p + j, 1), dcache,
                                       compute_dtype, prefix_pad)[:, 0]
            if use_cfg:
                logits = sampling.cfg_mix(logits, cfg_scale)
            qps.append(warped_probs(logits, temperature, top_k, top_p))
            cur_d = sampling.sample(logits, generator, **sample_kw)
            props.append(cur_d)
        props = torch.stack(props[:k], dim=1)                  # [B, k]
        qps = torch.stack(qps[:k], dim=1)                      # [B, k, V]

        toks = torch.cat([cur[:, None], props], dim=1)         # [B, C]
        vlogits = verify_step_slots(model, dbl(toks), positions(p, c),
                                    tcache, compute_dtype, prefix_pad)
        if use_cfg:
            vlogits = sampling.cfg_mix(vlogits, cfg_scale)
        pps = warped_probs(vlogits, temperature, top_k, top_p)  # [B, C, V]
        tokens, n_new = spec_accept(props, qps, pps, generator,
                                    sample_logits=sample_logits)
        if force_accept is not None:
            n_forced = min(force_accept, k) + 1
            final = tokens.gather(1, (n_new - 1)[:, None])
            tokens = torch.where(torch.arange(c, device=dev)[None, :]
                                 < n_forced - 1, F.pad(props, (0, 1)), final)
            n_new = torch.full_like(n_new, n_forced)

        n_new_h = n_new.cpu().numpy()  # the round's one read-back
        widx = n_out[:, None] + jc[None, :]
        valid = (jc[None, :] < n_new_h[:, None]) & (widx < max_new_tokens)
        out.scatter_(1, torch.as_tensor(
            np.where(valid, widx, max_new_tokens)).to(dev), tokens)
        done = n_out >= max_new_tokens
        last = tokens.gather(1, (n_new - 1)[:, None])[:, 0]
        cur = torch.where(torch.as_tensor(done).to(dev), cur, last)
        n_out = np.where(done, n_out,
                         np.minimum(n_out + n_new_h, max_new_tokens))
        rounds += 1
    return out[:, :max_new_tokens], rounds
