"""Token sampling: temperature, top-k, top-p, categorical; CFG mix and
penalties.

Counterpart of `llamagen_tpu/ops/sampling.py` (the static-parameter
functions; the per-slot variants come with the serving engine). Draws use
Gumbel-max with an explicit `torch.Generator` on the logits' device: the
same distribution as JAX's `categorical`, from another random stream.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top_k largest logits per row; ties at the threshold stay."""
    if top_k <= 0:
        return logits
    k = min(max(top_k, 1), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest descending-probability prefix
    whose cumulative probability exceeds top_p (the crossing token stays)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = exclusive <= top_p
    thresholds = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresholds, NEG_INF)


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    return top_p_filter(top_k_filter(logits, top_k), top_p)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
           sample_logits: bool = True) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64). Greedy is argmax."""
    logits = logits.float() / max(temperature, 1e-5)
    logits = filter_logits(logits, top_k=top_k, top_p=top_p)
    if not sample_logits:
        return logits.argmax(dim=-1)
    return (logits + gumbel(logits.shape, generator, logits.device)) \
        .argmax(dim=-1)


def gumbel(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), f32, with u in [tiny, 1) as JAX
    draws it (`jax.random.gumbel`): `torch.rand` is in [0, 1), and u = 0
    would give -inf, a token that could never be drawn."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def cfg_mix(logits: torch.Tensor, cfg_scale: float,
            enabled: bool = True) -> torch.Tensor:
    """[cond ‖ uncond] logits [2B, V] -> uncond + (cond - uncond) * scale;
    scale 1.0 when not `enabled` (cfg_interval)."""
    cond, uncond = logits.chunk(2, dim=0)
    return uncond + (cond - uncond) * (cfg_scale if enabled else 1.0)


def apply_penalties(logits: torch.Tensor, output_counts: torch.Tensor,
                    presence: float = 0.0, frequency: float = 0.0,
                    repetition: float = 1.0) -> torch.Tensor:
    """Repetition (seen tokens: logit / r if > 0 else logit * r), then
    frequency (- f * count) and presence (- p * seen)."""
    seen = output_counts > 0
    if repetition != 1.0:
        rep = torch.where(seen, torch.full_like(logits, repetition),
                          torch.ones_like(logits))
        logits = torch.where(logits > 0, logits / rep, logits * rep)
    if frequency != 0.0:
        logits = logits - frequency * output_counts.to(logits.dtype)
    if presence != 0.0:
        logits = logits - presence * seen.to(logits.dtype)
    return logits


def update_output_counts(counts: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """counts [B, V] += onehot(tokens [B]), in place; returns counts."""
    rows = torch.arange(counts.shape[0], device=counts.device)
    counts[rows, tokens] += 1
    return counts
