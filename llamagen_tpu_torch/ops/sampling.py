"""Token sampling: temperature, top-k, top-p, categorical; CFG mix and
penalties.

Counterpart of `llamagen_tpu/ops/sampling.py`: the static-parameter
functions of `generate`, whose CFG mix, top-p filter and penalties also
take `[B]` tensors, one value per row, and the per-slot filter and sampler
of the serving engine (`serve/engine.py`), so one step serves requests
with different settings. Draws use Gumbel-max with an explicit
`torch.Generator` on the logits' device: the same distribution as JAX's
`categorical`, from another random stream.
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


def _rows(x):
    """A per-row parameter ([B] tensor) as a [B, 1] column; a Python
    scalar as it is."""
    return x[:, None] if torch.is_tensor(x) else x


def _nucleus_threshold(sorted_logits: torch.Tensor, top_p) -> torch.Tensor:
    """[B, 1]: the smallest logit of each row's nucleus (the smallest
    descending-probability prefix whose cumulative probability exceeds
    top_p; the crossing token stays), from the row's logits sorted in
    descending order. top_p a float or [B] (a row at >= 1 keeps all)."""
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = exclusive <= _rows(top_p)
    pth = torch.where(keep, sorted_logits, float("inf")) \
        .amin(dim=-1, keepdim=True)
    if torch.is_tensor(top_p):
        pth = torch.where((top_p >= 1.0)[:, None], NEG_INF, pth)
    return pth


def top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering; top_p a float (>= 1 skips the sort) or a [B]
    tensor, one per row."""
    if not torch.is_tensor(top_p) and top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    return logits.masked_fill(
        logits < _nucleus_threshold(sorted_logits, top_p), NEG_INF)


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


def filter_logits_per_slot(logits: torch.Tensor, top_k: torch.Tensor,
                           top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k / top-p with `[B]` parameters: top_k int (0 = off),
    top_p f32 (>= 1 = off). One descending sort serves both thresholds, so
    top-p reads the unfiltered distribution (as JAX's per-slot filter
    does); ties at a threshold are kept, as in the static filters."""
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    kk = top_k.long().clamp(0, v)
    kth = sorted_logits.gather(-1, (kk - 1).clamp_min(0)[:, None])
    kth = torch.where((kk > 0)[:, None], kth, NEG_INF)
    thr = torch.maximum(kth, _nucleus_threshold(sorted_logits, top_p))
    return logits.masked_fill(logits < thr, NEG_INF)


def sample_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    filters_off: bool = False) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64) with `[B]` parameters:
    temperature <= 0 is greedy argmax, top_k 0 and top_p >= 1 are off.

    `filters_off` is the caller's host-side knowledge that every row has
    its filters off (the engine knows each slot's parameters from
    admission): the `[B, V]` sort is then skipped, where JAX gates it on a
    device value (`lax.cond`); reading a device value here would stall the
    host on every step."""
    logits = logits.float() / temperature.float().clamp_min(1e-5)[:, None]
    if not filters_off:
        logits = filter_logits_per_slot(logits, top_k, top_p)
    drawn = (logits + gumbel(logits.shape, generator, logits.device)) \
        .argmax(dim=-1)
    return torch.where(temperature <= 0.0, logits.argmax(dim=-1), drawn)


def cfg_mix(logits: torch.Tensor, cfg_scale,
            enabled: bool = True) -> torch.Tensor:
    """[cond ‖ uncond] logits [2B, V] -> uncond + (cond - uncond) * scale;
    cfg_scale a float or a [B] tensor, one per pair (the serving engine's
    slots); scale 1.0 when not `enabled` (cfg_interval)."""
    cond, uncond = logits.chunk(2, dim=0)
    return uncond + (cond - uncond) * (_rows(cfg_scale) if enabled else 1.0)


def apply_penalties(logits: torch.Tensor, output_counts: torch.Tensor,
                    presence=0.0, frequency=0.0,
                    repetition=1.0) -> torch.Tensor:
    """Repetition (seen tokens: logit / r if > 0 else logit * r), then
    frequency (- f * count) and presence (- p * seen). Each parameter is
    a float (an off value skips its term) or a [B] tensor, one per row (a
    row with presence 0, frequency 0 and repetition 1 is left exactly as
    it was)."""
    seen = output_counts > 0
    on = torch.is_tensor
    if on(repetition) or repetition != 1.0:
        rep = torch.where(seen, _rows(repetition), 1.0).to(logits.dtype)
        logits = torch.where(logits > 0, logits / rep, logits * rep)
    if on(frequency) or frequency != 0.0:
        logits = logits - _rows(frequency) * output_counts.to(logits.dtype)
    if on(presence) or presence != 0.0:
        logits = logits - _rows(presence) * seen.to(logits.dtype)
    return logits


def update_output_counts(counts: torch.Tensor, tokens: torch.Tensor,
                         going: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """counts [B, V] += onehot(tokens [B]) on the rows where `going` ([B]
    bool; every row when None), in place; returns counts."""
    rows = torch.arange(counts.shape[0], device=counts.device)
    counts[rows, tokens] += 1 if going is None else going.to(counts.dtype)
    return counts
