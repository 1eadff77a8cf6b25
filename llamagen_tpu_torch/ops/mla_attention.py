"""Multi-head latent attention (DeepSeek-V2's MLA) at decode, absorbed,
with an in-place latent cache: K6.

The cache holds one row per position, shared by every head: `[c_kv ‖
k_pe]`, the RMS-normed `kv_lora_rank` latent and the roped
`qk_rope_head_dim` key (`[B, S, R + P]` per layer, R + P = 576 for
DeepSeek-V2). With the up-projection of k absorbed into the query
(`q̃_h = W_UK,hᵀ q_nope,h`, `models/mla_moe.py`), head h's query is `[q̃_h
‖ q_pe,h]` (R + P wide), its score against position j is that query dotted
with row j, and its output is the softmax-weighted sum of the rows' first R
lanes (the latent), which `W_UV,h` maps to v-space after this call. So 16
query heads read one 576-wide key and one 512-wide value per position:
9x fewer cache bytes per head-position than multi-head attention at
DeepSeek-V2's widths.

`mla_decode_attention` launches `csrc/mla_decode.cu`'s
`mla_decode_kernel` on CUDA tensors (one launch per call, counted in
`mla_decode_attention.launches`) and computes `mla_decode_attention_ref`,
the plain version with the same signature, on CPU tensors. The kernel
replaces no TPU kernel: the JAX package has no latent attention. It is
bound by reading the cache rows [0, pos) once per batch row (1,152 bytes a
row at DeepSeek-V2's widths): one block per batch row holds the 16 heads'
queries, streams the rows in tiles through two `mma.sync` products (the
heads' scores against the whole row, the weighted sum of the latent
lanes) with an online softmax in f32, and reads each tile once for both.
"""

from __future__ import annotations

import torch

from llamagen_tpu_torch.ops import _build

HEADS, RANK, ROPE = 16, 512, 64  # the kernel's heads, latent and rope lanes


def _check(q, kv_new, cache, pos, rank):
    b, h, width = q.shape
    if cache.dim() != 3 or cache.shape[0] != b or cache.shape[2] != width:
        raise ValueError(f"cache {tuple(cache.shape)} for q {tuple(q.shape)}")
    if kv_new.shape != (b, width):
        raise ValueError(f"kv_new {tuple(kv_new.shape)}, expected "
                         f"{(b, width)}")
    if pos.shape != (b,):
        raise ValueError(f"pos {tuple(pos.shape)}, expected {(b,)}")
    if not 0 < rank < width:
        raise ValueError(f"rank {rank} outside (0, {width})")


def mla_decode_attention_ref(q: torch.Tensor, kv_new: torch.Tensor,
                             cache: torch.Tensor, pos: torch.Tensor,
                             rank: int, scale: float) -> torch.Tensor:
    """Plain version of `mla_decode_attention`: write row `pos` of each
    batch row, then f32 scores over rows [0, pos], f32 softmax, the
    probabilities rounded to q's dtype, their f32 product with the rows'
    first `rank` lanes, one rounding to q's dtype."""
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)
    cache[rows, pos.long()] = kv_new.to(cache.dtype)
    c = cache.float()
    s = torch.einsum("bhl,bsl->bhs", q.float(), c) * scale
    keys = torch.arange(cache.shape[1], device=q.device)
    s = s.masked_fill(keys[None, None, :] > pos.long()[:, None, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return torch.einsum("bhs,bsr->bhr", p, c[..., :rank]).to(q.dtype)


def mla_decode_attention(q: torch.Tensor, kv_new: torch.Tensor,
                         cache: torch.Tensor, pos: torch.Tensor, rank: int,
                         scale: float) -> torch.Tensor:
    """One decode step of absorbed latent attention, the cache updated in
    place.

    q [B, H, L] (per head: the absorbed nope query, `rank` lanes, then the
    roped rope query), kv_new [B, L] this step's row (`[c_kv ‖ k_pe]`),
    cache [B, S, L] (row pos[b] of batch row b is written with kv_new[b]),
    pos int32 [B], each inside the cache (not checked: a position tensor is
    not read back to the host). Returns [B, H, rank] in q's dtype: the
    softmax over rows [0, pos] of (q · row) * scale, times the rows' first
    `rank` lanes.

    On CUDA tensors (bf16 q, cache and kv_new; DeepSeek-V2's 16 heads, rank
    512 and rope 64) one launch of K6, counted in
    `mla_decode_attention.launches`; on CPU tensors
    `mla_decode_attention_ref`.
    """
    _check(q, kv_new, cache, pos, rank)
    if not q.is_cuda:
        return mla_decode_attention_ref(q, kv_new, cache, pos, rank, scale)
    if not (q.dtype == kv_new.dtype == cache.dtype == torch.bfloat16):
        raise TypeError("the kernel takes bf16 q, kv_new and cache, not "
                        f"{q.dtype}, {kv_new.dtype}, {cache.dtype}")
    if not (kv_new.device == cache.device == pos.device == q.device):
        raise ValueError("q, kv_new, cache and pos must be on one device")
    b, h, width = q.shape
    if (h, rank, width - rank) != (HEADS, RANK, ROPE):
        raise ValueError(f"the kernel takes {HEADS} heads, rank {RANK} and "
                         f"rope {ROPE}: H={h}, rank {rank}, rope "
                         f"{width - rank}")
    if not cache.is_contiguous() or pos.dtype != torch.int32:
        raise ValueError("the cache must be contiguous and pos int32")
    q = q.contiguous()
    kv_new = kv_new.contiguous()
    pos = pos.contiguous()
    out = torch.empty((b, h, rank), dtype=q.dtype, device=q.device)
    fn = _build.c_function("mla_decode_attention_bf16", 5, 5, 1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), kv_new.data_ptr(), cache.data_ptr(),
                    pos.data_ptr(), out.data_ptr(), b, cache.shape[1], h,
                    rank, width - rank, scale, stream),
                 "mla_decode_attention_bf16")
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
