"""Chunk decode attention: C query rows per batch row, in-place KV cache.

PyTorch counterpart of `llamagen_tpu/ops/chunk_attention.py::
chunk_decode_attention`, the attention of speculative decoding's verify
step (C = k + 1) and of its draft steps (C = 1). `chunk_decode_attention`
launches the hand-written CUDA kernel `csrc/chunk_attention.cu` on CUDA
tensors and computes `chunk_decode_attention_ref`, the plain version with
the same signature, on CPU tensors.

Semantics (the JAX kernel's):
  - the chunk's k|v rows are written into the cache at rows pos[b] + i,
    i < C; rows below pos[b] are left as they are;
  - query c of row b attends cache rows [prefix_pad[b], pos[b] + c], so the
    chunk is causal within itself; query head h reads kv head
    h // (H / H_kv) (GQA);
  - bf16 / f32 caches only (an int8 cache raises: int8 stays on the
    single-token kernel), and pos[b] + C must not pass the cache's end.
Positions may move backward between calls (a rejected proposal): the cache
is the only state, so rows at or above pos are simply overwritten. Rows at
or above pos + C are never touched here; the JAX kernel may rewrite part
of an aligned tile there, so tests compare rows below pos + C only.

The TPU kernel's epoch tiles, recent window, cache blocking, 8-row chunk
padding and tiled head order exist for Mosaic's DMA and layout rules and
are not ported: a Hopper kernel writes single rows.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import torch

from llamagen_tpu_torch.ops import _build
from llamagen_tpu_torch.ops.attention import HEAD_DIMS, batch_positions

MAX_CHUNK = 8  # query rows the kernel takes (the JAX kernel's CP tile)
# csrc/attention_mma.cuh's tensor-core kernel (attn_mma_kernel)
_WARPS, _TILE, _STAGES = 4, 64, 3  # warps, rows a tile, ring stages
_MAX_SPLIT = 8                     # blocks per cluster (kMaxSplit)
_MAX_SMEM = 232448                 # 227 KB (kMaxSmem)

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}

Pos = Union[int, torch.Tensor]


def _check(q, kv_new, kv_cache, pos, n_head):
    if q.dim() != 3 or kv_new.dim() != 3 or kv_cache.dim() != 3:
        raise ValueError(f"q [B, C, F], kv_new [B, C, 2F_kv], kv_cache "
                         f"[B, S, 2F_kv]; got {tuple(q.shape)}, "
                         f"{tuple(kv_new.shape)}, {tuple(kv_cache.shape)}")
    b, c, f = q.shape
    if kv_cache.dtype == torch.int8:
        raise TypeError("chunk_decode_attention takes bf16/f32 caches; "
                        "int8 caches stay on decode_attention")
    if f % n_head:
        raise ValueError(f"F={f} is not a multiple of n_head={n_head}")
    d = f // n_head
    f_kv = kv_cache.shape[2] // 2
    if kv_cache.shape[0] != b or kv_cache.shape[2] % (2 * d) \
            or n_head % (f_kv // d):
        raise ValueError(f"kv_cache {tuple(kv_cache.shape)} for q "
                         f"{tuple(q.shape)}, {n_head} heads")
    if kv_new.shape != (b, c, 2 * f_kv):
        raise ValueError(f"kv_new {tuple(kv_new.shape)}, expected "
                         f"{(b, c, 2 * f_kv)}")
    s_len = kv_cache.shape[1]
    # positions known on the host are checked here; device positions are
    # the caller's (ops/speculative.py checks them on the host) and the
    # kernel never writes past row S - 1
    if isinstance(pos, int) or not pos.is_cuda:
        p = torch.as_tensor(pos)
        if p.numel() and (int(p.min()) < 0 or int(p.max()) + c > s_len):
            raise ValueError(f"positions {p.tolist()} + chunk {c} outside "
                             f"the cache of {s_len} rows")
    return b, c, f, d, f_kv, s_len


def chunk_decode_attention_ref(q: torch.Tensor, kv_new: torch.Tensor,
                               kv_cache: torch.Tensor, pos: Pos, n_head: int,
                               prefix_pad: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of `chunk_decode_attention` (same signature and
    in-place update): dense f32 einsums over the whole cache."""
    b, c, f, d, f_kv, s_len = _check(q, kv_new, kv_cache, pos, n_head)
    h_kv = f_kv // d
    rep = n_head // h_kv
    dev = q.device
    pos = batch_positions(pos, b, dev).long()
    pad = (torch.zeros(b, dtype=torch.long, device=dev) if prefix_pad is None
           else batch_positions(prefix_pad, b, dev).long())
    rows = pos[:, None] + torch.arange(c, device=dev)          # [B, C]
    kv_cache[torch.arange(b, device=dev)[:, None], rows] = \
        kv_new.to(kv_cache.dtype)

    def heads(x):  # [B, S, F_kv] -> [B, S, H, D] f32; head h reads h // rep
        return x.float().view(b, s_len, h_kv, d).repeat_interleave(rep, 2)

    qf = q.float().view(b, c, n_head, d) * d ** -0.5
    scores = torch.einsum("bchd,bshd->bhcs", qf, heads(kv_cache[..., :f_kv]))
    s_idx = torch.arange(s_len, device=dev)
    valid = (s_idx <= rows[..., None]) & (s_idx >= pad[:, None, None])
    probs = torch.softmax(scores.masked_fill(~valid[:, None], float("-inf")),
                          dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", probs, heads(kv_cache[..., f_kv:]))
    return out.reshape(b, c, f).to(q.dtype)


class ChunkGeometry(NamedTuple):
    """Launch geometry of the tensor-core kernel: `nq` query heads of one
    kv head a block, `nsplit` blocks a cluster splitting the rows, `smem`
    bytes of shared memory a block."""
    nq: int
    nsplit: int
    smem: int


def padded_dim(d: int) -> int:
    """head_dim rounded up to the kernel's k16 steps (100 -> 112)."""
    return -(-d // 16) * 16


def _smem_bytes(d: int, nq: int, int8: bool = False) -> int:
    """The kernel's mma_smem_bytes: the k/v ring of bf16 rows (head_dim 64
    and 128: head_dim lanes; 100: 120 lanes), or with an int8 cache one
    bf16 tile and the int8 ring (4 stages, 3 at head_dim 100) with a scale
    word a row; or the states of the warps and of the block over the
    padded head_dim."""
    ring_row = d if d % 64 == 0 else padded_dim(d) + 8
    if int8:
        stages = 4 if d % 64 == 0 else 3
        ring = 2 * _TILE * ring_row * 2 \
            + stages * _TILE * (2 * padded_dim(d) + 4)
    else:
        ring = 2 * _STAGES * _TILE * ring_row * 2
    return max(ring, (_WARPS + 1) * nq * 8 * (padded_dim(d) + 2) * 4)


def chunk_geometry(b: int, n_head: int, h_kv: int, s_len: int, d: int,
                   sms: int, int8: bool = False) -> ChunkGeometry:
    """The tensor-core kernel's launch geometry (K5's bf16 entry, K1's bf16
    and int8 entries), a pure function of the shapes and the card's SM
    count: as many query heads a block as share a kv head (at most 4, and
    nq * padded head_dim <= 256 to bound registers), then the fewest
    splits (at most 8, each over >= 128 cache rows) that give every SM a
    block. Each split more costs a merge: on the H100 at GPT-L (256
    blocks) one split ran fastest (`PERF.md`)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    rep = n_head // h_kv
    nq = next(n for n in (4, 2, 1)
              if rep % n == 0 and n * padded_dim(d) <= 256)
    blocks = b * (n_head // nq)
    nsplit = max(1, min(_MAX_SPLIT, -(-sms // blocks), -(-s_len // 128)))
    return ChunkGeometry(nq, nsplit, _smem_bytes(d, nq, int8))


def chunk_split_rows(pos: int, pad: int, c: int, s_len: int,
                     nsplit: int) -> List[Tuple[int, int]]:
    """The rows [lo, hi) each split of the bf16 kernel reads (the kernel's
    split_rows): [pad, min(pos + C, S)) in equal pieces of a multiple of 16
    rows; a piece with hi <= lo reads nothing."""
    end = min(pos + c, s_len)
    total = max(0, end - pad)
    per = (-(-total // nsplit) + 15) // 16 * 16
    return [(pad + j * per, min(end, pad + (j + 1) * per))
            for j in range(nsplit)]


@functools.lru_cache(maxsize=None)
def launch_geometry(b: int, n_head: int, h_kv: int, s_len: int, d: int,
                    index: int, int8: bool = False) -> ChunkGeometry:
    """The geometry per call shape and device, computed once."""
    return chunk_geometry(b, n_head, h_kv, s_len, d, _build.sm_count(index),
                          int8)


def chunk_decode_attention(q: torch.Tensor, kv_new: torch.Tensor,
                           kv_cache: torch.Tensor, pos: Pos, n_head: int,
                           prefix_pad: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Attention of C new tokens per batch row over its cache; returns out
    [B, C, F] in q's dtype and UPDATES THE CACHE IN PLACE.

    q:          [B, C, F] post-RoPE queries for positions pos .. pos + C - 1
    kv_new:     [B, C, 2 * F_kv] the chunk's k | v rows (post-RoPE k)
    kv_cache:   [B, S, 2 * F_kv] bf16 / f32, rows pos .. pos + C - 1
                written in place
    pos:        int, or int32 [B] chunk start positions
    n_head:     query heads; query head h reads kv head h // (H / H_kv)
    prefix_pad: optional int32 [B]: positions < prefix_pad[b] are masked

    On CUDA tensors this runs `csrc/chunk_attention.cu` (counted in
    `chunk_decode_attention.launches`, one per call): with q and the cache
    in bf16 one launch on the tensor cores, the insert folded in; other
    dtypes an insert launch, then the CUDA-core kernel. It raises on what
    the kernels do not take. On CPU tensors it runs
    `chunk_decode_attention_ref`.
    """
    b, c, f, d, f_kv, s_len = _check(q, kv_new, kv_cache, pos, n_head)
    if not q.is_cuda:
        return chunk_decode_attention_ref(q, kv_new, kv_cache, pos, n_head,
                                          prefix_pad)
    if q.dtype not in _DTYPE_NAMES or kv_cache.dtype not in _DTYPE_NAMES:
        raise TypeError(f"unsupported dtypes q {q.dtype}, "
                        f"cache {kv_cache.dtype}")
    if d not in HEAD_DIMS or not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"head_dim {d} must be one of {HEAD_DIMS} and the "
                         f"chunk {c} in [1, {MAX_CHUNK}]")
    if not (kv_cache.is_cuda and kv_cache.device == q.device
            and kv_cache.is_contiguous()):
        raise ValueError("the cache must be contiguous, on q's device")
    dev = q.device
    q = q.contiguous()
    kv_new = kv_new.to(q.dtype).contiguous()
    pos_t = batch_positions(pos, b, dev)
    pad_t = None if prefix_pad is None else batch_positions(prefix_pad, b,
                                                            dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), kv_new.data_ptr(), kv_cache.data_ptr(),
            pos_t.data_ptr(), None if pad_t is None else pad_t.data_ptr(),
            out.data_ptr())
    name = f"chunk_attention_{_DTYPE_NAMES[q.dtype]}_" \
           f"{_DTYPE_NAMES[kv_cache.dtype]}"
    if name == "chunk_attention_bf16_bf16":
        geo = launch_geometry(b, n_head, f_kv // d, s_len, d,
                              dev.index or 0)
        fn = _build.c_function(name, 6, 8, 1)
        err = fn(*ptrs, b, c, s_len, n_head, f_kv // d, d, geo.nq,
                 geo.nsplit, d ** -0.5, stream)
    else:
        fn = _build.c_function(name, 6, 6, 1)
        err = fn(*ptrs, b, c, s_len, n_head, f_kv // d, d, d ** -0.5, stream)
    _build.check(err, name)
    chunk_decode_attention.launches += 1
    return out


chunk_decode_attention.launches = 0
