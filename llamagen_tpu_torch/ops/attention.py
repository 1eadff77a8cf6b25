"""Single-token decode attention with an in-place KV cache.

PyTorch counterpart of `llamagen_tpu/ops/attention.py::decode_attention`.
`decode_attention` launches a hand-written CUDA kernel on CUDA tensors, one
launch per call (bf16 q with a bf16 cache: the tensor-core kernel of
`csrc/chunk_attention.cu` at one query; bf16 q with an int8 cache: the
tensor-core kernel of `csrc/decode_attention.cu`; the f32 and mixed
entries: its CUDA-core kernel), and computes `decode_attention_ref`, the
plain version with the same signature, on CPU tensors. head_dim 64, 100
or 128 on the card.

Cache layout (as in JAX, `gpt.py:103-112`): one `[B, S, 2 * F_kv]` buffer
per layer, k in lanes `[0, F_kv)` and v in `[F_kv, 2 * F_kv)`,
F_kv = kv_heads * head_dim.

- bf16 / f32 caches: this step's row is written into the cache at `pos`.
  JAX keeps the newest rows in a recent window, but for these dtypes the
  window holds exact copies of cache rows, so the results are the same.
- int8 caches keep the JAX semantics exactly: rows below
  `bnd = 32 * (pos // 32)` are int8 with per-row k and v scales
  (`kv_scale [B, S, 2]` bf16, where JAX broadcasts them over 128 lanes);
  rows `[bnd, pos]` are read exact from `tail [B, 32, 2 * F_kv]` (the JAX
  recent window, compute dtype); at `pos % 32 == 31` the 32 tail rows are
  quantised into cache rows `[bnd, bnd + 32)`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from llamagen_tpu_torch.ops import _build

TAIL = 32  # exact int8 tail rows (JAX RECENT_INT8, attention.py:48)
HEAD_DIMS = (64, 100, 128)  # the zoo's head_dims: what the kernels take

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.int8: "int8"}

Pos = Union[int, torch.Tensor]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x [..., F] -> (int8 [..., F], f32 scale [...]).

    scale = max|row| / 127 + 1e-8 in f32, round half to even, clip +-127
    (`gpt.quantize_cache` and the kernel flush in JAX). The divisions are by
    tensors: PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which can differ in the last bit.
    """
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + 1e-8
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def batch_positions(pos: Pos, batch: int,
                    device: torch.device) -> torch.Tensor:
    """A scalar or [B] position -> contiguous int32 [B] on `device`."""
    if isinstance(pos, int):
        return torch.full((batch,), pos, dtype=torch.int32, device=device)
    return torch.as_tensor(pos, device=device).to(torch.int32) \
        .reshape(-1).expand(batch).contiguous()


def _check(q, kv_new, kv_cache, pos, n_head, kv_scale, tail):
    b, f = q.shape
    if f % n_head:
        raise ValueError(f"F={f} is not a multiple of n_head={n_head}")
    d = f // n_head
    if kv_cache.dim() != 3 or kv_cache.shape[0] != b \
            or kv_cache.shape[2] % (2 * d):
        raise ValueError(f"kv_cache {tuple(kv_cache.shape)} for q "
                         f"{tuple(q.shape)}")
    f_kv = kv_cache.shape[2] // 2
    if n_head % (f_kv // d):
        raise ValueError("n_head must be a multiple of the kv heads")
    if kv_new.shape != (b, 2 * f_kv):
        raise ValueError(f"kv_new {tuple(kv_new.shape)}, "
                         f"expected {(b, 2 * f_kv)}")
    s_len = kv_cache.shape[1]
    if isinstance(pos, int) and not 0 <= pos < s_len:
        raise ValueError(f"pos {pos} outside the cache of {s_len} rows")
    if kv_cache.dtype == torch.int8:
        if kv_scale is None or tail is None:
            raise ValueError("an int8 cache needs kv_scale and tail")
        if s_len % TAIL:  # a flush writes 32 whole rows
            raise ValueError(f"an int8 cache needs a multiple of {TAIL} "
                             f"rows, not {s_len}")
        if kv_scale.shape != (b, s_len, 2) or kv_scale.dtype != torch.bfloat16:
            raise ValueError("kv_scale must be bf16 [B, S, 2]")
        if tail.shape != (b, TAIL, 2 * f_kv) or tail.dtype != q.dtype:
            raise ValueError(f"tail must be [B, {TAIL}, 2F_kv] in q's dtype")
    return b, f, d, f_kv, s_len


def decode_attention_ref(q: torch.Tensor, kv_new: torch.Tensor,
                         kv_cache: torch.Tensor, pos: Pos, n_head: int,
                         prefix_pad: Optional[torch.Tensor] = None,
                         kv_scale: Optional[torch.Tensor] = None,
                         tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `decode_attention` (same signature and in-place
    updates), written with dense einsums over the whole cache."""
    b, f, d, f_kv, s_len = _check(q, kv_new, kv_cache, pos, n_head,
                                  kv_scale, tail)
    h_kv = f_kv // d
    rep = n_head // h_kv
    dev = q.device
    rows = torch.arange(b, device=dev)
    pos = batch_positions(pos, b, dev).long()
    pad = (torch.zeros(b, dtype=torch.long, device=dev) if prefix_pad is None
           else batch_positions(prefix_pad, b, dev).long())
    qf = q.float().view(b, n_head, d) * d ** -0.5

    def heads(x):  # [B, R, F_kv] -> [B, R, H, D] f32; head h reads h // rep
        return x.float().view(b, x.shape[1], h_kv, d) \
            .repeat_interleave(rep, dim=2)

    def scores(keys):  # [B, R, F_kv] -> [B, H, R]
        return torch.einsum("bhd,bshd->bhs", qf, heads(keys))

    def masked(s, valid):
        return s.masked_fill(~valid[:, None, :], float("-inf"))

    s_idx = torch.arange(s_len, device=dev)[None, :]
    if kv_cache.dtype != torch.int8:
        kv_cache[rows, pos] = kv_new.to(kv_cache.dtype)
        valid = (s_idx <= pos[:, None]) & (s_idx >= pad[:, None])
        probs = torch.softmax(masked(scores(kv_cache[..., :f_kv]), valid),
                              dim=-1)
        out = torch.einsum("bhs,bshd->bhd", probs,
                           heads(kv_cache[..., f_kv:]))
        return out.reshape(b, f).to(q.dtype)

    j = pos % TAIL
    bnd = pos - j
    tail[rows, j] = kv_new.to(tail.dtype)
    sc = kv_scale.float()
    t_idx = torch.arange(TAIL, device=dev)[None, :]
    valid_c = (s_idx < bnd[:, None]) & (s_idx >= pad[:, None])
    valid_t = (t_idx <= j[:, None]) & (bnd[:, None] + t_idx >= pad[:, None])
    s_c = masked(scores(kv_cache[..., :f_kv]) * sc[:, None, :, 0], valid_c)
    s_t = masked(scores(tail[..., :f_kv]), valid_t)
    probs = torch.softmax(torch.cat([s_c, s_t], dim=-1), dim=-1)
    p_c, p_t = probs.split([s_len, TAIL], dim=-1)
    out = (torch.einsum("bhs,bshd->bhd", p_c * sc[:, None, :, 1],
                        heads(kv_cache[..., f_kv:]))
           + torch.einsum("bhs,bshd->bhd", p_t, heads(tail[..., f_kv:])))
    # flush rows with pos % 32 == 31 into cache rows [bnd, bnd + 32); the
    # others rewrite what they hold (no host sync: the plain version stays
    # capturable in a CUDA graph)
    flush = (j == TAIL - 1)[:, None]
    idx = bnd[:, None] + t_idx
    kq, ks = quantize_rows(tail[..., :f_kv])
    vq, vs = quantize_rows(tail[..., f_kv:])
    at = (rows[:, None], idx)
    kv_cache[at] = torch.where(flush[..., None], torch.cat([kq, vq], dim=-1),
                               kv_cache[at])
    kv_scale[at] = torch.where(
        flush[..., None], torch.stack([ks, vs], dim=-1).to(kv_scale.dtype),
        kv_scale[at])
    return out.reshape(b, f).to(q.dtype)


def decode_attention(q: torch.Tensor, kv_new: torch.Tensor,
                     kv_cache: torch.Tensor, pos: Pos, n_head: int,
                     prefix_pad: Optional[torch.Tensor] = None,
                     kv_scale: Optional[torch.Tensor] = None,
                     tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of one new token per batch row over its cache; returns
    out [B, F] in q's dtype and UPDATES THE CACHE IN PLACE.

    q:          [B, F] post-RoPE queries, heads flattened (F = H * head_dim)
    kv_new:     [B, 2 * F_kv] this step's k | v row
    kv_cache:   [B, S, 2 * F_kv] bf16 / f32 / int8, updated in place: the
                new row is written at pos (bf16/f32), or the int8 tail is
                flushed into rows [bnd, bnd + 32) when pos % 32 == 31
    pos:        int, or int32 [B] per-row positions (must lie in [0, S);
                an int is checked, a tensor is not, since that would read
                the device: its caller keeps it inside, as the serving
                engine does from its host mirror)
    n_head:     query heads; query head h reads kv head h // (H / H_kv)
    prefix_pad: optional int32 [B]: positions < prefix_pad[b] are masked
    kv_scale:   int8 caches: bf16 [B, S, 2] (k, v) row scales, in place
    tail:       int8 caches: [B, 32, 2 * F_kv] exact rows [bnd, pos] in q's
                dtype, in place (the new row lands at pos % 32)

    On CUDA tensors this makes one kernel launch (counted in
    `decode_attention.launches`) and raises on what the kernels do not
    take; on CPU tensors it runs `decode_attention_ref`.
    """
    b, f, d, f_kv, s_len = _check(q, kv_new, kv_cache, pos, n_head,
                                  kv_scale, tail)
    if not q.is_cuda:
        return decode_attention_ref(q, kv_new, kv_cache, pos, n_head,
                                    prefix_pad, kv_scale, tail)
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or kv_cache.dtype not in _DTYPE_NAMES:
        raise TypeError(f"unsupported dtypes q {q.dtype}, "
                        f"cache {kv_cache.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} must be one of {HEAD_DIMS}")
    quantized = kv_cache.dtype == torch.int8
    in_place = [kv_cache] + ([kv_scale, tail] if quantized else [])
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               for t in in_place):
        raise ValueError("cache buffers must be contiguous, on q's device")
    dev = q.device
    q = q.contiguous()
    kv_new = kv_new.to(q.dtype).contiguous()
    pos_t = batch_positions(pos, b, dev)
    pad_t = None if prefix_pad is None else batch_positions(prefix_pad, b,
                                                            dev)
    out = torch.empty_like(q)
    h_kv = f_kv // d
    name = f"decode_attention_{_DTYPE_NAMES[q.dtype]}_" \
           f"{_DTYPE_NAMES[kv_cache.dtype]}"
    pad_p = None if pad_t is None else pad_t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q.dtype == torch.bfloat16 and kv_cache.dtype != torch.float32:
        # the tensor-core kernel (csrc/attention_mma.cuh); a lazy import:
        # chunk_attention imports this module
        from llamagen_tpu_torch.ops.chunk_attention import launch_geometry
        geo = launch_geometry(b, n_head, h_kv, s_len, d, dev.index or 0,
                              quantized)
        if quantized:
            fn = _build.c_function(name, 8, 7, 1)
            err = fn(q.data_ptr(), kv_new.data_ptr(), kv_cache.data_ptr(),
                     kv_scale.data_ptr(), tail.data_ptr(), pos_t.data_ptr(),
                     pad_p, out.data_ptr(), b, s_len, n_head, h_kv, d,
                     geo.nq, geo.nsplit, d ** -0.5, stream)
        else:  # K5's entry at one query a row: the same semantics
            name = "chunk_attention_bf16_bf16"
            fn = _build.c_function(name, 6, 8, 1)
            err = fn(q.data_ptr(), kv_new.data_ptr(), kv_cache.data_ptr(),
                     pos_t.data_ptr(), pad_p, out.data_ptr(), b, 1, s_len,
                     n_head, h_kv, d, geo.nq, geo.nsplit, d ** -0.5, stream)
    else:
        fn = _build.c_function(name, 8, 5, 1)
        err = fn(q.data_ptr(), kv_new.data_ptr(), kv_cache.data_ptr(),
                 kv_scale.data_ptr() if quantized else None,
                 tail.data_ptr() if quantized else None, pos_t.data_ptr(),
                 pad_p, out.data_ptr(), b, s_len, n_head, h_kv, d,
                 d ** -0.5, stream)
    _build.check(err, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
