"""A routed expert layer (DeepSeek-V2's MoE) at W8A16: the router, the
dispatch of (row, expert) pairs, the grouped int8 product (K7) and the
weighted combine.

Every step has fixed shapes and reads nothing back to the host, so that
the serving engine can capture it in a CUDA graph: the router's scores are
a softmax in f32 over the experts (DeepSeek-V2 computes its gate in f32)
and its choice `torch.topk` (greedy, the weights not renormalised); the
T * k pairs are sorted by expert (`torch.argsort`, stable) and the
experts' row counts made by `scatter_add_` into [E] (no `bincount`, whose
size depends on the data), their prefix sums the offsets [E + 1]; K7
multiplies each expert's rows by its own matrices, reading the offsets on
the device; the combine puts the pairs back in row order (`index_copy_`:
every index once, so no atomics and the same sum every time) and sums each
row's k outputs times their weights in f32.

`moe_int8_matmul` launches `csrc/int8_matmul.cu`'s `moe_int8_kernel` on
CUDA tensors (counted in `moe_int8_matmul.launches`) and computes
`moe_int8_matmul_ref`, a loop over the experts, on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from llamagen_tpu_torch.ops import _build
from llamagen_tpu_torch.ops.quant_matmul import (_MAX_PASS, Int8Geometry,
                                                 int8_geometry,
                                                 int8_matmul_ref,
                                                 quantize_weight)


class Experts(NamedTuple):
    """A layer's routed experts at W8A16: gate and up side by side
    (`w13_q [E, D, 2F]`, gate in columns [0, F)), down `w2_q [E, F, D]`,
    with per-output-channel f32 scales."""
    w13_q: torch.Tensor
    w13_scale: torch.Tensor  # [E, 2F]
    w2_q: torch.Tensor
    w2_scale: torch.Tensor   # [E, D]


def quantize_experts(gate: torch.Tensor, up: torch.Tensor,
                     down: torch.Tensor) -> Experts:
    """Stacked expert weights in `nn.Linear`'s layout (gate, up [E, F, D],
    down [E, D, F]) -> `Experts`, each output channel quantised as
    `quantize_weight` does."""
    w13_q, w13_scale = quantize_weight(
        torch.cat([gate, up], dim=1).transpose(1, 2))
    w2_q, w2_scale = quantize_weight(down.transpose(1, 2))
    return Experts(w13_q.contiguous(), w13_scale, w2_q.contiguous(),
                   w2_scale)


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D], gate_weight [E, D] -> (f32 weights [T, k], expert ids
    [T, k] int64): softmax over the experts of x @ gate_weightᵀ in f32,
    then the top k."""
    scores = torch.softmax(x.float() @ gate_weight.float().t(), dim=-1)
    return torch.topk(scores, top_k, dim=-1)


class Dispatch(NamedTuple):
    order: torch.Tensor    # [T k] pair indices (t * k + j) sorted by expert
    offsets: torch.Tensor  # [E + 1] int32: expert e's sorted pairs
    counts: torch.Tensor   # [E] int32 rows routed to each expert


def dispatch(ids: torch.Tensor, n_experts: int) -> Dispatch:
    """The pairs of `ids [T, k]` grouped by expert, in fixed-shape
    buffers."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    return Dispatch(order, offsets, counts)


def moe_int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of `moe_int8_matmul`: `int8_matmul_ref` on each
    expert's rows (the offsets read on the host); rows outside every
    expert's range are zero."""
    out = torch.zeros(x.shape[0], w_q.shape[2], dtype=x.dtype,
                      device=x.device)
    bounds = offsets.tolist()
    for e in range(w_q.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = int8_matmul_ref(x[a:b], w_q[e], w_scale[e])
    return out


@functools.lru_cache(maxsize=None)
def moe_geometry(k: int, n: int, f32: bool, index: int) -> Int8Geometry:
    """K2's geometry for a pass of up to 96 rows (an expert's share at
    decode) over 128-column tiles: the experts multiply the blocks, so
    whole 128-byte weight lines come before more blocks."""
    return int8_geometry(_MAX_PASS, k, n, _build.sm_count(index), f32,
                         cols=128)


def moe_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """x [R, K] (bf16/f32, rows grouped by expert) times each group's
    dequant(w_q [E, K, N] int8, w_scale [E, N] f32): rows [offsets[e],
    offsets[e + 1]) take expert e's matrix. Returns [R, N] in x's dtype
    (rows outside every group unset on the card, zero on the CPU).

    On CUDA tensors one launch of K7 (counted in
    `moe_int8_matmul.launches`) whose grid does not depend on the offsets,
    which stay on the device; on CPU tensors `moe_int8_matmul_ref`."""
    if x.dim() != 2 or w_q.dim() != 3 or x.shape[1] != w_q.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    e, k, n = w_q.shape
    if w_q.dtype != torch.int8 or w_scale.shape != (e, n):
        raise ValueError("w_q must be int8 [E, K, N] with w_scale [E, N]")
    if offsets.shape != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be int32 [{e + 1}]")
    if not x.is_cuda:
        return moe_int8_matmul_ref(x, w_q, w_scale, offsets)
    name = {torch.bfloat16: "moe_int8_matmul_bf16",
            torch.float32: "moe_int8_matmul_f32"}.get(x.dtype)
    if name is None:
        raise TypeError(f"moe_int8_matmul takes bf16 or f32 activations, "
                        f"not {x.dtype}")
    if n % 2:
        raise ValueError(f"N={n} must be even")
    if not all(t.is_cuda and t.device == x.device
               for t in (w_q, w_scale, offsets)):
        raise ValueError("x, w_q, w_scale and offsets must be on one CUDA "
                         "device")
    geo = moe_geometry(k, n, x.dtype == torch.float32, x.device.index or 0)
    x = x.contiguous()
    out = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
    fn = _build.c_function(name, 5, 7)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w_q, w_scale = w_q.contiguous(), w_scale.float().contiguous()
    offsets = offsets.contiguous()
    _build.check(fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr(), offsets.data_ptr(), e, k, n, geo.cols,
                    geo.ks, geo.kb, geo.bc, stream), name)
    moe_int8_matmul.launches += 1
    return out


moe_int8_matmul.launches = 0


def moe_forward(x: torch.Tensor, gate_weight: torch.Tensor,
                experts: Experts, top_k: int, scaling: float = 1.0,
                expert_rows: Optional[torch.Tensor] = None,
                route_ids: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
    """The routed part of a MoE layer for x [T, D]: Σ over each row's top
    k experts of weight * down(silu(gate(x)) * up(x)), times `scaling`, in
    x's dtype. `expert_rows` [E] int32, where given, gains the rows routed
    to each expert; `route_ids`, where given, gains the chosen expert ids
    [T, k]."""
    t, d = x.shape
    weights, ids = route(x, gate_weight, top_k)
    if route_ids is not None:
        route_ids.append(ids)
    disp = dispatch(ids, gate_weight.shape[0])
    if expert_rows is not None:
        expert_rows.add_(disp.counts)
    xs = x[disp.order // top_k]
    gu = moe_int8_matmul(xs, experts.w13_q, experts.w13_scale, disp.offsets)
    f = gu.shape[1] // 2
    ys = moe_int8_matmul(F.silu(gu[:, :f]) * gu[:, f:], experts.w2_q,
                         experts.w2_scale, disp.offsets)
    y = torch.empty_like(ys).index_copy_(0, disp.order, ys).view(t, top_k, d)
    return ((y.float() * weights[..., None]).sum(1) * scaling).to(x.dtype)
