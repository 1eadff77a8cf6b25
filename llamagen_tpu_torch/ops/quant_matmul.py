"""W8A16 weights: int8 weight matrices with per-output-channel scales.

PyTorch counterpart of `llamagen_tpu/ops/quant_matmul.py`: the bf16, int8,
W4 (`ops/w4_matmul.py`) and int4 storage (`bits=4`) branches of
`matmul_any`. On the TPU, XLA fuses the
int8 -> bf16 convert into the matmul's weight read. PyTorch has no such
fusion, so here every W8A16 product goes through the hand-written CUDA
kernel `csrc/int8_matmul.cu` (`int8_matmul`); the dequantised matrix never
exists in memory.

Layouts follow the JAX package: `quantize_weight` takes `[..., K, N]`
(in, out) and `int8_matmul` takes `w_q [K, N]`. A quantised `Linear` of
`models/gpt.py` keeps `weight_q [K, N]` and `weight_scale [N]` in place of
its `weight [N, K]`, so a quantised state dict carries the `_q` / `_scale`
keys of the JAX parameter tree.

The int4 storage mode (`quantize_gpt_params(..., bits=4)`, JAX's
`quantize_weight_int4` / `unpack_int4` / `int4_matmul`) is plain XLA in
JAX and plain PyTorch here: nibble pairs along N (`weight_q4 [K, N/2]`
int8, the low nibble at the even index) with group scales along K
(`weight_gs [G, N]`), the `_q4` / `_gs` keys of the JAX tree. JAX keeps it
as a storage mode, not a serving path, and so does the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from llamagen_tpu_torch.ops import _build
from llamagen_tpu_torch.ops.w4_matmul import _x_stride, w4_dequant, w4_matmul

# csrc/int8_matmul.cu's constants
_MAX_CLUSTER = 8      # blocks per cluster (kMaxCluster)
_ROWS = 128           # K rows a block takes where the cluster allows
_MAX_PASS = 96        # batch rows per pass (kMaxPass)
_MAX_SMEM = 232448    # shared memory per block, 227 KB (kMaxSmem)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_matmul`: f32 product, scale on the f32 sum,
    one rounding to x's dtype."""
    return ((x.float() @ w_q.float()) * w_scale.float()).to(x.dtype)


class Int8Geometry(NamedTuple):
    """Launch geometry of `csrc/int8_matmul.cu`: `cols` (64 or 128) output
    columns a block; a cluster of `ks` blocks splits the K rows of each
    column tile, `kb` rows a block (a multiple of 16); batch rows go in
    passes of `bc` (a multiple of 8, <= 96); `smem` bytes of shared memory
    a block."""
    cols: int
    ks: int
    kb: int
    bc: int
    smem: int


def _smem_bytes(kb: int, bc: int, planes: int, cols: int) -> int:
    """Shared memory of one block (the kernel's smem_bytes): weight rows,
    scales, x in `planes` bf16 planes (3 for f32 x), the slots of the f32
    partials the block sums."""
    return kb * (cols + 16) + cols * 4 + planes * bc * _x_stride(kb) * 2 \
        + (bc * cols // 4 + _MAX_CLUSTER) * 16


def int8_geometry(b: int, k: int, n: int, sms: int, f32: bool = False,
                  cols: Optional[int] = None) -> Int8Geometry:
    """The kernel's launch geometry, a pure function of the shapes, x's
    dtype and the card's SM count: 128-column tiles where a cluster of 8
    over them still gives every SM a block (whole 128-byte lines, every
    warp busy at 16 batch rows), else 64 (`cols` forces one); then
    `w4_geometry`'s rule: the smallest cluster (at most 8 blocks) that
    gives the grid at least one block per SM and each block at most 128
    K rows, else 8; the batch in as few passes of equal size as 96 rows a
    pass allow, shrunk while a block's shared memory passes 227 KB (f32 x
    stages three bf16 planes)."""
    if b < 1 or k < 1 or n < 2 or n % 2:
        raise ValueError(f"no int8 geometry for B={b}, K={k}, N={n}")
    units = -(-k // 16)
    if cols is None:
        cols = 128 if -(-n // 128) * min(_MAX_CLUSTER, units) >= sms else 64
    tiles = -(-n // cols)
    per = units
    for want in range(1, min(_MAX_CLUSTER, units) + 1):
        per = -(-units // want)
        if -(-units // per) * tiles >= sms and per * 16 <= _ROWS:
            break
    kb = per * 16
    ks = -(-k // kb)
    planes = 3 if f32 else 1
    passes = -(-b // _MAX_PASS)
    bc = -(-(-(-b // passes)) // 8) * 8
    while _smem_bytes(kb, bc, planes, cols) > _MAX_SMEM and bc > 8:
        bc -= 8
    if _smem_bytes(kb, bc, planes, cols) > _MAX_SMEM:
        raise ValueError(f"K={k} needs {kb} rows a block: more shared "
                         f"memory than a block has")
    return Int8Geometry(cols, ks, kb, bc, _smem_bytes(kb, bc, planes, cols))


@functools.lru_cache(maxsize=None)
def _launch_geometry(b: int, k: int, n: int, f32: bool,
                     index: int) -> Int8Geometry:
    """The geometry per call shape and device, computed once."""
    return int8_geometry(b, k, n, _build.sm_count(index), f32)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x [B, K] (bf16/f32) @ dequant(w_q [K, N] int8, w_scale [N] f32)
    -> [B, N] in x's dtype.

    On a CUDA tensor this launches `csrc/int8_matmul.cu` once (counted in
    `int8_matmul.launches`) and raises on what the kernel does not take; on
    a CPU tensor it computes `int8_matmul_ref`.
    """
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    b, k = x.shape
    n = w_q.shape[1]
    if w_q.dtype != torch.int8 or w_scale.shape != (n,):
        raise ValueError("w_q must be int8 [K, N] with w_scale [N]")
    if not x.is_cuda:
        return int8_matmul_ref(x, w_q, w_scale)
    name = {torch.bfloat16: "int8_matmul_bf16",
            torch.float32: "int8_matmul_f32"}.get(x.dtype)
    if name is None:
        raise TypeError(f"int8_matmul takes bf16 or f32 activations, "
                        f"not {x.dtype}")
    if n % 2:
        raise ValueError(f"N={n} must be even")
    if not (w_q.is_cuda and w_scale.is_cuda
            and x.device == w_q.device == w_scale.device):
        raise ValueError("x, w_q and w_scale must be on one CUDA device")
    geo = _launch_geometry(b, k, n, x.dtype == torch.float32,
                           x.device.index or 0)
    x = x.contiguous()
    w_q = w_q.contiguous()
    w_scale = w_scale.float().contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    fn = _build.c_function(name, 4, 7)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr(), b, k, n, geo.cols, geo.ks, geo.kb,
                    geo.bc, stream), name)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (int8 [..., K, N], per-channel f32 scales [..., N]).

    Bit for bit the JAX `quantize_weight`: scale = max|w| / 127 + 1e-12,
    round half to even, clip to +-127. Both divisions divide by a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which would differ in the last bit.
    """
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127, 127)
    return q.to(torch.int8), scale


def _pick_group(k: int, requested: int) -> int:
    """The largest divisor of K that is at most the requested group size
    (JAX `_pick_group`)."""
    g = min(requested, k)
    while k % g:
        g -= 1
    return g


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (packed int8 [..., K, N/2], group scales f32
    [..., G, N]), G = K / `_pick_group(K, group_size)`.

    Bit for bit the JAX `quantize_weight_int4`: scale = max|w| / 7 + 1e-12
    over each group of K rows, round half to even, clip to [-8, 7]; two
    levels a byte along N, the even index in the low nibble. Both
    divisions divide by tensors (PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal), so the card's levels are the
    CPU's."""
    *lead, k, n = w.shape
    if n % 2:
        raise ValueError(f"N={n} must be even for int4 packing")
    g = _pick_group(k, group_size)
    w32 = w.float().reshape(*lead, k // g, g, n)
    amax = w32.abs().amax(dim=-2)
    scale = amax / torch.full_like(amax, 7.0) + 1e-12       # [..., G, N]
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -8, 7)
    q = q.to(torch.int8).reshape(*lead, k, n // 2, 2)
    return (q[..., 0] & 0x0F) | (q[..., 1] << 4), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K, N/2] int8 nibble pairs -> [..., K, N] int8 levels in
    [-8, 7] (JAX `unpack_int4`'s int4 values; PyTorch has no int4 type)."""
    low = ((packed & 0x0F) ^ 8) - 8      # sign-extend the low nibble
    high = packed >> 4                   # arithmetic shift: the high one
    return torch.stack([low, high], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                gscale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant-int4(packed [K, N/2], gscale [G, N]) ->
    [..., N] in x's dtype, as JAX computes it: one group, the product in
    x's dtype with the scale after; G groups, f32 partial products over
    each group's K rows, the group scales on the [..., G, N] partials,
    their sum, one cast (the dequantised matrix is never formed)."""
    k = x.shape[-1]
    n = packed.shape[-1] * 2
    groups = gscale.shape[-2]
    if groups == 1:
        out = x @ unpack_int4(packed).to(x.dtype)
        return out * gscale[0].to(out.dtype)
    wq = unpack_int4(packed).float().reshape(groups, k // groups, n)
    xg = x.float().reshape(*x.shape[:-1], groups, k // groups)
    part = torch.einsum("...gk,gkn->...gn", xg, wq)
    return torch.einsum("...gn,gn->...n", part,
                        gscale.float()).to(x.dtype)


def matmul_any(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               weight_q: Optional[torch.Tensor] = None,
               weight_scale: Optional[torch.Tensor] = None,
               w4_blocks: Optional[torch.Tensor] = None,
               w4_scales: Optional[torch.Tensor] = None,
               weight_q4: Optional[torch.Tensor] = None,
               weight_gs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ W -> [..., N] for a bf16/f32 `weight [N, K]` (nn.Linear
    layout), a W8A16 `weight_q [K, N]` + `weight_scale [N]`, W4
    `w4_blocks` + `w4_scales` (`ops/w4_matmul.py` layout), or int4
    storage `weight_q4 [K, N/2]` + `weight_gs [G, N]` (`int4_matmul`).

    The W8A16 branch flattens x to rank 2 and runs `int8_matmul`. The W4
    branch runs `w4_matmul` on rank-2 x only (every decode-stack matmul);
    rank >= 3 x (prefill, training) takes the plain dequantised product, as
    JAX's `matmul_any` does (quant_matmul.py:224-234). The plain branch is an
    ordinary matrix product (left to XLA in JAX).
    """
    if w4_blocks is not None:
        if x.dim() == 2:
            return w4_matmul(x, w4_blocks, w4_scales)
        return x @ w4_dequant(w4_blocks, w4_scales).to(x.dtype)
    if weight_q4 is not None:
        return int4_matmul(x, weight_q4, weight_gs)
    if weight_q is None:
        return x @ weight.to(x.dtype).t()
    out = int8_matmul(x.reshape(-1, x.shape[-1]), weight_q, weight_scale)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def quantize_gpt_params(model: nn.Module, quantize_head: bool = False,
                        bits: int = 8, group_size: int = 128) -> nn.Module:
    """Quantise a `models.gpt.Transformer`'s layer matmuls in place (JAX
    `quantize_gpt_params`): bits 8, W8A16 (int8 + per-channel scales, the
    int8 kernel); bits 4, int4 storage (`quantize_weight_int4` with groups
    of `group_size` K rows, `int4_matmul`).

    wqkv, wo, w1, w2 and w3 of every layer are quantised; norms,
    embeddings and the conditioning stay as they are. The output head
    stays in its dtype unless `quantize_head` (as in JAX,
    quant_matmul.py:180-209). Returns the model.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits {bits}: 8 (W8A16) or 4 (int4 storage)")

    def quantize(lin):
        if bits == 4:
            lin.quantize_int4_(group_size)
        else:
            lin.quantize_()

    for layer in model.layers:
        for lin in (layer.attention.wqkv, layer.attention.wo,
                    layer.feed_forward.w1, layer.feed_forward.w2,
                    layer.feed_forward.w3):
            quantize(lin)
    if quantize_head:
        quantize(model.output)
    return model
