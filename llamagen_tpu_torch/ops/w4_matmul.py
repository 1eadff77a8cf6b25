"""W4A16 weights: nibble-packed int4 matrices with per-channel or group
scales, and the W4A16 matmul.

PyTorch counterpart of `llamagen_tpu/ops/w4_matmul.py`. `w4_matmul`
launches the hand-written CUDA kernel `csrc/w4_matmul.cu` on CUDA tensors
and computes `w4_matmul_ref`, its plain version, on CPU tensors. The
dequantised matrix never exists in device memory.

Layout (built by `pack_w4`, the JAX package's, so its output and GPTQ
levels packed by `pack_w4_levels` load unchanged):
  - K-half nibble packing: weight row i < K/2 lives in the LOW nibble of
    packed row i, row i + K/2 in the HIGH nibble (two's-complement int4);
  - pre-blocked weights `[NB, K/2, BN]` int8 (BN = the widest multiple of
    128 that divides N and is <= 640), column n in block n // BN;
  - scales `[NB, 1, BN]` f32 (per channel) or `[NB, 2 * NSEG, BN]` f32
    (grouped): group g of half h covers weight rows
    h * K/2 + [g * group_size, (g + 1) * group_size), the last group of a
    half ragged when group_size does not divide K/2.

The product rounds x to bf16 first (the TPU kernel feeds its MXU bf16),
sums in f32, applies each group's scale to the f32 partial sum of that
group (per channel: to the whole sum), and returns x's dtype. The TPU
module's layer-stacked `[L, ...]` form and its block-geometry knobs exist
for Mosaic's DMA and are not ported: each `Linear` holds its own layer.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from llamagen_tpu_torch.ops import _build

SEG_ROWS = 128  # default group size (rows of one half per scale)
BN_TARGET = 640  # widest column block pack_w4 picks
_CHUNK = 64      # packed rows per round of csrc/w4_matmul.cu (kChunk)
_MAX_SPLIT = 256  # packed rows one block of the kernel stages (kMaxSplit)


def _pick_bn(n: int) -> int:
    """Largest multiple of 128 that divides N and is <= BN_TARGET."""
    best = 0
    for k in range(1, n // 128 + 1):
        if n % (128 * k) == 0 and 128 * k <= BN_TARGET:
            best = 128 * k
    if best == 0:
        raise ValueError(f"N={n} has no 128-multiple divisor <= {BN_TARGET}")
    return best


def _segments(k2: int, seg_rows: int = SEG_ROWS) -> List[Tuple[int, int]]:
    """(start, rows) of the seg_rows-row segments of one packed half, plus
    a ragged tail."""
    segs = [(i * seg_rows, seg_rows) for i in range(k2 // seg_rows)]
    if k2 % seg_rows:
        segs.append((k2 - k2 % seg_rows, k2 % seg_rows))
    return segs


def _infer_seg_rows(k2: int, nseg: int) -> int:
    """The group size from the scales' 2 * NSEG axis. Group sizes that give
    the same segmentation (a tiny K/2: one ragged segment) are the same
    layout; any other ambiguity raises."""
    cands = [s for s in (64, 128, 256, 512) if len(_segments(k2, s)) == nseg]
    if len({tuple(_segments(k2, s)) for s in cands}) != 1:
        raise ValueError(f"no unique group size for K/2={k2}, NSEG={nseg}: "
                         f"{cands}")
    return cands[0]


def _pack_blocks(q: torch.Tensor, k2: int, nb: int, bn: int) -> torch.Tensor:
    """Integer levels [K, N] in [-8, 7] -> nibble-packed [NB, K/2, BN]."""
    q8 = q.to(torch.int8)
    packed = (q8[:k2] & 0x0F) | (q8[k2:] << 4)          # [K/2, N]
    return packed.reshape(k2, nb, bn).permute(1, 0, 2).contiguous()


def _block_scales(sc: torch.Tensor, nb: int, bn: int) -> torch.Tensor:
    """Row-layout scales [R, N] -> pre-blocked [NB, R, BN] f32."""
    r = sc.shape[0]
    return sc.float().reshape(r, nb, bn).permute(1, 0, 2).contiguous()


def _rtn(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric round-to-nearest int4 over axis 0: scale = max|w| / 7 +
    1e-12, round half to even, clip to [-8, 7]. Bit for bit the JAX
    `pack_w4`: both divisions divide by tensors (PyTorch's CUDA division by
    a Python scalar multiplies by the reciprocal)."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = amax / torch.full_like(amax, 7.0) + 1e-12
    return torch.clamp(torch.round(w / scale), -8, 7), scale


def pack_w4(w: torch.Tensor, *, per_channel: bool = False,
            group_size: int = SEG_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (blocks [NB, K/2, BN] int8, scales f32): per channel
    `[NB, 1, BN]`, or grouped `[NB, 2 * NSEG, BN]` (module docstring)."""
    if w.dim() != 2 or w.shape[0] % 2:
        raise ValueError(f"pack_w4 takes [K, N] with even K, not "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    k2 = k // 2
    bn = _pick_bn(n)
    nb = n // bn
    w32 = w.float()
    if per_channel:
        q, sc = _rtn(w32)
    else:
        parts, sparts = [], []
        for half in range(2):
            for r0, rl in _segments(k2, group_size):
                lq, ls = _rtn(w32[half * k2 + r0:half * k2 + r0 + rl])
                parts.append(lq)
                sparts.append(ls)
        q, sc = torch.cat(parts), torch.cat(sparts)        # sc [2 * NSEG, N]
    return _pack_blocks(q, k2, nb, bn), _block_scales(sc, nb, bn)


def pack_w4_levels(q: torch.Tensor, scales_rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Externally chosen levels (GPTQ) -> the kernel layout. q: [K, N]
    integers in [-8, 7]; scales_rows: [1, N] (per channel) or [2 * NSEG, N]
    in the half-major group order."""
    k, n = q.shape
    if k % 2:
        raise ValueError(f"K={k} must be even")
    bn = _pick_bn(n)
    return (_pack_blocks(q, k // 2, n // bn, bn),
            _block_scales(scales_rows, n // bn, bn))


def _levels(blocks: torch.Tensor) -> torch.Tensor:
    """[NB, K/2, BN] packed -> [NB, K, BN] f32 int4 levels (low nibbles,
    then high nibbles, each sign-extended)."""
    p = blocks.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # arithmetic: the int8 byte's sign is the high nibble's
    return torch.cat([lo, hi], dim=1).float()


def _seg_rows_of(k2: int, scales: torch.Tensor) -> Optional[int]:
    """None for per-channel scales, else the group size."""
    r = scales.shape[-2]
    return None if r == 1 else _infer_seg_rows(k2, r // 2)


def w4_dequant(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The kernel layout -> the dequantised [K, N] f32 matrix (the rank-3
    fallback of `matmul_any` and the tests)."""
    nb, k2, bn = blocks.shape
    lv = _levels(blocks)                                  # [NB, K, BN]
    seg = _seg_rows_of(k2, scales)
    if seg is None:
        w = lv * scales
    else:
        segs = _segments(k2, seg)
        reps = torch.cat([torch.full((rl,), h * len(segs) + g)
                          for h in range(2)
                          for g, (_, rl) in enumerate(segs)]).to(
                              scales.device)
        w = lv * scales[:, reps, :]
    return w.permute(1, 0, 2).reshape(2 * k2, nb * bn)


def _check(x, blocks, scales) -> Tuple[int, int, int, Optional[int]]:
    if x.dim() != 2 or blocks.dim() != 3 or scales.dim() != 3:
        raise ValueError(f"w4_matmul takes x [B, K], blocks [NB, K/2, BN], "
                         f"scales [NB, R, BN]; got {tuple(x.shape)}, "
                         f"{tuple(blocks.shape)}, {tuple(scales.shape)}")
    nb, k2, bn = blocks.shape
    if x.shape[1] != 2 * k2 or blocks.dtype != torch.int8:
        raise ValueError(f"x {tuple(x.shape)} against int8 blocks "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if scales.shape[0] != nb or scales.shape[2] != bn \
            or scales.dtype != torch.float32:
        raise ValueError(f"scales {tuple(scales.shape)} {scales.dtype} for "
                         f"blocks {tuple(blocks.shape)}")
    seg = _seg_rows_of(k2, scales)
    if seg is not None and scales.shape[1] != 2 * len(_segments(k2, seg)):
        raise ValueError(f"{scales.shape[1]} scale rows for K/2={k2}")
    return nb, k2, bn, seg


def w4_matmul_ref(x: torch.Tensor, blocks: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """Plain version of `w4_matmul`: x rounded to bf16, one f32 partial sum
    per group segment (per channel: one sum), times the f32 scale, one
    rounding to x's dtype."""
    nb, k2, bn, seg = _check(x, blocks, scales)
    xb = x.to(torch.bfloat16).float()
    lv = _levels(blocks).permute(1, 0, 2).reshape(2 * k2, nb * bn)
    sc = scales.permute(1, 0, 2).reshape(scales.shape[1], nb * bn)
    if seg is None:
        return ((xb @ lv) * sc[0]).to(x.dtype)
    segs = _segments(k2, seg)
    out = torch.zeros(x.shape[0], nb * bn, device=x.device)
    for h in range(2):
        for g, (r0, rl) in enumerate(segs):
            rows = slice(h * k2 + r0, h * k2 + r0 + rl)
            out += (xb[:, rows] @ lv[rows]) * sc[h * len(segs) + g]
    return out.to(x.dtype)


def _k_per_split(b: int, k2: int, n: int, device: torch.device) -> int:
    """Packed rows per block: a multiple of the kernel's 64-row chunk, at
    most 256 (its x stage), split until the grid has about two blocks per
    SM."""
    chunks = -(-k2 // _CHUNK)
    tiles = -(-n // 64) * -(-b // 16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(-(-chunks * _CHUNK // _MAX_SPLIT),
                 min(chunks, -(-2 * sms // tiles)))
    return -(-chunks // splits) * _CHUNK


def w4_matmul(x: torch.Tensor, blocks: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """x [B, K] (bf16/f32) @ dequant(blocks [NB, K/2, BN], scales) -> [B, N]
    in x's dtype.

    On a CUDA tensor this launches `csrc/w4_matmul.cu` (counted in
    `w4_matmul.launches`) and raises on what the kernel does not take; on
    a CPU tensor it computes `w4_matmul_ref`.
    """
    nb, k2, bn, seg = _check(x, blocks, scales)
    if not x.is_cuda:
        return w4_matmul_ref(x, blocks, scales)
    name = {torch.bfloat16: "w4_matmul_bf16",
            torch.float32: "w4_matmul_f32"}.get(x.dtype)
    if name is None:
        raise TypeError(f"w4_matmul takes bf16 or f32 activations, "
                        f"not {x.dtype}")
    if bn % 64:
        raise ValueError(f"block width {bn} must be a multiple of 64")
    if not (blocks.is_cuda and scales.is_cuda
            and x.device == blocks.device == scales.device):
        raise ValueError("x, blocks and scales must be on one CUDA device")
    b, n = x.shape[0], nb * bn
    x = x.contiguous()
    blocks = blocks.contiguous()
    scales = scales.contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    k_per_split = _k_per_split(b, k2, n, x.device)
    splits = -(-k2 // k_per_split)
    partial = (torch.empty((splits, b, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _build.c_function(name, 5, 7)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), blocks.data_ptr(), scales.data_ptr(),
                    out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    b, k2, n, bn, scales.shape[1], seg or 0, k_per_split,
                    stream), name)
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0


def quantize_gpt_params_w4k(model: nn.Module, per_channel: bool = False,
                            int8_head: bool = False,
                            group_size: int = SEG_ROWS) -> nn.Module:
    """Quantise a `models.gpt.Transformer`'s layer matmuls to W4A16 in place
    (the JAX `quantize_gpt_params_w4k`).

    wqkv, wo, w1, w2 and w3 of every layer become `pack_w4` blocks and
    scales; norms, embeddings and the conditioning stay. `int8_head`
    makes the output head W8A16 (`quant_matmul.quantize_weight`), else it
    keeps its dtype. Returns the model.
    """
    for layer in model.layers:
        for lin in (layer.attention.wqkv, layer.attention.wo,
                    layer.feed_forward.w1, layer.feed_forward.w2,
                    layer.feed_forward.w3):
            lin.quantize_w4_(per_channel=per_channel, group_size=group_size)
    if int8_head:
        model.output.quantize_()
    return model
