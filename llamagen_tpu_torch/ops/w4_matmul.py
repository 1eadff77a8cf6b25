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

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from llamagen_tpu_torch.ops import _build

SEG_ROWS = 128  # default group size (rows of one half per scale)
BN_TARGET = 640  # widest column block pack_w4 picks
# csrc/w4_matmul.cu's constants
_COLS = 64            # output columns per block (kCols)
_MAX_CLUSTER = 8      # blocks per cluster (kMaxCluster)
_ROWS = 128           # packed rows a block takes where the cluster allows
_MAX_PASS = 96        # batch rows per pass (kMaxPass)
_MAX_SMEM = 232448    # shared memory per block, 227 KB (kMaxSmem)


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


@functools.lru_cache(maxsize=None)
def _seg_rows(k2: int, r: int) -> Optional[int]:
    """None for per-channel scales (R == 1), else the group size."""
    return None if r == 1 else _infer_seg_rows(k2, r // 2)


def w4_dequant(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The kernel layout -> the dequantised [K, N] f32 matrix (the rank-3
    fallback of `matmul_any` and the tests)."""
    nb, k2, bn = blocks.shape
    lv = _levels(blocks)                                  # [NB, K, BN]
    seg = _seg_rows(k2, scales.shape[-2])
    if seg is None:
        w = lv * scales
    else:
        # row r's scale row: its half's groups, then its group in the half
        # (the ragged tail is the last); made on the device, so that no
        # host copy synchronises
        r = torch.arange(2 * k2, device=scales.device)
        reps = r // k2 * len(_segments(k2, seg)) + r % k2 // seg
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
    seg = _seg_rows(k2, scales.shape[-2])
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


class W4Geometry(NamedTuple):
    """Launch geometry of `csrc/w4_matmul.cu`: a cluster of `ks` blocks
    splits the packed rows of each 64-column tile, `kb` rows a block (a
    multiple of 16 and of the group size); batch rows go in passes of `bc`
    (a multiple of 8, <= 96); `smem` bytes of shared memory a block."""
    ks: int
    kb: int
    bc: int
    smem: int


def _x_stride(kb: int) -> int:
    """bf16 elements per staged x row (kernel's x_stride)."""
    w = kb // 2
    return 2 * (w + ((8 - w) & 31))


def _smem_bytes(kb: int, bc: int, seg: Optional[int]) -> int:
    """Shared memory of one block (the kernel's smem_bytes): packed rows,
    scales, both halves of x in bf16, the slots of the f32 partials the
    block sums."""
    scales = (2 * (kb // seg) if seg else 1) * _COLS * 4
    return kb * (_COLS + 16) + scales + 4 * bc * _x_stride(kb) \
        + (bc * _COLS // 4 + _MAX_CLUSTER) * 16


def w4_geometry(b: int, k2: int, n: int, bn: int, seg: Optional[int],
                sms: int) -> W4Geometry:
    """The kernel's launch geometry, a pure function of the shapes and the
    card's SM count. The smallest cluster (at most 8 blocks, each over
    whole groups) that gives the grid at least one block per SM and each
    block at most 128 packed rows (a block's 16-row steps run one after
    another: fewer are faster, `PERF.md`); the batch in as few passes of
    equal size as 96 rows a pass allow, shrunk while a block's shared
    memory passes 227 KB."""
    if b < 1 or k2 < 1 or bn % _COLS or n % bn:
        raise ValueError(f"no W4 geometry for B={b}, K/2={k2}, N={n}, "
                         f"BN={bn}")
    unit = seg or 16
    units = -(-k2 // unit)
    tiles = n // _COLS
    per = units
    for want in range(1, min(_MAX_CLUSTER, units) + 1):
        per = -(-units // want)
        if -(-units // per) * tiles >= sms and per * unit <= _ROWS:
            break
    kb = per * unit
    ks = -(-k2 // kb)
    passes = -(-b // _MAX_PASS)
    bc = -(-(-(-b // passes)) // 8) * 8
    while _smem_bytes(kb, bc, seg) > _MAX_SMEM and bc > 8:
        bc -= 8
    if _smem_bytes(kb, bc, seg) > _MAX_SMEM:
        raise ValueError(f"K/2={k2} needs {kb} packed rows a block: more "
                         f"shared memory than a block has")
    return W4Geometry(ks, kb, bc, _smem_bytes(kb, bc, seg))


@functools.lru_cache(maxsize=None)
def _launch_geometry(b: int, k2: int, n: int, bn: int, seg: Optional[int],
                     index: int) -> W4Geometry:
    """The geometry per call shape and device, computed once."""
    return w4_geometry(b, k2, n, bn, seg, _build.sm_count(index))


def w4_matmul(x: torch.Tensor, blocks: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """x [B, K] (bf16/f32) @ dequant(blocks [NB, K/2, BN], scales) -> [B, N]
    in x's dtype.

    On a CUDA tensor this launches `csrc/w4_matmul.cu` once (counted in
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
    if not (blocks.is_cuda and scales.is_cuda
            and x.device == blocks.device == scales.device):
        raise ValueError("x, blocks and scales must be on one CUDA device")
    b, n = x.shape[0], nb * bn
    geo = _launch_geometry(b, k2, n, bn, seg, x.device.index or 0)
    x = x.contiguous()
    blocks = blocks.contiguous()
    scales = scales.contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    fn = _build.c_function(name, 4, 9)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), blocks.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), b, k2, n, bn, scales.shape[1], seg or 0,
                    geo.ks, geo.kb, geo.bc, stream), name)
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
