"""W8A16 weights: int8 weight matrices with per-output-channel scales.

PyTorch counterpart of `llamagen_tpu/ops/quant_matmul.py`: the bf16, int8
and W4 (`ops/w4_matmul.py`) branches of `matmul_any`; the XLA-only
`int4_matmul` storage mode is not ported. On the TPU, XLA fuses the
int8 -> bf16 convert into the matmul's weight read. PyTorch has no such
fusion, so here every W8A16 product goes through the hand-written CUDA
kernel `csrc/int8_matmul.cu` (`int8_matmul`); the dequantised matrix never
exists in memory.

Layouts follow the JAX package: `quantize_weight` takes `[..., K, N]`
(in, out) and `int8_matmul` takes `w_q [K, N]`. A quantised `Linear` of
`models/gpt.py` keeps `weight_q [K, N]` and `weight_scale [N]` in place of
its `weight [N, K]`, so a quantised state dict carries the `_q` / `_scale`
keys of the JAX parameter tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from llamagen_tpu_torch.ops import _build
from llamagen_tpu_torch.ops.w4_matmul import w4_dequant, w4_matmul

_CHUNK = 128  # K rows per round of csrc/int8_matmul.cu (kChunk)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_matmul`: f32 product, scale on the f32 sum,
    one rounding to x's dtype."""
    return ((x.float() @ w_q.float()) * w_scale.float()).to(x.dtype)


def _k_per_split(b: int, k: int, n: int, device: torch.device) -> int:
    """K rows per block (a multiple of the kernel's 128-row chunk): split K
    across blocks until the grid has about two blocks per SM."""
    chunks = -(-k // _CHUNK)
    tiles = -(-n // 64) * -(-b // 16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(chunks, -(-2 * sms // tiles)))
    return -(-chunks // splits) * _CHUNK


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x [B, K] (bf16/f32) @ dequant(w_q [K, N] int8, w_scale [N] f32)
    -> [B, N] in x's dtype.

    On a CUDA tensor this launches `csrc/int8_matmul.cu` (and counts the
    launch in `int8_matmul.launches`); on a CPU tensor it computes
    `int8_matmul_ref`.
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
    x = x.contiguous()
    w_q = w_q.contiguous()
    w_scale = w_scale.float().contiguous()
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    k_per_split = _k_per_split(b, k, n, x.device)
    splits = -(-k // k_per_split)
    partial = (torch.empty((splits, b, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _build.c_function(name, 5, 4)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                    out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    b, k, n, k_per_split, stream), name)
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


def matmul_any(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               weight_q: Optional[torch.Tensor] = None,
               weight_scale: Optional[torch.Tensor] = None,
               w4_blocks: Optional[torch.Tensor] = None,
               w4_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ W -> [..., N] for a bf16/f32 `weight [N, K]` (nn.Linear
    layout), a W8A16 `weight_q [K, N]` + `weight_scale [N]`, or W4
    `w4_blocks` + `w4_scales` (`ops/w4_matmul.py` layout).

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
    if weight_q is None:
        return x @ weight.to(x.dtype).t()
    out = int8_matmul(x.reshape(-1, x.shape[-1]), weight_q, weight_scale)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def quantize_gpt_params(model: nn.Module,
                        quantize_head: bool = False) -> nn.Module:
    """Quantise a `models.gpt.Transformer`'s layer matmuls to W8A16 in place.

    wqkv, wo, w1, w2 and w3 of every layer become int8 + per-channel
    scales; norms, embeddings and the conditioning stay as they are. The
    output head stays in its dtype unless `quantize_head` (as in JAX,
    quant_matmul.py:180-209). Returns the model.
    """
    for layer in model.layers:
        for lin in (layer.attention.wqkv, layer.attention.wo,
                    layer.feed_forward.w1, layer.feed_forward.w2,
                    layer.feed_forward.w3):
            lin.quantize_()
    if quantize_head:
        model.output.quantize_()
    return model
