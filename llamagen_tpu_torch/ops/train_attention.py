"""Causal training attention on the native [B, S, H, D] layout (K4).

PyTorch counterpart of `llamagen_tpu/ops/train_attention.py`
(`causal_attention_bshd`, `causal_attention_padded`). `causal_attention`
launches the hand-written CUDA kernels of `csrc/train_attention.cu` on CUDA
tensors, through the operator `llamagen_tpu_torch::train_attention`
(`torch.library.custom_op`) whose registered backward runs kernels too; on
CPU tensors it computes `causal_attention_ref`, the plain version with the
same signature, and autograd gives its gradients.

What both compute, per batch row and head (the JAX kernel's formula and
casts): `p = softmax_f32(mask_causal(q . k^T * scale, -1e30))`,
`o = (p cast to q's dtype) . v` with f32 sums. The kernel's backward
recomputes p from the saved per-row log-sum-exp and gives
`dv = p^T . do`, `ds = p * (do . v^T - delta)` cast to the input dtype,
`dq = ds . k * scale`, `dk = ds^T . q * scale`, with
`delta = rowsum(do * o)` (the JAX kernel's `rowsum(dp * p)` up to o's
rounding to the input dtype).

Three kernels, each with a launch counter on its wrapper:
`train_attention_fwd` (o and the log-sum-exp), `train_attention_dq` (dq
and delta) and `train_attention_dkdv` (dk and dv). They take bf16 inputs
(run on the tensor cores: the forward in one pass on wgmma fed by TMA, the
backward on mma.sync fed by a cp.async ring) or f32 inputs (run on the
CUDA cores in f32): q, k, v with head_dim 64 or 128, batch and row strides
(v is a view into the wqkv output: its row stride is 3F, and it is read in
place, not copied; at bf16 the strides and base offsets must be multiples
of 8 elements, 16 bytes), and dense last two dimensions. The bf16 forward
rounds the unnormalised p = exp(s - running max) to bf16 before the
product with v and divides by the row sum after it; the JAX kernel rounds
the normalised p (both one bf16 rounding of p). `causal_attention_padded`
zero-pads any other head_dim to 64 or 128 (zero lanes add exactly 0 to
every score; the padded output lanes are sliced off).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from llamagen_tpu_torch.ops import _build

NEG = -1e30  # the JAX kernel's mask value
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Plain version of `causal_attention`: dense f32 scores (einsum),
    f32 softmax, probabilities cast to q's dtype before the product with
    v. [B, S, H, D] in and out."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must all be [B, S, H, D]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _strides(x: torch.Tensor) -> Tuple[int, int]:
    """(batch, row) strides of a [B, S, H, D] tensor whose last two
    dimensions are dense, as the kernels read it."""
    d = x.shape[-1]
    if x.stride(3) != 1 or x.stride(2) != d:
        raise ValueError(f"heads must be dense ([..., H, D] strides "
                         f"({d}, 1)), got {x.stride()}")
    if max(x.stride(0), x.stride(1)) * x.shape[0] >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' int strides")
    if x.dtype == torch.bfloat16 and (x.stride(0) % 8 or x.stride(1) % 8
                                      or x.data_ptr() % 16):
        # the tensor-core path moves rows in 16-byte pieces (TMA in the
        # forward, cp.async in the backward)
        raise ValueError("bf16 rows must start on 16-byte boundaries "
                         "(strides and offset multiples of 8 elements)")
    return x.stride(0), x.stride(1)


def _check_cuda(*xs: torch.Tensor) -> None:
    q = xs[0]
    if not q.is_cuda:
        raise ValueError("the train-attention kernels take CUDA tensors; "
                         "use causal_attention for CPU tensors")
    if q.dtype not in _DTYPE_NAMES:
        raise TypeError(f"unsupported dtype {q.dtype} (bf16 or f32)")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} must be 64 or 128 "
                         f"(causal_attention_padded pads others)")
    if any(x.device != q.device for x in xs):
        raise ValueError("all tensors must be on one device")


def _check_dense(**xs: torch.Tensor) -> None:
    """o and do: contiguous, starting on a 16-byte boundary (the kernels
    read their rows in 16-byte pieces)."""
    for name, x in xs.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a "
                             f"16-byte boundary")


def _call(name: str, dtype: torch.dtype, n_pointers: int, *args) -> None:
    full = f"{name}_{_DTYPE_NAMES[dtype]}"
    _build.check(_build.c_function(full, n_pointers, 10, 1)(*args), full)


def train_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel on CUDA tensors: (o [B, S, H, D] in q's dtype,
    per-row log-sum-exp [B, H, S] f32)."""
    _check_shapes(q, k, v)
    _check_cuda(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _call("train_attention_fwd", q.dtype, 5,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          lse.data_ptr(), b, s, h, d, *_strides(q), *_strides(k),
          *_strides(v), scale, torch.cuda.current_stream(q.device).cuda_stream)
    train_attention_fwd.launches += 1
    return o, lse


def train_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq kernel on CUDA tensors: (dq [B, S, H, D], delta [B, H, S] f32 =
    rowsum(do * o)). o and do must be contiguous (16-byte aligned)."""
    _check_shapes(q, k, v)
    _check_cuda(q, k, v, o, do, lse)
    _check_dense(o=o, do=do)
    b, s, h, d = q.shape
    dq = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _call("train_attention_dq", q.dtype, 8,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          b, s, h, d, *_strides(q), *_strides(k), *_strides(v), scale,
          torch.cuda.current_stream(q.device).cuda_stream)
    train_attention_dq.launches += 1
    return dq, delta


def train_attention_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel on CUDA tensors: (dk, dv) [B, S, H, D]. do must be
    contiguous (16-byte aligned); lse and delta come from the forward and
    dq kernels."""
    _check_shapes(q, k, v)
    _check_cuda(q, k, v, do, lse, delta)
    _check_dense(do=do)
    b, s, h, d = q.shape
    dk = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _call("train_attention_dkdv", q.dtype, 8,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          b, s, h, d, *_strides(q), *_strides(k), *_strides(v), scale,
          torch.cuda.current_stream(q.device).cuda_stream)
    train_attention_dkdv.launches += 1
    return dk, dv


train_attention_fwd.launches = 0
train_attention_dq.launches = 0
train_attention_dkdv.launches = 0


@torch.library.custom_op("llamagen_tpu_torch::train_attention",
                         mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels as one differentiable operator, (o, lse): an operator
    of its own so that a selective-checkpoint policy can name it
    (`TRAIN_ATTENTION_OP`, remat "save_attn")."""
    return train_attention_fwd(q, k, v, scale)


@_attention_op.register_fake
def _(q, k, v, scale):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty(b, h, s, dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale


def _backward(ctx, do, _dlse):
    """dq (which also gives delta), then dk/dv."""
    q, k, v, o, lse = ctx.saved_tensors
    do = do.to(q.dtype).contiguous()
    dq, delta = train_attention_dq(q, k, v, o, do, lse, ctx.scale)
    dk, dv = train_attention_dkdv(q, k, v, do, lse, delta, ctx.scale)
    return dq, dk, dv, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)
TRAIN_ATTENTION_OP = torch.ops.llamagen_tpu_torch.train_attention.default


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Causal attention, q/k/v [B, S, H, D] (kv heads already repeated for
    GQA) -> [B, S, H, D] in q's dtype; differentiable.

    On CUDA tensors it runs the kernels (head_dim 64 or 128, bf16 or f32;
    anything else raises); on CPU tensors `causal_attention_ref`."""
    _check_shapes(q, k, v)
    if not q.is_cuda:
        return causal_attention_ref(q, k, v, scale)
    return _attention_op(q, k, v, scale)[0]


def causal_attention_padded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float) -> torch.Tensor:
    """`causal_attention` for any head_dim up to 128: others than 64 and
    128 are zero-padded to the next of the two and the output sliced back
    (bit-identical math; gradients flow through the pad and the slice)."""
    d = q.shape[-1]
    if d in KERNEL_HEAD_DIMS:
        return causal_attention(q, k, v, scale)
    if d > max(KERNEL_HEAD_DIMS):
        raise ValueError(f"head_dim {d} > {max(KERNEL_HEAD_DIMS)}")
    pad = (0, min(x for x in KERNEL_HEAD_DIMS if x > d) - d)
    out = causal_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), scale)
    return out[..., :d]
