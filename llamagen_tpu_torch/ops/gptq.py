"""GPTQ: error-compensated int4 levels for the W4 kernel's layout.

PyTorch counterpart of `llamagen_tpu/ops/gptq.py`. GPTQ (Frantar et al.
2022, arXiv 2210.17323) quantises a weight matrix one input row at a time
and moves each row's rounding error onto the rows not yet quantised,
weighted by the upper Cholesky factor of the damped inverse Hessian
H = X^T X / n of the layer's calibration inputs. The output is the W4
kernel's layout (`ops/w4_matmul.py::pack_w4_levels`), so serving is
unchanged: GPTQ only picks better levels and scales.

Orientation: the JAX package's W `[K, N]` (input-major) is the port's
`Linear.weight.t()`; the walk goes over K, the port weight's columns. Group
scales follow the kernel's half-major segments (`_group_table`) and are
set when the walk ENTERS a group, from that group's rows after error
compensation (the dynamic groups of the JAX code, not the static groups of
the paper's reference code); per-channel scales are fixed from the
original W.

Calibration (`_calib_stream`, `layer_matmul_inputs`) is a teacher-forced
eval-mode forward over calibration tokens, built from the port's
`models/gpt.py` pieces with no hooks: each block's five matmul inputs are
recomputed from the residual stream, and layer l + 1 calibrates on the
QUANTISED layer l's output. The row walk is plain PyTorch (JAX runs it in
a jitted `fori_loop`, no Pallas): each row updates only the rows after it,
in place; the device is never read inside the walk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.w4_matmul import SEG_ROWS, _segments, pack_w4_levels

MATMULS = ("wqkv", "wo", "w1", "w3", "w2")  # the layer's five, JAX's keys


def layer_linears(layer: gpt.TransformerBlock) -> Dict[str, gpt.Linear]:
    """A block's five matmuls under the JAX package's names."""
    att, ff = layer.attention, layer.feed_forward
    return {"wqkv": att.wqkv, "wo": att.wo, "w1": ff.w1, "w3": ff.w3,
            "w2": ff.w2}


def layer_matmul_inputs(layer: gpt.TransformerBlock, h: torch.Tensor,
                        freqs: torch.Tensor, mask: torch.Tensor,
                        cfg: GPTConfig
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One block's matmul inputs from its residual-stream input h [B, S, D]
    (eval mode, no dropout): ({wqkv, wo, w1, w3, w2: [B, S, K]}, the
    block's output). JAX `_layer_matmul_inputs`; a W4 layer's rank-3
    matmuls take the dequantised product, as JAX's do."""
    b, s, _ = h.shape
    lin = layer_linears(layer)
    attn_in = layer.attention_norm(h)
    q, k, v = gpt.split_heads(lin["wqkv"](attn_in), cfg.n_head,
                              cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.kv_heads, cfg.head_dim)
    q, k = gpt.rope_heads(q, freqs), gpt.rope_heads(k, freqs)
    pre_wo = gpt._sdpa(q, k, v, mask, bf16_scores=h.dtype == torch.bfloat16)
    h2 = h + lin["wo"](pre_wo)
    ffn_in = layer.ffn_norm(h2)
    w2_in = F.silu(lin["w1"](ffn_in)) * lin["w3"](ffn_in)
    h3 = h2 + lin["w2"](w2_in)
    return ({"wqkv": attn_in, "wo": pre_wo, "w1": ffn_in, "w3": ffn_in,
             "w2": w2_in}, h3)


def _calib_stream(model: gpt.Transformer, cond: torch.Tensor,
                  idx: torch.Tensor, compute_dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h [B, S, D], rope rows [S, D/2, 2], causal mask [S, S]) of the
    teacher-forced pass: the condition's embedding then the tokens' (JAX
    `_calib_stream`, eval mode)."""
    h = torch.cat([model.embed_condition(cond),
                   F.embedding(idx, model.tok_embeddings.weight)],
                  dim=1).to(compute_dtype)
    s = h.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    return h, model.freqs_cis[:s], mask


def _hessian(x: torch.Tensor) -> torch.Tensor:
    """[B, S, K] activations -> H = X^T X / n, f32 [K, K]."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return (xf.t() @ xf) / xf.shape[0]


def _group_table(k: int, group_size: int, per_channel: bool
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(group id per row [K], the rows where each group starts, the
    longest group) in the kernel's order: half-major segments of
    `group_size` rows (a ragged tail per half), `pack_w4`'s; one group of
    K rows per channel."""
    if per_channel:
        return np.zeros((k,), np.int32), np.zeros((1,), np.int32), k
    k2 = k // 2
    group_size = min(group_size, k2)
    gid = np.zeros((k,), np.int32)
    starts = []
    for half in range(2):
        for r0, rl in _segments(k2, group_size):
            s0 = half * k2 + r0
            gid[s0:s0 + rl] = len(starts)
            starts.append(s0)
    return gid, np.asarray(starts, np.int32), group_size


def _scale(mx: torch.Tensor) -> torch.Tensor:
    """max|w| -> the int4 scale max / 7 + 1e-12 (a division by a tensor,
    bit for bit JAX's: see `ops/w4_matmul.py::_rtn`)."""
    return mx / torch.full_like(mx, 7.0) + 1e-12


def _gptq_core(w: torch.Tensor, hinv_u: torch.Tensor, gid: np.ndarray,
               gstart: np.ndarray, per_channel: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row walk with error feedback. w [K, N] f32 (consumed);
    hinv_u [K, K] upper Cholesky factor of the damped inverse Hessian.
    Returns (levels [K, N] int8, scales [G, N] f32)."""
    k, n = w.shape
    levels = torch.empty(k, n, dtype=torch.int8, device=w.device)
    if per_channel:
        scales = _scale(w.abs().amax(dim=0, keepdim=True))
    else:
        scales = torch.zeros(len(gstart), n, device=w.device)
        ends = list(gstart[1:]) + [k]
        enter = {int(s0): (g, int(e)) for g, (s0, e)
                 in enumerate(zip(gstart, ends))}
    for i in range(k):
        if not per_channel and i in enter:
            g, end = enter[i]
            scales[g] = _scale(w[i:end].abs().amax(dim=0))
        srow = scales[0 if per_channel else int(gid[i])]
        wi = w[i]
        q = torch.clamp(torch.round(wi / srow), -8, 7)
        err = (wi - q * srow) / hinv_u[i, i]
        # onto the rows not yet visited (hinv_u is upper triangular)
        w[i + 1:] -= hinv_u[i, i + 1:, None] * err[None, :]
        levels[i] = q.to(torch.int8)
    return levels, scales


def gptq_quantize_matrix(w: torch.Tensor, h: torch.Tensor, *,
                         group_size: int = SEG_ROWS,
                         per_channel: bool = False, damp: float = 0.01
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One matrix w [K, N] (input-major: a port `Linear.weight.t()`) and its
    Hessian [K, K] -> (blocks, scales) in the W4 kernel's layout. The
    Hessian is damped by (damp * mean(diag) + 1e-8) * I, inverted,
    symmetrised and factored (upper Cholesky) on the host CPU in f32, so
    that the levels do not depend on the device's solver: a GPU's inverse
    differs from LAPACK's in the last bits, which flips a level now and
    then, and the error feedback carries each flip into the scales of the
    groups after it. The walk runs on w's device."""
    k = w.shape[0]
    h32 = h.float().cpu()
    h32 = h32 + torch.eye(k) * (damp * torch.diagonal(h32).mean() + 1e-8)
    hinv = torch.linalg.inv(h32)
    hinv = (hinv + hinv.t()) / 2
    hinv_u = torch.linalg.cholesky(hinv).t().to(w.device)
    gid, gstart, _ = _group_table(k, group_size, per_channel)
    levels, scales = _gptq_core(w.float().clone(), hinv_u, gid, gstart,
                                per_channel)
    return pack_w4_levels(levels, scales)


@torch.no_grad()
def gptq_quantize_gpt_params(model: gpt.Transformer, cond: torch.Tensor,
                             tokens: torch.Tensor, *,
                             per_channel: bool = False,
                             group_size: int = SEG_ROWS,
                             int8_head: bool = False, damp: float = 0.01,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             verbose: bool = False,
                             hessians: Optional[Dict[int, dict]] = None
                             ) -> gpt.Transformer:
    """Calibrated W4 quantisation of a `Transformer`'s layer matmuls, in
    place (the layout `ops/w4_matmul.py::quantize_gpt_params_w4k` gives).

    cond: [B] class labels (c2i) or [B, T, caption_dim] captions (t2i);
    tokens: [B, S] calibration ids (VQ codes of real images for released
    checkpoints; random ids are the fallback). Layer l + 1's Hessians come
    from the quantised layer l's outputs. `int8_head` makes the head W8A16.
    When `hessians` is a dict, hessians[l] = {matmul: H} for every layer l:
    the Hessians the walk used (for H-weighted errors tr(dW^T H dW)).
    Returns the model."""
    cfg = model.cfg
    h, freqs, mask = _calib_stream(model, cond, tokens[:, :-1],
                                   compute_dtype)
    for l, layer in enumerate(model.layers):
        inputs, _ = layer_matmul_inputs(layer, h, freqs, mask, cfg)
        hess = {key: _hessian(inputs[key]) for key in MATMULS}
        del inputs
        if hessians is not None:
            hessians[l] = hess
        for key, lin in layer_linears(layer).items():
            lin.weight_w4b, lin.weight_w4s = gptq_quantize_matrix(
                lin.weight.detach().t(), hess[key], group_size=group_size,
                per_channel=per_channel, damp=damp)
            lin.weight = None
        _, h = layer_matmul_inputs(layer, h, freqs, mask, cfg)
        if verbose:
            print(f"gptq: layer {l + 1}/{cfg.n_layer} done", flush=True)
    if int8_head:
        model.output.quantize_()
    return model
