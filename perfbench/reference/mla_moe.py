"""The plain reference of DeepSeek-V2's block (arXiv:2405.04434) as a
class-conditional image-token generator, for the MLA + MoE configurations
(`configs/dsv2-*.json`): float32 PyTorch, TF32 off, no kernels, no cache,
no batching of slots. It imports nothing of the program and takes nothing
the program made: it makes the weights from the seed itself, layer by
layer (`weights_mla_moe.py`; the f32 model alone would be 61 GB at
DeepSeek-V2-Lite's size), and quantises them itself.

`serve_logits` gives the CFG-mixed logits a served image's tokens were
sampled from, by one teacher-forced forward over the class token and the
served tokens, in the serving configuration: the linear layers, the
experts and the head at W8A16 (per-output-channel int8, scale max|w| /
127; `weight_bits=4` is the control), `kv_b_proj` and the router as they
are (bf16 values, f32 arithmetic). Each layer, as published:

- MLA, un-absorbed: q = W_q x, 16 heads x (128 nope + 64 rope);
  [c_kv ‖ k_pe] = W_kva x, c_kv RMS-normed; q_pe and k_pe roped (k_pe one
  head, shared); the latent and k_pe read back through bf16, as the
  serving cache holds them; [k_nope ‖ v]_h = W_kvb,h c_kv; score_h =
  (q_nope,h · k_nope,h + q_pe,h · k_pe) * softmax_scale, causal softmax,
  out = W_o [Σ p_h v_h]_h. softmax_scale = (nope + rope) ** -0.5 * m²,
  m = 0.1 * mscale_all_dim * ln(factor) + 1.
- MoE (layers >= first_k_dense_replace): g = softmax(W_gate x) over the
  experts in f32, the top k by g with weights g (not renormalised) times
  routed_scaling_factor; y = Σ g_e E_e(x) + S(x), each a SwiGLU, the
  experts as a loop; the leading layers a dense SwiGLU.

The departures of the configuration (its `assumed`): LlamaGen's 2-D grid
RoPE table on the rope dimensions (zero at the class position), LlamaGen's
class token and head, a vocabulary of the codebook's ids. Its routing is
its own, on f32 scores.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench import weights_mla_moe as wts
from perfbench.reference.gpt import freqs_2d, no_tf32, quant_weight, rms, rope


def softmax_scale(c: Dict) -> float:
    rs = c["rope_scaling"]
    m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0 \
        if rs["factor"] > 1 else 1.0
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_table(c: Dict) -> torch.Tensor:
    return freqs_2d({"block_size": c["block_size"],
                     "head_dim": c["qk_rope_head_dim"],
                     "rope_base": float(c["rope_theta"]),
                     "cls_token_num": c["cls_token_num"]})


def _swiglu(x, gate, up, down, q):
    return (F.silu(x @ q(gate).t()) * (x @ q(up).t())) @ q(down).t()


def _attention(c, w, p, x, freqs, causal, latent_dtype):
    h, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    b, s, _ = x.shape
    a = p + "self_attn."
    q = (x @ w["q"](a + "q_proj.weight").t()).view(b, s, h, nope + rp)
    kva = x @ w["q"](a + "kv_a_proj_with_mqa.weight").t()
    c_kv = rms(kva[..., :r], w["f"](a + "kv_a_layernorm.weight"),
               c["rms_norm_eps"])
    k_pe = rope(kva[..., None, r:], freqs)
    q_pe = rope(q[..., nope:], freqs)
    # what the cache holds
    c_kv = c_kv.to(latent_dtype).float()
    k_pe = k_pe.to(latent_dtype).float()
    kv = (c_kv @ w["f"](a + "kv_b_proj.weight").t()).view(b, s, h,
                                                           nope + vd)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope], kv[..., :nope])
              + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe[:, :, 0])) \
        * softmax_scale(c)
    prob = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", prob, kv[..., nope:])
    return out.reshape(b, s, h * vd) @ w["q"](a + "o_proj.weight").t()


def _moe(c, w, layer, x, q, route_ids):
    p = f"layers.{layer}.mlp."
    flat = x.reshape(-1, x.shape[-1])
    scores = torch.softmax(flat @ w["f"](p + "gate.weight").t(), dim=-1)
    top_w, top_i = torch.topk(scores, c["num_experts_per_tok"], dim=-1)
    if route_ids is not None:
        route_ids.append(top_i.reshape(*x.shape[:2], -1))
    y = torch.zeros_like(flat)
    experts = wts.stacked_experts(c, w["raw"], layer)
    for e in range(c["n_routed_experts"]):
        hit = top_i == e
        rows = hit.any(-1).nonzero()[:, 0]
        if len(rows) == 0:
            continue
        g = (top_w * hit).sum(-1)[rows, None]
        y[rows] += g * _swiglu(flat[rows], experts["gate_proj"][e],
                               experts["up_proj"][e],
                               experts["down_proj"][e], q)
    y = y * c["routed_scaling_factor"]
    s = p + "shared_experts."
    y = y + _swiglu(flat, w["raw"][s + "gate_proj.weight"],
                    w["raw"][s + "up_proj.weight"],
                    w["raw"][s + "down_proj.weight"], q)
    return y.view_as(x)


@torch.no_grad()
def serve_logits(c: Dict, seed: int, device, labels: torch.Tensor,
                 tokens: torch.Tensor, cfg_scale: float, weight_bits: int = 8,
                 route_ids: Optional[List[torch.Tensor]] = None,
                 latent_dtype: torch.dtype = torch.bfloat16,
                 weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, T, V] f32: position i's CFG-mixed logits (uncond + (cond -
    uncond) * cfg_scale), from which token i was drawn, given the class
    labels [N] and the served tokens [N, T]. The weights are the seed's
    (`weights_mla_moe.py`, made in `weight_dtype`, bf16 as the serving
    configuration's are); the latent is read back through `latent_dtype`
    (the cache's, bf16 in the configuration). With `route_ids` (a list),
    each routed layer appends its top-k expert ids [2N, T, k] (cond rows
    first)."""
    no_tf32()

    def quant(t):
        return quant_weight(t, weight_bits)

    ends = wts.end_weights(c, seed, device, weight_dtype)
    n, t = tokens.shape
    s_len = c["cls_token_num"] + t - 1
    freqs = rope_table(c)[:s_len].to(device)
    cond = torch.cat([labels, torch.full_like(labels, c["num_classes"])])
    h = torch.cat([ends["cls_embedding.embedding_table.weight"][cond][:, None],
                   ends["tok_embeddings.weight"][tokens[:, :-1]].repeat(
                       2, 1, 1)], dim=1).float()
    rows = torch.arange(s_len, device=device)
    causal = rows[None, :] <= rows[:, None]
    eps = c["rms_norm_eps"]
    for layer in range(c["num_hidden_layers"]):
        raw = wts.layer_weights(c, seed, layer, device, weight_dtype)
        w = {"raw": raw, "f": lambda k: raw[k].float(),
             "q": lambda k: quant(raw[k])}
        p = f"layers.{layer}."
        x = rms(h, w["f"](p + "input_layernorm.weight"), eps)
        h = h + _attention(c, w, p, x, freqs, causal, latent_dtype)
        x = rms(h, w["f"](p + "post_attention_layernorm.weight"), eps)
        if wts.dense(c, layer):
            m = p + "mlp."
            h = h + _swiglu(x, raw[m + "gate_proj.weight"],
                            raw[m + "up_proj.weight"],
                            raw[m + "down_proj.weight"], quant)
        else:
            h = h + _moe(c, w, layer, x, quant, route_ids)
        del raw, w
    logits = rms(h[:, c["cls_token_num"] - 1:], ends["norm.weight"].float(),
                 eps) @ quant(ends["output.weight"]).t()
    cl, un = logits.chunk(2)
    return un + (cl - un) * cfg_scale
