"""DeepSeek-V2's decoder block (multi-head latent attention and a routed
mixture of experts, arXiv:2405.04434) as a class-conditional image-token
generator, for the serving engine: inference only.

The ends are LlamaGen's, as in `models/gpt.py`: `tok_embeddings` over the
VQ codebook, `cls_embedding.embedding_table` (the class token at position
0, the null class for CFG), LlamaGen's 2-D grid RoPE table on the rope
dimensions (`gpt._freqs_cis_2d_np`, whose condition rows are zero), the
final `norm` and an untied `output` head. The layers carry DeepSeek-V2's
state-dict names: `layers.{i}.input_layernorm`, `self_attn.{q_proj,
kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj}`,
`post_attention_layernorm`, and `mlp.{gate_proj, up_proj, down_proj}` in
the leading dense layers or `mlp.gate` (the router), `mlp.experts.{e}.
{gate,up,down}_proj` and `mlp.shared_experts.*` in the routed ones.

The cache is latent (`init_cache`): per layer one bf16 `[B, S, R + P]`
buffer of `[c_kv ‖ k_pe]` rows, the RMS-normed latent and the roped
shared key, written in place by the decode attention kernel (K6,
`ops/mla_attention.py`). The decode step runs the attention absorbed: the
query's nope part is mapped into the latent by `kv_b_proj`'s k half
(`q̃_h = W_UK,hᵀ q_nope,h`), K6 returns each head's softmax-weighted sum
of latents, and `kv_b_proj`'s v half maps it to v-space before `o_proj`
(two batched matmuls over the heads, `kv_b_proj` kept in bf16 for them).
The routed layers run `ops/moe.py` (the router in f32, top-k, the dispatch
and the grouped W8A16 product K7); the serving engine reaches all of this
through `init_cache` and `decode_step_slots`, which have `models/gpt.py`'s
signatures. As in the GPT's c2i serving, a slot's class token runs as an
ordinary step at position 0, so admission costs no prefill.

`quantize_layer_` turns a layer's matmuls into W8A16 (K2 for q_proj,
kv_a_proj_with_mqa, o_proj and the dense and shared SwiGLUs, K7 for the
experts, stacked); the router and `kv_b_proj` stay as they are, and
`output.quantize_()` does the head. One layer at a time, a model can be
made and quantised without ever holding its bf16 weights whole
(`perfbench/drivers/serve_mla_moe.py::build_model`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.config import MLAMoEConfig
from llamagen_tpu_torch.models.gpt import (KVCache, LabelEmbedder, Linear,
                                           RMSNorm, _freqs_cis_2d_np,
                                           rope_heads)
from llamagen_tpu_torch.ops import moe
from llamagen_tpu_torch.ops.mla_attention import mla_decode_attention


class MLAttention(nn.Module):
    """Multi-head latent attention's projections (no q low-rank)."""

    def __init__(self, cfg: MLAMoEConfig, **kw):
        super().__init__()
        h = cfg.n_head
        self.q_proj = Linear(cfg.dim, h * cfg.qk_head_dim, **kw)
        self.kv_a_proj_with_mqa = Linear(cfg.dim, cfg.latent_dim, **kw)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.norm_eps, **kw)
        self.kv_b_proj = Linear(
            cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            **kw)
        self.o_proj = Linear(h * cfg.v_head_dim, cfg.dim, **kw)


class SwiGLU(nn.Module):
    """DeepSeek-V2's MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.gate_proj = Linear(dim, hidden, **kw)
        self.up_proj = Linear(dim, hidden, **kw)
        self.down_proj = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    """The router's weight [E, D] (`mlp.gate.weight`)."""

    def __init__(self, cfg: MLAMoEConfig, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.dim, **kw))


class MoE(nn.Module):
    """Routed experts and the shared ones. After `quantize_()` the experts
    live stacked in `experts_q` (`ops.moe.Experts`) and `experts` holds no
    weights."""

    def __init__(self, cfg: MLAMoEConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.gate = MoEGate(cfg, **kw)
        self.experts = nn.ModuleList(
            SwiGLU(cfg.dim, cfg.moe_ffn_dim, **kw)
            for _ in range(cfg.n_routed_experts))
        self.shared_experts = SwiGLU(cfg.dim, cfg.shared_ffn_dim, **kw)
        self.experts_q: Optional[moe.Experts] = None

    @torch.no_grad()
    def quantize_(self) -> None:
        stack = lambda name: torch.stack(  # noqa: E731
            [getattr(e, name).weight.detach() for e in self.experts])
        self.experts_q = moe.quantize_experts(
            stack("gate_proj"), stack("up_proj"), stack("down_proj"))
        for e in self.experts:
            for lin in (e.gate_proj, e.up_proj, e.down_proj):
                lin.weight = None
        for lin in (self.shared_experts.gate_proj,
                    self.shared_experts.up_proj,
                    self.shared_experts.down_proj):
            lin.quantize_()

    def forward(self, x: torch.Tensor,
                expert_rows: Optional[torch.Tensor] = None,
                route_ids: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """x [T, D]; the experts must be quantised (`quantize_()`).
        `expert_rows` and `route_ids` as `moe.moe_forward` takes them."""
        cfg = self.cfg
        if self.experts_q is None:
            raise RuntimeError("the routed experts run at W8A16 only: "
                               "quantize_layer_ first")
        routed = moe.moe_forward(x, self.gate.weight, self.experts_q,
                                 cfg.top_k, cfg.routed_scaling_factor,
                                 expert_rows, route_ids)
        return routed + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MLAMoEConfig, dense: bool, **kw):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.self_attn = MLAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.mlp = (SwiGLU(cfg.dim, cfg.dense_ffn_dim, **kw) if dense
                    else MoE(cfg, **kw))


class MLAMoETransformer(nn.Module):
    """The c2i generator over `MLAMoEConfig`. One device, no tensor
    parallelism (`tp_size` 1, no group). `expert_rows [layers - first_k,
    E]` int32 counts the rows each routed layer's decode steps sent to each
    expert (the serving engine reads and zeroes it)."""

    def __init__(self, cfg: MLAMoEConfig, device=None, dtype=None):
        super().__init__()
        if cfg.model_type != "c2i":
            raise ValueError(f"the MLA + MoE model is c2i only, not "
                             f"{cfg.model_type!r}")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.cls_embedding = LabelEmbedder(cfg, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.first_k_dense, **kw)
            for i in range(cfg.n_layer))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.output = Linear(cfg.dim, cfg.vocab_size, **kw)
        freqs = _freqs_cis_2d_np(cfg.grid_size, cfg.qk_rope_head_dim,
                                 cfg.rope_base, cfg.cls_token_num)
        self.register_buffer("freqs_cis", torch.tensor(freqs, device=device),
                             persistent=False)
        self.register_buffer("expert_rows", torch.zeros(
            cfg.n_moe_layers, cfg.n_routed_experts, dtype=torch.int32,
            device=device), persistent=False)
        self.tp_size, self.tp_rank = 1, 0
        self.tp_group: Optional[dist.ProcessGroup] = None


@torch.no_grad()
def quantize_layer_(layer: DecoderLayer) -> None:
    """W8A16 for one layer's matmuls, in place (see the module
    docstring)."""
    attn = layer.self_attn
    for lin in (attn.q_proj, attn.kv_a_proj_with_mqa, attn.o_proj):
        lin.quantize_()
    if isinstance(layer.mlp, MoE):
        layer.mlp.quantize_()
    else:
        for lin in (layer.mlp.gate_proj, layer.mlp.up_proj,
                    layer.mlp.down_proj):
            lin.quantize_()


def init_cache(cfg: MLAMoEConfig, batch: int, max_seq_len: int,
               dtype: torch.dtype, device,
               compute_dtype: torch.dtype = torch.bfloat16,
               kv_heads: Optional[int] = None) -> KVCache:
    """The latent cache: per layer a zeroed `[batch, max_seq_len, R + P]`
    buffer in `dtype` (bf16, or f32 for f32 tests on the CPU).
    `compute_dtype` and `kv_heads` are the GPT's signature's and unused."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the latent cache is bf16 or f32, not {dtype}")
    return KVCache([torch.zeros(batch, max_seq_len, cfg.latent_dim,
                                dtype=dtype, device=device)
                    for _ in range(cfg.n_layer)])


def _attention(attn: MLAttention, x: torch.Tensor, freqs: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor,
               cfg: MLAMoEConfig) -> torch.Tensor:
    """One layer's absorbed latent attention for x [B, D] at positions
    pos [B]; writes row pos of each batch row of `cache`."""
    b = x.shape[0]
    h, dn, dv = cfg.n_head, cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q = attn.q_proj(x).view(b, h, cfg.qk_head_dim)
    kva = attn.kv_a_proj_with_mqa(x)
    c_kv = attn.kv_a_layernorm(kva[:, :r])
    k_pe = rope_heads(kva[:, None, r:], freqs)[:, 0]
    q_pe = rope_heads(q[..., dn:], freqs)
    w = attn.kv_b_proj.weight.view(h, dn + dv, r)
    q_lat = torch.bmm(q[..., :dn].transpose(0, 1), w[:, :dn])  # [H, B, R]
    o_lat = mla_decode_attention(
        torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1),
        torch.cat([c_kv, k_pe], dim=-1), cache, pos, r, cfg.softmax_scale)
    o = torch.bmm(o_lat.transpose(0, 1), w[:, dn:].transpose(1, 2))
    return attn.o_proj(o.transpose(0, 1).reshape(b, h * dv))


@torch.no_grad()
def decode_step_slots(model: MLAMoETransformer, emb: torch.Tensor,
                      pos: torch.Tensor, cache: KVCache,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      prefix_pad: Optional[torch.Tensor] = None,
                      route_ids: Optional[List[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """One step with a position per row (`gpt.decode_step_slots`'s
    contract): emb [B, D] input embeddings (token, class or null), pos
    int32 [B] inside the cache (not read back to the host). Every layer
    writes row pos of its latent cache in place; the routed layers add
    their expert counts to `model.expert_rows` and, where `route_ids` is
    given, append their chosen expert ids [B, top_k] to it in layer order.
    Returns f32 logits [B, V]. `prefix_pad` (t2i) must be None."""
    if prefix_pad is not None:
        raise ValueError("the MLA + MoE model is c2i: no caption pads")
    cfg = model.cfg
    h = emb.to(compute_dtype)
    freqs = model.freqs_cis[pos]  # [B, P // 2, 2]
    routed: List[Optional[torch.Tensor]] = \
        [None] * cfg.first_k_dense + list(model.expert_rows)
    for layer, kv, rows in zip(model.layers, cache.kv, routed):
        h = h + _attention(layer.self_attn, layer.input_layernorm(h), freqs,
                           kv, pos, cfg)
        x = layer.post_attention_layernorm(h)
        h = h + (layer.mlp(x) if rows is None
                 else layer.mlp(x, rows, route_ids))
    return model.output(model.norm(h)).float()
