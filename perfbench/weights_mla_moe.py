"""Weights of the MLA + MoE configurations (`configs/dsv2-*.json`,
DeepSeek-V2's key names) made from `--seed`, on the device, one tensor
group at a time: the ends (embeddings, the class table, the head) in one
draw, each layer in one draw of its own (its own stream of the seed), so
that a layer's weights can be made again without the others. The program
loads and quantises them layer by layer; the reference makes each layer
again when it reaches it (the f32 model would not fit beside the
program's).

Matrices and embeddings normal(0, initializer_range), the head too, norm
weights 1. Within a layer the routed experts' matrices come in the order
all gate_proj, all up_proj, all down_proj, so that `stacked_experts`
returns each kind as one [E, ...] view of the draw.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.weights import generator

ENDS_STREAM = 10
LAYER_STREAM = 100  # + the layer's index
EXPERT_KINDS = ("gate_proj", "up_proj", "down_proj")


def end_shapes(c: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    d, v = c["hidden_size"], c["vocab_size"]
    return [("tok_embeddings.weight", (v, d)),
            ("cls_embedding.embedding_table.weight",
             (c["num_classes"] + 1, d)),
            ("norm.weight", (d,)), ("output.weight", (v, d))]


def dense(c: Dict, layer: int) -> bool:
    return layer < c["first_k_dense_replace"]


def layer_shapes(c: Dict, layer: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of layer `layer`'s weights, in the draw's order."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    r, rope = c["kv_lora_rank"], c["qk_rope_head_dim"]
    nope, vd = c["qk_nope_head_dim"], c["v_head_dim"]
    p = f"layers.{layer}."
    a = p + "self_attn."
    out = [(p + "input_layernorm.weight", (d,)),
           (a + "q_proj.weight", (h * (nope + rope), d)),
           (a + "kv_a_proj_with_mqa.weight", (r + rope, d)),
           (a + "kv_a_layernorm.weight", (r,)),
           (a + "kv_b_proj.weight", (h * (nope + vd), r)),
           (a + "o_proj.weight", (d, h * vd)),
           (p + "post_attention_layernorm.weight", (d,))]
    m = p + "mlp."
    if dense(c, layer):
        f = c["intermediate_size"]
        return out + [(m + "gate_proj.weight", (f, d)),
                      (m + "up_proj.weight", (f, d)),
                      (m + "down_proj.weight", (d, f))]
    f, fs = c["moe_intermediate_size"], \
        c["n_shared_experts"] * c["moe_intermediate_size"]
    out.append((m + "gate.weight", (c["n_routed_experts"], d)))
    for kind in EXPERT_KINDS:
        shape = (d, f) if kind == "down_proj" else (f, d)
        out += [(f"{m}experts.{e}.{kind}.weight", shape)
                for e in range(c["n_routed_experts"])]
    return out + [(m + "shared_experts.gate_proj.weight", (fs, d)),
                  (m + "shared_experts.up_proj.weight", (fs, d)),
                  (m + "shared_experts.down_proj.weight", (d, fs))]


def _draw(shapes, c: Dict, seed: int, stream: int, device,
          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One normal draw over the matrices of `shapes`, cut into views;
    vectors (norm weights) are ones."""
    n = sum(int(np.prod(s)) for _, s in shapes if len(s) == 2)
    flat = torch.empty(n, dtype=dtype, device=device)
    flat.normal_(0.0, c["initializer_range"],
                 generator=generator(seed, stream, device))
    out, at = {}, 0
    for k, s in shapes:
        if len(s) == 1:
            out[k] = torch.ones(s, dtype=dtype, device=device)
            continue
        size = int(np.prod(s))
        out[k] = flat[at:at + size].view(s)
        at += size
    return out


@torch.no_grad()
def end_weights(c: Dict, seed: int, device,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return _draw(end_shapes(c), c, seed, ENDS_STREAM, device, dtype)


@torch.no_grad()
def layer_weights(c: Dict, seed: int, layer: int, device,
                  dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return _draw(layer_shapes(c, layer), c, seed, LAYER_STREAM + layer,
                 device, dtype)


def stacked_experts(c: Dict, w: Dict[str, torch.Tensor], layer: int
                    ) -> Dict[str, torch.Tensor]:
    """A routed layer's experts from `layer_weights` as [E, out, in] views
    of the draw, by kind."""
    m = f"layers.{layer}.mlp.experts."
    n = c["n_routed_experts"]
    out = {}
    for kind in EXPERT_KINDS:
        first = w[f"{m}0.{kind}.weight"]
        out[kind] = torch.as_strided(first, (n,) + tuple(first.shape),
                                     (first.numel(), *first.stride()))
    return out


def n_params(c: Dict) -> int:
    return sum(int(np.prod(s)) for s in
               [s for _, s in end_shapes(c)]
               + [s for l in range(c["num_hidden_layers"])
                  for _, s in layer_shapes(c, l)])
