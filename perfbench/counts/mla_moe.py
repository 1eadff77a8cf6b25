"""Operations and bytes of the MLA + MoE configurations' decode step
(`configs/dsv2-*.json`, DeepSeek-V2's key names), the yardstick of the
`dsv2_serve.*` readers: K6 (the absorbed latent attention), K7 (the
grouped W8A16 expert product), K2 at this model's dense shapes, and the
whole step. Each input byte is counted read once, each output byte
written once (`perfbench/counts/__init__.py`'s rule)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from perfbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, k2_bound_s


def _dims(c: Dict):
    return (c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"],
            c["qk_rope_head_dim"], c["qk_nope_head_dim"], c["v_head_dim"])


def n_moe_layers(c: Dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


# ---------------------------------------------------------------------------
# K6: absorbed latent decode attention, bf16 rows [c_kv ‖ k_pe]
# ---------------------------------------------------------------------------


def k6_bytes(positions: Iterable[int], c: Dict) -> int:
    """One K6 call for rows at `positions`: cache rows [0, pos) read, the
    new row read and written, q [H, R + P] read and out [H, R] written,
    all bf16."""
    _, h, r, p, _, _ = _dims(c)
    row = 2 * (r + p)
    return sum(pos * row + 2 * row + 2 * h * (r + p) + 2 * h * r
               for pos in positions)


def k6_flops(positions: Iterable[int], c: Dict) -> int:
    """Scores over R + P and the weighted sum over R, for each head and
    each of the pos + 1 keys."""
    _, h, r, p, _, _ = _dims(c)
    return sum((pos + 1) * h * 2 * ((r + p) + r) for pos in positions)


# ---------------------------------------------------------------------------
# K7: the routed experts, rows * top_k pairs a routed layer
# ---------------------------------------------------------------------------


def k7_layer_bytes(c: Dict, rows: int) -> int:
    """One routed layer's two K7 calls: every expert's int8 gate | up and
    down matrices (each expert gets rows at decode batch) with their f32
    scales, the pairs' bf16 inputs read and outputs written (x and
    gate | up; silu(gate) * up and the down outputs)."""
    d, f, e = c["hidden_size"], c["moe_intermediate_size"], \
        c["n_routed_experts"]
    pairs = rows * c["num_experts_per_tok"]
    weights = e * (d * 2 * f + f * d) + e * (2 * f + d) * 4
    acts = pairs * (d + 2 * f) * 2 + pairs * (f + d) * 2
    return weights + acts


def k7_layer_flops(c: Dict, rows: int) -> int:
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    return 2 * rows * c["num_experts_per_tok"] * 3 * d * f


def k7_step_bound_s(c: Dict, rows: int) -> float:
    """The routed layers of one step: each layer's bytes at 3.35 TB/s or
    its operations at 989 TFLOP/s, whichever is larger, summed."""
    return n_moe_layers(c) * max(
        k7_layer_bytes(c, rows) / PEAK_BYTES_PER_S,
        k7_layer_flops(c, rows) / PEAK_BF16_FLOPS)


# ---------------------------------------------------------------------------
# K2 at the dense shapes, and the whole step
# ---------------------------------------------------------------------------


def k2_matmuls(c: Dict) -> List[Tuple[int, int, int]]:
    """(K, N, calls a step) of every W8A16 matmul on K2: q_proj,
    kv_a_proj_with_mqa and o_proj in every layer, the leading dense
    layers' SwiGLU, the routed layers' shared SwiGLU, the head."""
    d, h, r, p, nope, vd = _dims(c)
    n, dense, moe = c["num_hidden_layers"], c["first_k_dense_replace"], \
        n_moe_layers(c)
    f, fs = c["intermediate_size"], \
        c["n_shared_experts"] * c["moe_intermediate_size"]
    return [(d, h * (nope + p), n), (d, r + p, n), (h * vd, d, n),
            (d, f, 2 * dense), (f, d, dense),
            (d, fs, 2 * moe), (fs, d, moe),
            (d, c["vocab_size"], 1)]


def k2_step_bound_s(c: Dict, rows: int) -> float:
    return sum(calls * k2_bound_s(rows, k, n)
               for k, n, calls in k2_matmuls(c))


def active_params(c: Dict) -> int:
    """Weights each row multiplies by in a decode step: the K2 matmuls,
    kv_b_proj (its k half maps q into the latent, its v half the latent
    out), the router and top_k experts of every routed layer."""
    d, h, r, _, nope, vd = _dims(c)
    f = c["moe_intermediate_size"]
    k2 = sum(calls * k * n for k, n, calls in k2_matmuls(c))
    kv_b = c["num_hidden_layers"] * h * (nope + vd) * r
    routed = n_moe_layers(c) * (c["n_routed_experts"] * d
                                + c["num_experts_per_tok"] * 3 * d * f)
    return k2 + kv_b + routed


def decode_step_flops(c: Dict, positions: Iterable[int]) -> int:
    """One decode step of rows at `positions` (CFG rows counted): 2 FLOPs
    per active weight per row and each layer's latent attention at the
    row's position."""
    positions = list(positions)
    return (2 * active_params(c) * len(positions)
            + c["num_hidden_layers"] * k6_flops(positions, c))
