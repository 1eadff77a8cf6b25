"""The operations and bytes that a cell's shapes and positions need, and
the card's peaks: the yardstick of every roofline and MFU the benchmark
reports. A kernel's share divides the least time these allow by the
kernel's device time, so a later kernel that does the same work is
judged against the same numbers. Each input byte is counted read once and
each output byte written once."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

# NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TAIL = 32  # the exact rows of an int8 cache


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations over peak and bytes over
    bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------------
# K1: decode attention over an int8 cache (one query row per cache row)
# ---------------------------------------------------------------------------


def k1_bytes(positions: Iterable[int], n_head: int, n_kv_head: int,
             head_dim: int, pads: Optional[Sequence[int]] = None) -> int:
    """Bytes one K1 call needs for rows at `positions` (bf16 q, out and the
    new k | v row; an int8 cache with bf16 row scales and a bf16 exact
    tail): int8 k and v rows [pad, bnd) with their two scales, tail rows
    [max(bnd, pad), pos) in bf16, q and the new row read, out and the
    new row's tail copy written, and at pos % 32 == 31 the 32 flushed
    rows written as int8 with their scales. bnd = 32 * (pos // 32)."""
    f, f_kv = n_head * head_dim, n_kv_head * head_dim
    total = 0
    for i, pos in enumerate(positions):
        pad = pads[i] if pads is not None else 0
        bnd = pos // TAIL * TAIL
        total += max(bnd - pad, 0) * (2 * f_kv + 2 * 2)
        total += max(pos - max(bnd, pad), 0) * 2 * f_kv * 2
        total += 2 * f + 2 * f_kv * 2          # q, new k | v (bf16)
        total += 2 * f + 2 * f_kv * 2          # out, the tail row
        if pos % TAIL == TAIL - 1:
            total += TAIL * (2 * f_kv + 2 * 2)
    return total


def k1_flops(positions: Iterable[int], n_head: int, head_dim: int,
             pads: Optional[Sequence[int]] = None) -> int:
    """q.k and p.v over keys [pad, pos]: 4 * H * D per key."""
    total = 0
    for i, pos in enumerate(positions):
        pad = pads[i] if pads is not None else 0
        total += 4 * n_head * head_dim * (pos + 1 - pad)
    return total


# ---------------------------------------------------------------------------
# K2: W8A16 matmul, x [M, K] bf16 @ int8 [K, N] with f32 column scales
# ---------------------------------------------------------------------------


def k2_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def k2_bytes(m: int, k: int, n: int) -> int:
    return k * n + 4 * n + 2 * m * k + 2 * m * n


def k2_bound_s(m: int, k: int, n: int) -> float:
    return bound_s(k2_flops(m, k, n), k2_bytes(m, k, n))


def layer_matmuls(c: Dict) -> Dict[str, tuple]:
    """(K, N) of one layer's matmuls and of the head."""
    d, f = c["dim"], c["ffn_hidden_dim"]
    qkv = (c["n_head"] + 2 * c["n_kv_head"]) * c["head_dim"]
    return {"wqkv": (d, qkv), "wo": (d, d), "w1": (d, f), "w3": (d, f),
            "w2": (f, d), "head": (d, c["vocab_size"])}


def decode_k2_bound_s(c: Dict, rows: int) -> float:
    """The K2 calls of one decode step at `rows` cache rows: five per
    layer and the int8 head."""
    mm = layer_matmuls(c)
    per_layer = sum(k2_bound_s(rows, *mm[n])
                    for n in ("wqkv", "wo", "w1", "w3", "w2"))
    return c["n_layer"] * per_layer + k2_bound_s(rows, *mm["head"])


def prefill_k2_bound_s(c: Dict, rows: int) -> float:
    """The K2 calls of one admission prefill over `rows` = 2A * T rows:
    the layers' five matmuls and the head at the 2A last positions."""
    mm = layer_matmuls(c)
    per_layer = sum(k2_bound_s(rows, *mm[n])
                    for n in ("wqkv", "wo", "w1", "w3", "w2"))
    pairs2 = rows // c["cls_token_num"]
    return c["n_layer"] * per_layer + k2_bound_s(pairs2, *mm["head"])


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------


def matmul_params(c: Dict) -> int:
    """Weights of the layers' matmuls and the head (what each token row
    multiplies by)."""
    mm = layer_matmuls(c)
    per_layer = sum(k * n for name, (k, n) in mm.items() if name != "head")
    return c["n_layer"] * per_layer + mm["head"][0] * mm["head"][1]


def decode_step_flops(c: Dict, positions: Iterable[int],
                      pads: Optional[Sequence[int]] = None) -> int:
    """One decode step of rows at `positions` (CFG rows counted): 2 FLOPs
    per weight per row and each layer's attention at its position."""
    positions = list(positions)
    return (2 * matmul_params(c) * len(positions)
            + c["n_layer"] * k1_flops(positions, c["n_head"], c["head_dim"],
                                      pads))


def prefill_flops(c: Dict, pads: Sequence[int]) -> int:
    """One admission prefill over len(pads) rows of T condition positions
    (the caption projection, the layers, causal attention over each row's
    valid keys, the head at the last position)."""
    t, d = c["cls_token_num"], c["dim"]
    mm = layer_matmuls(c)
    per_layer = sum(k * n for name, (k, n) in mm.items() if name != "head")
    cap = c.get("caption_dim", 0) * d + d * d
    total = 0
    for pad in pads:
        keys = sum(p + 1 - min(pad, p) for p in range(t))
        total += 2 * t * (c["n_layer"] * per_layer + cap)
        total += c["n_layer"] * 4 * c["n_head"] * c["head_dim"] * keys
        total += 2 * mm["head"][0] * mm["head"][1]
    return total


def n_params(c: Dict) -> int:
    """Every GPT parameter (embeddings, norms, the condition)."""
    from perfbench.weights import gpt_shapes
    total = 0
    for _, s in gpt_shapes(c):
        size = 1
        for x in s:
            size *= x
        total += size
    return total


def train_step_flops(c: Dict, batch: int) -> int:
    """6 * params * tokens of one step (attention and remat not counted),
    tokens = batch * (cls + block_size - 1) positions."""
    return 6 * n_params(c) * batch * (c["cls_token_num"] + c["block_size"]
                                      - 1)


# ---------------------------------------------------------------------------
# K4: causal training attention, [B, S, H, D] bf16
# ---------------------------------------------------------------------------


def k4_fwd_bytes(b: int, s: int, h: int, d: int) -> int:
    """q, k, v read, out written (bf16), the f32 log-sum-exp written."""
    return 4 * b * s * h * d * 2 + b * h * s * 4


def k4_bwd_bytes(b: int, s: int, h: int, d: int) -> int:
    """The whole backward: q, k, v, out, dout read, dq, dk, dv written
    (bf16), the log-sum-exp read."""
    return 8 * b * s * h * d * 2 + b * h * s * 4


def k4_dq_bytes(b: int, s: int, h: int, d: int) -> int:
    """One dq pass alone: q, k, v, out, dout read, dq written, the
    log-sum-exp and row sums read."""
    return 6 * b * s * h * d * 2 + 2 * b * h * s * 4


def k4_fwd_flops(b: int, s: int, h: int, d: int) -> int:
    """q.k and p.v over the causal half: 2 * 2 * B * H * D * S(S+1)/2."""
    return 2 * b * h * d * s * (s + 1)


def k4_bwd_flops(b: int, s: int, h: int, d: int) -> int:
    """dv, dp, dq, dk and the recomputed scores: 5 products over the
    causal half."""
    return 5 * b * h * d * s * (s + 1)


def k4_step_bound_s(b: int, s: int, h: int, d: int, layers: int) -> float:
    """One forward and one backward per layer."""
    shape = (b, s, h, d)
    return layers * (bound_s(k4_fwd_flops(*shape), k4_fwd_bytes(*shape))
                     + bound_s(k4_bwd_flops(*shape), k4_bwd_bytes(*shape)))
