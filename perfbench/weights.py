"""Weights and inputs made from `--seed`, on the device, in a few large
calls: the benchmark's, handed alike to the program and to the reference.

GPT weights carry upstream's state-dict keys: normal(0, 0.02) matrices
and embeddings, the output head too (upstream zeroes it at init, and a
zero head makes every logit equal), unit norm weights, and for t2i the
null caption normal(0, caption_dim ** -0.5), as upstream's init. One
normal draw over all the matrices, cut into the leaves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02


def gpt_shapes(c: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every GPT parameter, in upstream's order, from a
    configuration file's sizes."""
    d, f, v = c["dim"], c["ffn_hidden_dim"], c["vocab_size"]
    qkv = (c["n_head"] + 2 * c["n_kv_head"]) * c["head_dim"]
    out = [("tok_embeddings.weight", (v, d))]
    if c["model_type"] == "c2i":
        out.append(("cls_embedding.embedding_table.weight",
                    (c["num_classes"] + 1, d)))
    else:
        out += [("cls_embedding.cap_proj.fc1.weight", (d, c["caption_dim"])),
                ("cls_embedding.cap_proj.fc2.weight", (d, d)),
                ("cls_embedding.uncond_embedding",
                 (c["cls_token_num"], c["caption_dim"]))]
    for i in range(c["n_layer"]):
        p = f"layers.{i}."
        out += [(p + "attention.wqkv.weight", (qkv, d)),
                (p + "attention.wo.weight", (d, d)),
                (p + "feed_forward.w1.weight", (f, d)),
                (p + "feed_forward.w3.weight", (f, d)),
                (p + "feed_forward.w2.weight", (d, f)),
                (p + "attention_norm.weight", (d,)),
                (p + "ffn_norm.weight", (d,))]
    out += [("norm.weight", (d,)), ("output.weight", (v, d))]
    return out


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of the seed (`stream` tells the
    uses apart); any seed up to 2**64."""
    mixed = np.random.SeedSequence([seed % 2 ** 64, stream]) \
        .generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


@torch.no_grad()
def gpt_weights(c: Dict, seed: int, device,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The GPT's weights for `seed`, in `dtype`, on `device`."""
    shapes = gpt_shapes(c)
    mats = [(k, s) for k, s in shapes if len(s) == 2
            and k != "cls_embedding.uncond_embedding"]
    n = sum(int(np.prod(s)) for _, s in mats)
    flat = torch.empty(n, dtype=dtype, device=device)
    flat.normal_(0.0, STD, generator=generator(seed, 0, device))
    out, at = {}, 0
    for k, s in mats:
        size = int(np.prod(s))
        out[k] = flat[at:at + size].view(s)
        at += size
    for k, s in shapes:
        if k == "cls_embedding.uncond_embedding":
            out[k] = torch.empty(s, dtype=dtype, device=device).normal_(
                0.0, c["caption_dim"] ** -0.5,
                generator=generator(seed, 1, device))
        elif len(s) == 1:
            out[k] = torch.ones(s, dtype=dtype, device=device)
    return {k: out[k] for k, _ in shapes}


@torch.no_grad()
def vq_weights(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """VQ weights for `seed` under upstream's keys: convolution kernels
    normal(0, fan_in ** -0.5), biases normal(0, 0.01), GroupNorm weights 1
    and biases 0, the codebook normal(0, 1) (it is l2-normalised in use);
    one normal draw over all of them, cut into the leaves."""
    n = sum(int(np.prod(s)) for k, s in shapes if not _is_norm(k))
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=generator(seed, 3, device))
    out, at = {}, 0
    for k, s in shapes:
        if _is_norm(k):
            fill = 1.0 if k.endswith("weight") else 0.0
            out[k] = torch.full(s, fill, dtype=dtype, device=device)
            continue
        size = int(np.prod(s))
        x = flat[at:at + size].view(s)
        at += size
        if len(s) == 4:
            x = x * (s[1] * s[2] * s[3]) ** -0.5
        elif k.endswith("bias"):
            x = x * 0.01
        out[k] = x.to(dtype)
    return out


def _is_norm(key: str) -> bool:
    return "norm" in key.rsplit(".", 2)[-2]
