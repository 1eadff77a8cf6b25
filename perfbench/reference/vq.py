"""The plain reference of LlamaGen's VQ-16 encode (upstream `tokenizer/
tokenizer_image/vq_model.py`: Encoder, quant_conv, the l2-normalised
codebook lookup), float32, TF32 off, by the upstream state-dict keys. It
imports nothing of the program."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import gpt
from perfbench.reference.gpt import no_tf32


def _conv(w, key, x, stride=1, padding=None):
    k = w[key + ".weight"].float()
    pad = k.shape[-1] // 2 if padding is None else padding
    rnd = w.get("__round__")
    if rnd is not None:
        x, k = rnd(x), rnd(k)
    return F.conv2d(x, k, w[key + ".bias"].float(), stride, pad)


def _gn(w, key, x):
    return F.group_norm(x, 32, w[key + ".weight"].float(),
                        w[key + ".bias"].float(), eps=1e-6)


def _res(w, key, x):
    h = _conv(w, key + ".conv1", F.silu(_gn(w, key + ".norm1", x)))
    h = _conv(w, key + ".conv2", F.silu(_gn(w, key + ".norm2", h)))
    if key + ".nin_shortcut.weight" in w:
        x = _conv(w, key + ".nin_shortcut", x)
    return x + h


def _attn(w, key, x):
    b, c, hh, ww = x.shape
    hn = _gn(w, key + ".norm", x)

    def seq(name):
        return _conv(w, f"{key}.{name}", hn).flatten(2).transpose(1, 2)

    q, k, v = seq("q"), seq("k"), seq("v")
    a = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
    out = (a @ v).transpose(1, 2).reshape(b, c, hh, ww)
    return x + _conv(w, key + ".proj_out", out)


@torch.no_grad()
def encode_ids(w: Dict[str, torch.Tensor], vc: Dict,
               images: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Images [B, H, W, 3] in [-1, 1] -> code ids [B, (H / 16) ** 2]: the
    first index of the least squared distance (`distances`). `fp8`: the
    control, every convolution's inputs rounded to float8 e4m3."""
    if fp8:
        w = dict(w, __round__=gpt.fp8)
    return torch.argmin(distances(w, vc, images), dim=-1)


@torch.no_grad()
def distances(w: Dict[str, torch.Tensor], vc: Dict,
              images: torch.Tensor) -> torch.Tensor:
    """Images [B, H, W, 3] in [-1, 1] -> [B, (H / 16) ** 2, codebook]
    squared distances from each l2-normalised latent (the encoder,
    quant_conv) to each l2-normalised code."""
    no_tf32()
    mult = vc["encoder_ch_mult"]
    x = _conv(w, "encoder.conv_in", images.float().permute(0, 3, 1, 2))
    for i in range(len(mult)):
        key = f"encoder.conv_blocks.{i}"
        for j in range(vc["num_res_blocks"]):
            x = _res(w, f"{key}.res.{j}", x)
            if i == len(mult) - 1:
                x = _attn(w, f"{key}.attn.{j}", x)
        if i != len(mult) - 1:
            x = _conv(w, f"{key}.downsample.conv", F.pad(x, (0, 1, 0, 1)),
                      stride=2, padding=0)
    x = _res(w, "encoder.mid.0", x)
    x = _attn(w, "encoder.mid.1", x)
    x = _res(w, "encoder.mid.2", x)
    x = _conv(w, "encoder.conv_out", F.silu(_gn(w, "encoder.norm_out", x)))
    z = _conv(w, "quant_conv", x).permute(0, 2, 3, 1)
    z = z.reshape(z.shape[0], -1, z.shape[-1])
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    e = w["quantize.embedding.weight"].float()
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return (z ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1) \
        - 2.0 * z @ e.t()
