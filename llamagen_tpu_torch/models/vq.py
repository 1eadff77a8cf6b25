"""VQ-VAE image tokenizer: the decode half, in PyTorch.

Counterpart of `llamagen_tpu/models/vq.py::decode_code` with the upstream
VQModel keys (`decoder.*`, `post_quant_conv.*`, `quantize.embedding.weight`).
Inside it runs NCHW convolutions; `decode_code` takes token ids [B, h, w]
and returns NHWC images [B, H, W, 3], the JAX package's layout. GroupNorm
(32 groups, eps 1e-6) computes in f32. The encoder, `quantize` and the
losses are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.config import VQConfig

DECODE_PREFIXES = ("decoder.", "post_quant_conv.", "quantize.embedding.")


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6) with f32 statistics, result in x's dtype."""

    def __init__(self, channels: int, **kw):
        super().__init__(32, channels, eps=1e-6, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _conv3(cin: int, cout: int, **kw) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.norm1 = GroupNorm(cin, **kw)
        self.conv1 = _conv3(cin, cout, **kw)
        self.norm2 = GroupNorm(cout, **kw)
        self.conv2 = _conv3(cout, cout, **kw)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1, **kw) \
            if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the HW positions, on [B, HW, C]."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, **kw)
        self.q, self.k, self.v, self.proj_out = (
            nn.Conv2d(c, c, 1, **kw) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        hn = self.norm(x)

        def seq(conv):  # [B, C, H, W] -> [B, HW, C]
            return conv(hn).flatten(2).transpose(1, 2)

        q, k, v = seq(self.q), seq(self.k), seq(self.v)
        attn = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * c ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.conv = _conv3(c, c, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Decoder(nn.Module):
    def __init__(self, cfg: VQConfig, **kw):
        super().__init__()
        mult = cfg.decoder_ch_mult
        n = len(mult)
        block_in = cfg.ch * mult[-1]
        self.conv_in = _conv3(cfg.z_channels, block_in, **kw)
        self.mid = nn.ModuleList([ResnetBlock(block_in, block_in, **kw),
                                  AttnBlock(block_in, **kw),
                                  ResnetBlock(block_in, block_in, **kw)])
        self.conv_blocks = nn.ModuleList()
        for i in range(n):  # application order: lowest resolution first
            block = nn.Module()
            block.res, block.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * mult[n - 1 - i]
            for _ in range(cfg.num_res_blocks + 1):
                block.res.append(ResnetBlock(block_in, block_out, **kw))
                block_in = block_out
                if i == 0:
                    block.attn.append(AttnBlock(block_in, **kw))
            if i != n - 1:
                block.upsample = Upsample(block_in, **kw)
            self.conv_blocks.append(block)
        self.norm_out = GroupNorm(block_in, **kw)
        self.conv_out = _conv3(block_in, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for m in self.mid:
            h = m(h)
        for block in self.conv_blocks:
            for j, res in enumerate(block.res):
                h = res(h)
                if len(block.attn):
                    h = block.attn[j](h)
            if hasattr(block, "upsample"):
                h = block.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Codebook(nn.Module):
    def __init__(self, cfg: VQConfig, **kw):
        super().__init__()
        self.embedding = nn.Embedding(cfg.codebook_size,
                                      cfg.codebook_embed_dim, **kw)


class VQModel(nn.Module):
    """Decode half of the upstream VQModel."""

    def __init__(self, cfg: VQConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.decoder = Decoder(cfg, **kw)
        self.post_quant_conv = nn.Conv2d(cfg.codebook_embed_dim,
                                         cfg.z_channels, 1, **kw)
        self.quantize = Codebook(cfg, **kw)

    def codebook_lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [...] -> f32 embeddings [..., e_dim], l2-normalised when
        the config says so."""
        emb = self.quantize.embedding.weight.float()
        if self.cfg.codebook_l2_norm:
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb[indices]

    @torch.no_grad()
    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Token ids [B, h, w] -> images NHWC [B, H, W, 3]."""
        z = self.codebook_lookup(indices).to(self.post_quant_conv.weight.dtype)
        img = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return img.permute(0, 2, 3, 1)


def decode_half(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of a full VQModel state dict that `VQModel` holds."""
    return {k: v for k, v in state_dict.items()
            if k.startswith(DECODE_PREFIXES)}


@torch.no_grad()
def init_weights(model: VQModel, seed: int = 0) -> VQModel:
    """Seeded random init in the JAX package's scheme: convs uniform with
    bound sqrt(3 / fan_in) and bias bound sqrt(1 / fan_in), unit norms, a
    uniform(+-1/n) codebook."""
    g = torch.Generator(device=model.post_quant_conv.weight.device)
    g.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            bound = (m.weight[0].numel()) ** -0.5
            m.weight.uniform_(-3 ** 0.5 * bound, 3 ** 0.5 * bound, generator=g)
            m.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    n = model.cfg.codebook_size
    model.quantize.embedding.weight.uniform_(-1.0 / n, 1.0 / n, generator=g)
    return model
