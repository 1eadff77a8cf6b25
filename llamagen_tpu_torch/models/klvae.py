"""KL-regularised autoencoder (SD-VAE / AutoencoderKL), the baseline
tokenizer of the comparison rig (PyTorch port of
`llamagen_tpu/models/klvae.py`).

The Stable Diffusion VAE that upstream LlamaGen compares against through
diffusers (`tokenizer/vae/reconstruction_vae_ddp.py`): the LDM conv
backbone, built from the VQ tokenizer's blocks (`models/vq.py`:
`ResnetBlock`, `AttnBlock`, `Downsample`, `Upsample`, GroupNorm eps 1e-6
in f32), with a diagonal-Gaussian latent instead of a codebook. Keys are
the LDM layout (`encoder.down.{i}.block.{j}`, `encoder.mid.block_1` /
`attn_1` / `block_2`, `decoder.up.{level}` with level 0 the highest
resolution, `quant_conv`, `post_quant_conv`); a diffusers checkpoint
loads through `utils/convert.py::sd_vae_state_dict`.

Against `models/vq.py`: the encoder emits 2 * z_channels (mean ‖ logvar,
`double_z`); attention only in the mid blocks (SD's attn_resolutions =
[]); quant_conv 2z -> 2 * embed_dim, post_quant_conv embed_dim -> z.
Images and latents are NHWC at the interfaces, as in `models/vq.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.models.vq import (AttnBlock, Conv2d, Downsample,
                                          GroupNorm, ResnetBlock, Upsample,
                                          _init_modules)


@dataclass(frozen=True)
class KLVAEConfig:
    """SD-VAE geometry (stabilityai/sd-vae-ft-*: f8, 4-channel latent)."""
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    scaling_factor: float = 0.18215

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


def _conv3(cin: int, cout: int, **kw) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, **kw)


class Mid(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, **kw)
        self.attn_1 = AttnBlock(c, **kw)
        self.block_2 = ResnetBlock(c, c, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


def _level(cin: int, cout: int, n: int, **kw) -> Tuple[nn.Module, int]:
    level = nn.Module()
    level.block = nn.ModuleList()
    for _ in range(n):
        level.block.append(ResnetBlock(cin, cout, **kw))
        cin = cout
    return level, cout


def _blocks(level: nn.Module, h: torch.Tensor) -> torch.Tensor:
    for block in level.block:
        h = block(h)
    return h


class Encoder(nn.Module):
    """NCHW [B, 3, H, W] -> [B, 2 * z_channels, H / f, W / f] moments."""

    def __init__(self, cfg: KLVAEConfig, **kw):
        super().__init__()
        self.conv_in = _conv3(3, cfg.ch, **kw)
        self.down = nn.ModuleList()
        c = cfg.ch
        for i, m in enumerate(cfg.ch_mult):
            level, c = _level(c, cfg.ch * m, cfg.num_res_blocks, **kw)
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(c, **kw)
            self.down.append(level)
        self.mid = Mid(c, **kw)
        self.norm_out = GroupNorm(c, **kw)
        self.conv_out = _conv3(c, 2 * cfg.z_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = _blocks(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """NCHW latents [B, z, h, w] -> images [B, 3, H, W]; `up[level]` is
    the level's blocks (0 the highest resolution), applied from the
    lowest."""

    def __init__(self, cfg: KLVAEConfig, **kw):
        super().__init__()
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv3(cfg.z_channels, c, **kw)
        self.mid = Mid(c, **kw)
        levels = []
        for i in reversed(range(len(cfg.ch_mult))):
            level, c = _level(c, cfg.ch * cfg.ch_mult[i],
                              cfg.num_res_blocks + 1, **kw)
            if i != 0:
                level.upsample = Upsample(c, **kw)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(c, **kw)
        self.conv_out = _conv3(c, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = _blocks(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: KLVAEConfig = KLVAEConfig(), device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1,
                                 **kw)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1,
                                      **kw)

    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images NHWC in [-1, 1] -> (mean, logvar), each [B, h, w,
        embed_dim]; logvar clamped to [-30, 20] (diffusers'
        DiagonalGaussianDistribution)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from `generator` or given."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents NHWC [B, h, w, embed_dim] -> images NHWC."""
        h = self.post_quant_conv(z.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    @torch.no_grad()
    def roundtrip(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """encode -> (sample | mean) -> decode: the mean without a
        generator or noise (the deterministic variant, for metric
        stability). The 0.18215 scaling cancels in a roundtrip."""
        mean, logvar = self.encode(x)
        if generator is None and noise is None:
            return self.decode(mean)
        return self.decode(self.sample(mean, logvar, generator, noise))


@torch.no_grad()
def init_weights(model: AutoencoderKL, seed: int = 0) -> AutoencoderKL:
    """Seeded random weights in `models/vq.py`'s scheme (convs uniform
    with bound sqrt(3 / fan_in), unit GroupNorms)."""
    g = torch.Generator(device=model.quant_conv.weight.device)
    g.manual_seed(seed)
    _init_modules(model, g)
    return model
