"""Consistency decoder (openai/consistency-decoder), the second baseline
tokenizer of the comparison rig (PyTorch port of
`llamagen_tpu/models/consistency_decoder.py`).

OpenAI's distilled consistency model that replaces the SD-VAE's conv
decoder, as upstream LlamaGen compares against it through diffusers
(`tokenizer/consistencydecoder/reconstruction_cd_ddp.py`): the published
`ConvUNetVAE`, a conv-only guided-diffusion U-Net (a learned timestep
table + MLP, scale-shift time conditioning in every ConvResblock, skip
concatenations, channels 320 * (1, 1, 2, 3, 4) per stage), under its
state-dict keys (`embed_image.f`, `embed_time.{emb,f_1,f_2}`,
`down.{i}.{j}.{f_t,gn_1,f_1,gn_2,f_2[,f_s]}` with a stride-2 `.f` after
each stage but the last, `mid.{0,1}`, `up.{k}.{j}` in application order
with an upsampling `.f` after each but the last, `output.{gn,f}`).
`decode_latent` is the 2-step consistency sampler in the VP
parameterisation (c_skip / c_out / c_in with sigma_data 0.5, the cosine
alpha-bar schedule of `schedule_tables`).

The encoder side is the SD-VAE's (`models/klvae.py`), as diffusers'
ConsistencyDecoderVAE composes them. Images are NHWC at the interfaces;
GroupNorm (32 groups, eps 1e-5) computes in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.models.vq import Conv2d


@dataclass(frozen=True)
class CDConfig:
    in_channels: int = 7          # 3 noisy image + 4 nearest-up latent
    base_ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 1, 2, 3, 4)
    layers_per_block: int = 3
    time_embed_dim: int = 1280
    n_timesteps: int = 1024
    sigma_data: float = 0.5
    latent_scale: int = 8         # nearest-upsample factor of the latent


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps=1e-5) with f32 statistics, result in x's dtype."""

    def __init__(self, channels: int, **kw):
        super().__init__(32, channels, eps=1e-5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ConvResblock(nn.Module):
    """h = f_1(silu(gn_1(x))); h = gn_2(h) * (1 + t_s) + t_b;
    out = f_2(silu(h)) + (f_s(x) or x)."""

    def __init__(self, cin: int, cout: int, temb: int, **kw):
        super().__init__()
        self.f_t = nn.Linear(temb, 2 * cout, **kw)
        self.gn_1 = GroupNorm(cin, **kw)
        self.f_1 = Conv2d(cin, cout, 3, padding=1, **kw)
        self.gn_2 = GroupNorm(cout, **kw)
        self.f_2 = Conv2d(cout, cout, 3, padding=1, **kw)
        self.f_s = Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        skip = x if self.f_s is None else self.f_s(x)
        t = self.f_t(F.silu(temb))
        t_scale, t_shift = t.to(x.dtype)[:, :, None, None].chunk(2, dim=1)
        h = self.f_1(F.silu(self.gn_1(x)))
        h = self.gn_2(h) * (1.0 + t_scale) + t_shift
        return self.f_2(F.silu(h)) + skip


class _Conv(nn.Module):
    """A module holding one conv as `.f` (the published layout's
    embed_image, Downsample and Upsample)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, **kw):
        super().__init__()
        self.f = Conv2d(cin, cout, 3, stride=stride, padding=1, **kw)


class TimeEmbedding(nn.Module):
    def __init__(self, cfg: CDConfig, **kw):
        super().__init__()
        self.emb = nn.Embedding(cfg.n_timesteps, cfg.base_ch, **kw)
        self.f_1 = nn.Linear(cfg.base_ch, cfg.time_embed_dim, **kw)
        self.f_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim, **kw)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.f_2(F.silu(self.f_1(self.emb(t))))


class ConvUNetVAE(nn.Module):
    """x [B, H, W, in_channels] (noisy image ‖ upsampled latent), t [B]
    int timesteps -> [B, H, W, 3]."""

    def __init__(self, cfg: CDConfig = CDConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        te = cfg.time_embed_dim
        lpb = cfg.layers_per_block
        self.embed_image = _Conv(cfg.in_channels, chs[0], **kw)
        self.embed_time = TimeEmbedding(cfg, **kw)
        self.down = nn.ModuleList()
        cin = chs[0]
        for i, c in enumerate(chs):
            mods = []
            for _ in range(lpb):
                mods.append(ConvResblock(cin, c, te, **kw))
                cin = c
            if i != len(chs) - 1:
                mods.append(_Conv(c, c, stride=2, **kw))
            self.down.append(nn.ModuleList(mods))
        self.mid = nn.ModuleList([ConvResblock(cin, cin, te, **kw),
                                  ConvResblock(cin, cin, te, **kw)])
        self.up = nn.ModuleList()
        for i, c in reversed(list(enumerate(chs))):
            mods = []
            for j in range(lpb + 1):
                # the last pop is the previous stage's downsample output
                # (embed_image's at the top)
                skip_c = c if j < lpb else chs[max(i - 1, 0)]
                mods.append(ConvResblock(cin + skip_c, c, te, **kw))
                cin = c
            if i != 0:
                mods.append(_Conv(c, c, **kw))
            self.up.append(nn.ModuleList(mods))
        self.output = nn.Module()
        self.output.gn = GroupNorm(chs[0], **kw)
        self.output.f = Conv2d(chs[0], 3, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = self.embed_time(t)
        h = self.embed_image.f(x.permute(0, 3, 1, 2))
        skips = [h]
        for level in self.down:
            for m in level:
                h = m(h, temb) if isinstance(m, ConvResblock) else m.f(h)
                skips.append(h)
        for m in self.mid:
            h = m(h, temb)
        for level in self.up:
            for m in level:
                if isinstance(m, ConvResblock):
                    h = m(torch.cat([h, skips.pop()], dim=1), temb)
                else:
                    h = m.f(F.interpolate(h, scale_factor=2.0,
                                          mode="nearest"))
        assert not skips
        out = self.output.f(F.silu(self.output.gn(h)))
        return out.permute(0, 2, 3, 1)


def schedule_tables(cfg: CDConfig) -> Dict[str, np.ndarray]:
    """Cosine alpha-bar schedule + consistency c_skip/c_out/c_in tables
    (f32, as the JAX package holds them)."""
    n = cfg.n_timesteps
    ab = np.array([math.cos((i / n + 0.008) / 1.008 * math.pi / 2) ** 2
                   for i in range(n + 1)])
    betas = np.clip(1.0 - ab[1:] / ab[:-1], 0, 0.999)
    acum = np.cumprod(1.0 - betas)
    sqrt_acum = np.sqrt(acum)
    sqrt_1m = np.sqrt(1.0 - acum)
    sigmas = sqrt_1m / sqrt_acum
    sd = cfg.sigma_data
    c_skip = (1.0 / sqrt_acum) * sd ** 2 / (sigmas ** 2 + sd ** 2)
    c_out = sigmas * sd / np.sqrt(sigmas ** 2 + sd ** 2)
    c_in = (1.0 / sqrt_acum) / np.sqrt(sigmas ** 2 + sd ** 2)
    return {k: np.asarray(v, np.float32)
            for k, v in dict(sqrt_acum=sqrt_acum, sqrt_1m=sqrt_1m,
                             c_skip=c_skip, c_out=c_out, c_in=c_in).items()}


@torch.no_grad()
def decode_latent(model: ConvUNetVAE, latent: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None,
                  timesteps: Sequence[int] = (1008, 512)) -> torch.Tensor:
    """2-step consistency decode: latent [B, h, w, 4] -> image [B, H, W, 3]
    in [-1, 1], f32. The draws (the start noise, then one per later step,
    each [B, H, W, 3]) come from `generator` or are given as `noise`.
    `timesteps` defaults to the 64-step distillation grid's (1.0, 0.5)
    schedule points."""
    cfg = model.cfg
    tabs = schedule_tables(cfg)
    b, h, w, _ = latent.shape
    shape = (b, h * cfg.latent_scale, w * cfg.latent_scale, 3)
    if noise is None:
        noise = [torch.randn(shape, generator=generator,
                             device=latent.device)
                 for _ in timesteps]
    lat_up = latent.repeat_interleave(cfg.latent_scale, dim=1) \
        .repeat_interleave(cfg.latent_scale, dim=2)
    dtype = model.output.f.weight.dtype
    x = noise[0].float() * float(tabs["sqrt_1m"][timesteps[0]])
    for i, t in enumerate(timesteps):
        tt = torch.full((b,), t, dtype=torch.long, device=latent.device)
        inp = torch.cat([x * float(tabs["c_in"][t]), lat_up.float()],
                        dim=-1)
        out = model(inp.to(dtype), tt).float()
        x0 = (float(tabs["c_out"][t]) * out
              + float(tabs["c_skip"][t]) * x).clamp(-1.0, 1.0)
        if i + 1 < len(timesteps):
            t_next = timesteps[i + 1]
            x = x0 * float(tabs["sqrt_acum"][t_next]) \
                + noise[i + 1].float() * float(tabs["sqrt_1m"][t_next])
    return x0


@torch.no_grad()
def init_weights(model: ConvUNetVAE, seed: int = 0) -> ConvUNetVAE:
    """Seeded random weights in the JAX package's scheme (`init_params`):
    convs and linears normal / sqrt(fan_in) with zero biases, the time
    table normal * 0.02, unit GroupNorms."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           / math.sqrt(fan))
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.02)
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()
    return model
