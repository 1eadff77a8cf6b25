"""VQ-VAE image tokenizer in PyTorch.

Counterpart of `llamagen_tpu/models/vq.py` (`encode`, `quantize`,
`decode`, `decode_code`, `forward`) with the upstream VQModel keys
(`encoder.*`, `quant_conv.*`, `quantize.embedding.weight`,
`post_quant_conv.*`, `decoder.*`). Inside it runs NCHW convolutions; at its
interfaces images and latents are NHWC ([B, H, W, 3], [B, h, w, e_dim]),
the JAX package's layout, and token ids [B, h, w]. GroupNorm (32 groups,
eps 1e-6) computes in f32; the quantizer's distances, losses and
straight-through estimator too. `VQModel(cfg)` holds the decode half only
(what sampling needs, loaded from `decode_half`); `VQModel(cfg,
encoder=True)` the whole model.

Convolutions compute in their input's dtype (`Conv2d` casts its weight
and bias at each call, as JAX casts every kernel), so a bf16 forward runs
over f32 master weights (VQ-GAN training). For training, `remat`
checkpoints every residual and attention block (`torch.utils.checkpoint`,
non-reentrant), and each residual block draws its dropout mask from a
fresh generator seeded with a seed drawn before the block loop: a
recomputed block draws the same mask, as JAX's `fold_in(rng, i)` keys do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from llamagen_tpu_torch.config import VQConfig

DECODE_PREFIXES = ("decoder.", "post_quant_conv.", "quantize.embedding.")
Losses = Dict[str, torch.Tensor]


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6) with f32 statistics, result in x's dtype."""

    def __init__(self, channels: int, **kw):
        super().__init__(32, channels, eps=1e-6, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` in its input's dtype: the weight and bias are cast to
    x's dtype at each call (a no-op when they already are)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv3(cin: int, cout: int, **kw) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, **kw)


def _block_seeds(n: int, generator: Optional[torch.Generator]
                 ) -> List[Optional[int]]:
    """One dropout seed per residual block, drawn from `generator` before
    the blocks run (None each without a generator)."""
    if generator is None:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def maybe_checkpoint(remat: bool, fn, *args):
    """fn(*args), checkpointed (non-reentrant) with `remat`."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ResnetBlock(nn.Module):
    """Pre-norm residual conv block. With a `seed` (training) and
    `dropout_p` > 0, dropout between the second swish and conv2, the
    upstream placement (JAX `resnet_block`), its mask drawn from a fresh
    generator seeded with `seed` on x's device."""

    def __init__(self, cin: int, cout: int, dropout_p: float = 0.0, **kw):
        super().__init__()
        self.dropout_p = dropout_p
        self.norm1 = GroupNorm(cin, **kw)
        self.conv1 = _conv3(cin, cout, **kw)
        self.norm2 = GroupNorm(cout, **kw)
        self.conv2 = _conv3(cout, cout, **kw)
        self.nin_shortcut = Conv2d(cin, cout, 1, **kw) \
            if cin != cout else None

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = F.silu(self.norm2(h))
        p = self.dropout_p
        if seed is not None and p > 0:
            g = torch.Generator(device=h.device).manual_seed(seed)
            keep = torch.rand(h.shape, generator=g, device=h.device) \
                < 1.0 - p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the HW positions, on [B, HW, C]."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, **kw)
        self.q, self.k, self.v, self.proj_out = (
            Conv2d(c, c, 1, **kw) for _ in range(4))

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


class Downsample(nn.Module):
    """Stride-2 3x3 conv after a pad of one row at the bottom and one
    column at the right only (upstream's asymmetric (0, 1, 0, 1) pad)."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.pad's order: W left, W right, H top, H bottom
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    """NCHW [B, 3, H, W] -> [B, z_channels, H / f, W / f] (JAX
    `encoder_apply`): conv_in, per level `num_res_blocks` residual blocks
    (attention after each on the last level) and a downsample on all but
    the last, mid (res, attn, res), GroupNorm, swish, conv_out."""

    def __init__(self, cfg: VQConfig, **kw):
        super().__init__()
        mult = cfg.encoder_ch_mult
        n = len(mult)
        p = cfg.dropout_p
        self.conv_in = _conv3(3, cfg.ch, **kw)
        self.conv_blocks = nn.ModuleList()
        block_in = cfg.ch
        for i in range(n):
            block = nn.Module()
            block.res, block.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * mult[i]
            for _ in range(cfg.num_res_blocks):
                block.res.append(ResnetBlock(block_in, block_out, p, **kw))
                block_in = block_out
                if i == n - 1:
                    block.attn.append(AttnBlock(block_in, **kw))
            if i != n - 1:
                block.downsample = Downsample(block_in, **kw)
            self.conv_blocks.append(block)
        self.mid = nn.ModuleList([ResnetBlock(block_in, block_in, p, **kw),
                                  AttnBlock(block_in, **kw),
                                  ResnetBlock(block_in, block_in, p, **kw)])
        self.norm_out = GroupNorm(block_in, **kw)
        self.conv_out = _conv3(block_in, cfg.z_channels, **kw)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """With `generator`, dropout in the residual blocks (one seed each,
        in call order, mid last); with `remat`, every block checkpointed."""
        n_res = sum(len(b.res) for b in self.conv_blocks) + 2
        seeds = iter(_block_seeds(n_res, generator))
        h = self.conv_in(x)
        for block in self.conv_blocks:
            for j, res in enumerate(block.res):
                h = maybe_checkpoint(remat, res, h, next(seeds))
                if len(block.attn):
                    h = maybe_checkpoint(remat, block.attn[j], h)
            if hasattr(block, "downsample"):
                h = block.downsample(h)
        h = maybe_checkpoint(remat, self.mid[0], h, next(seeds))
        h = maybe_checkpoint(remat, self.mid[1], h)
        h = maybe_checkpoint(remat, self.mid[2], h, next(seeds))
        return self.conv_out(F.silu(self.norm_out(h)))


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
        p = cfg.dropout_p
        block_in = cfg.ch * mult[-1]
        self.conv_in = _conv3(cfg.z_channels, block_in, **kw)
        self.mid = nn.ModuleList([ResnetBlock(block_in, block_in, p, **kw),
                                  AttnBlock(block_in, **kw),
                                  ResnetBlock(block_in, block_in, p, **kw)])
        self.conv_blocks = nn.ModuleList()
        for i in range(n):  # application order: lowest resolution first
            block = nn.Module()
            block.res, block.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * mult[n - 1 - i]
            for _ in range(cfg.num_res_blocks + 1):
                block.res.append(ResnetBlock(block_in, block_out, p, **kw))
                block_in = block_out
                if i == 0:
                    block.attn.append(AttnBlock(block_in, **kw))
            if i != n - 1:
                block.upsample = Upsample(block_in, **kw)
            self.conv_blocks.append(block)
        self.norm_out = GroupNorm(block_in, **kw)
        self.conv_out = _conv3(block_in, 3, **kw)

    def forward(self, z: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """As `Encoder.forward` (the seeds in call order, mid first)."""
        n_res = sum(len(b.res) for b in self.conv_blocks) + 2
        seeds = iter(_block_seeds(n_res, generator))
        h = self.conv_in(z)
        h = maybe_checkpoint(remat, self.mid[0], h, next(seeds))
        h = maybe_checkpoint(remat, self.mid[1], h)
        h = maybe_checkpoint(remat, self.mid[2], h, next(seeds))
        for block in self.conv_blocks:
            for j, res in enumerate(block.res):
                h = maybe_checkpoint(remat, res, h, next(seeds))
                if len(block.attn):
                    h = maybe_checkpoint(remat, block.attn[j], h)
            if hasattr(block, "upsample"):
                h = block.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Codebook(nn.Module):
    def __init__(self, cfg: VQConfig, **kw):
        super().__init__()
        self.embedding = nn.Embedding(cfg.codebook_size,
                                      cfg.codebook_embed_dim, **kw)


def normalized_codebook(weight: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """The codebook in f32, each row divided by its l2 norm when the config
    says so (a division, as JAX's; `F.normalize` clamps the norm)."""
    emb = weight.float()
    if cfg.codebook_l2_norm:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


def compute_entropy_loss(affinity: torch.Tensor,
                         temperature: float = 0.01,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """Codebook-entropy regulariser (JAX `compute_entropy_loss`): the mean
    per-sample entropy of softmax(affinity / T) less the entropy of the
    batch's average distribution. With a process `group` the average is
    over the global batch (a differentiable all-reduce of the sums), as
    JAX's sharded step takes it; the per-sample term stays this rank's
    mean, which the ranks' gradient mean averages."""
    flat = affinity.reshape(-1, affinity.shape[-1]) / temperature
    probs = torch.softmax(flat, dim=-1)
    log_probs = torch.log_softmax(flat + 1e-5, dim=-1)
    if group is None:
        avg_probs = probs.mean(dim=0)
    else:
        count = flat.shape[0] * dist.get_world_size(group)
        avg_probs = dist_fn.all_reduce(probs.sum(dim=0), group=group) / count
    avg_entropy = -(avg_probs * torch.log(avg_probs + 1e-5)).sum()
    sample_entropy = -(probs * log_probs).sum(dim=-1).mean()
    return sample_entropy - avg_entropy


def quantize(weight: torch.Tensor, z: torch.Tensor, cfg: VQConfig,
             train: bool = False,
             group: Optional[dist.ProcessGroup] = None
             ) -> Tuple[torch.Tensor, Losses, torch.Tensor]:
    """Nearest-codebook quantisation with the straight-through estimator
    (JAX `quantize`). weight: the codebook [n, e_dim]; z: [B, h, w, e_dim]
    after quant_conv. Returns (z_q in z's dtype, losses, ids [B, h, w]).

    In f32: z (and the codebook) l2-normalised by division, distances in
    the expanded form ||z||^2 + ||e||^2 - 2 z.e, the first index of the
    minimum. With `train`, the losses `vq` (codebook toward z), `commit`
    (beta * z toward the codebook) and `entropy` (ratio * the entropy loss
    of -distances, over the global batch of `group`'s ranks); otherwise
    {}."""
    zf = z.float()
    if cfg.codebook_l2_norm:
        zf = zf / torch.linalg.vector_norm(zf, dim=-1, keepdim=True)
    emb = normalized_codebook(weight, cfg)
    flat = zf.reshape(-1, cfg.codebook_embed_dim)
    d = ((flat ** 2).sum(dim=1, keepdim=True) + (emb ** 2).sum(dim=1)
         - 2.0 * flat @ emb.t())
    idx = torch.argmin(d, dim=1)
    z_q = emb[idx].reshape(zf.shape)
    losses: Losses = {}
    if train:
        losses = {
            "vq": ((z_q - zf.detach()) ** 2).mean(),
            "commit": cfg.commit_loss_beta
            * ((z_q.detach() - zf) ** 2).mean(),
            "entropy": cfg.entropy_loss_ratio * compute_entropy_loss(
                -d, group=group if cfg.entropy_loss_ratio > 0 else None)}
    z_q = zf + (z_q - zf).detach()
    return z_q.to(z.dtype), losses, idx.reshape(z.shape[:-1])


class VQModel(nn.Module):
    """The upstream VQModel: the decode half (decoder, post_quant_conv, the
    codebook), and with `encoder` the encoder and quant_conv too."""

    def __init__(self, cfg: VQConfig, device=None, dtype=None,
                 encoder: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.decoder = Decoder(cfg, **kw)
        self.post_quant_conv = Conv2d(cfg.codebook_embed_dim,
                                      cfg.z_channels, 1, **kw)
        self.quantize = Codebook(cfg, **kw)
        self.encoder = self.quant_conv = None
        if encoder:
            self.encoder = Encoder(cfg, **kw)
            self.quant_conv = Conv2d(cfg.z_channels,
                                     cfg.codebook_embed_dim, 1, **kw)

    def codebook_lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [...] -> f32 embeddings [..., e_dim], l2-normalised when
        the config says so."""
        return normalized_codebook(self.quantize.embedding.weight,
                                   self.cfg)[indices]

    def encode(self, x: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None,
               remat: bool = False,
               group: Optional[dist.ProcessGroup] = None
               ) -> Tuple[torch.Tensor, Losses, torch.Tensor]:
        """Images NHWC [B, H, W, 3] in [-1, 1] -> (z_q [B, h, w, e_dim],
        losses, ids [B, h, w]), computed in x's dtype. Dropout runs only
        with `train` and a `generator`; `remat` checkpoints the blocks;
        `group` makes the entropy loss the global batch's (`quantize`)."""
        if self.encoder is None:
            raise ValueError("this VQModel holds the decode half only "
                             "(VQModel(cfg, encoder=True) for encode)")
        gen = generator if train else None
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2), gen, remat))
        return quantize(self.quantize.embedding.weight,
                        h.permute(0, 2, 3, 1), self.cfg, train, group)

    def decode(self, z_q: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               remat: bool = False) -> torch.Tensor:
        """Quantised latents NHWC [B, h, w, e_dim] -> images NHWC, in
        z_q's dtype."""
        h = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        return self.decoder(h, generator, remat).permute(0, 2, 3, 1)

    @torch.no_grad()
    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Token ids [B, h, w] -> images NHWC [B, H, W, 3]."""
        z = self.codebook_lookup(indices).to(self.post_quant_conv.weight.dtype)
        return self.decode(z)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None,
                remat: bool = False,
                group: Optional[dist.ProcessGroup] = None
                ) -> Tuple[torch.Tensor, Losses, torch.Tensor]:
        """Encode and decode: (reconstruction NHWC, losses, ids). The
        encoder draws its dropout seeds from `generator` first, then the
        decoder."""
        z_q, losses, idx = self.encode(x, train, generator, remat, group)
        return (self.decode(z_q, generator if train else None, remat),
                losses, idx)


def decode_half(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of a full VQModel state dict that a decode-only
    `VQModel` holds."""
    return {k: v for k, v in state_dict.items()
            if k.startswith(DECODE_PREFIXES)}


def _init_modules(module: nn.Module, g: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            bound = (m.weight[0].numel()) ** -0.5
            m.weight.uniform_(-3 ** 0.5 * bound, 3 ** 0.5 * bound, generator=g)
            m.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def init_weights(model: VQModel, seed: int = 0) -> VQModel:
    """Seeded random init in the JAX package's scheme: convs uniform with
    bound sqrt(3 / fan_in) and bias bound sqrt(1 / fan_in), unit norms, a
    uniform(+-1/n) codebook. The decode half is drawn first, so it is the
    same with or without the encoder."""
    g = torch.Generator(device=model.post_quant_conv.weight.device)
    g.manual_seed(seed)
    _init_modules(model.decoder, g)
    _init_modules(model.post_quant_conv, g)
    n = model.cfg.codebook_size
    model.quantize.embedding.weight.uniform_(-1.0 / n, 1.0 / n, generator=g)
    if model.encoder is not None:
        _init_modules(model.encoder, g)
        _init_modules(model.quant_conv, g)
    return model
