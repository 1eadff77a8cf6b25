"""GAN discriminators for VQ-GAN training, in PyTorch.

Counterpart of `llamagen_tpu/models/discriminator.py` (`patchgan_apply`,
`stylegan_apply`) under upstream LlamaGen's keys: `PatchGAN` is the
pix2pix `NLayerDiscriminator` (`main.{i}.*`), `StyleGAN` the StyleGAN2-style
residual discriminator (`blocks.{i}.*`, `final_conv.0.*`,
`final_linear.{0,2}.*`). Both take NHWC images ([B, H, W, 3], the VQ's
layout) and run NCHW convolutions in the input's dtype over their own
(f32) weights. PatchGAN returns patch logits [B, h, w, 1], StyleGAN
logits [B, 1].

BatchNorm always normalises with the batch's own statistics (biased
variance, in f32, the result in x's dtype), as JAX's does: there is no eval
mode. Its running buffers exist only so that upstream checkpoints load.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.models.vq import Conv2d

_SLOPE = 0.2  # every leaky ReLU's negative slope
# StyleGAN channels per resolution (upstream `Discriminator.channels`)
STYLEGAN_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
                     256: 64, 512: 32, 1024: 16}


class Linear(nn.Linear):
    """`nn.Linear` in its input's dtype (weight and bias cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """Train-mode batch statistics over (N, H, W) in f32 with a biased
    variance, result in x's dtype; the running buffers are never read or
    written.

    Written out in JAX `_batch_norm`'s order (the mean, then the mean of
    the squared centred values) and differentiated by autograd."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None]).to(x.dtype)


def _leaky() -> nn.LeakyReLU:
    return nn.LeakyReLU(_SLOPE)


class PatchGAN(nn.Module):
    """Upstream `NLayerDiscriminator` at its defaults (3 input channels,
    ndf 64, 3 layers): a stride-2 4x4 conv and leaky ReLU, two stride-2
    (conv, BatchNorm, leaky) triples, one stride-1 triple, and a 1-channel
    4x4 conv (JAX `patchgan_apply`)."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device)
        ndf, n_layers = 64, 3
        seq = [Conv2d(3, ndf, 4, stride=2, padding=1, **kw), _leaky()]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            seq += [Conv2d(ndf * prev, ndf * mult, 4,
                           stride=2 if n < n_layers else 1, padding=1,
                           bias=False, **kw),
                    BatchNorm2d(ndf * mult, **kw), _leaky()]
        seq.append(Conv2d(ndf * mult, 1, 4, stride=1, padding=1, **kw))
        self.main = nn.Sequential(*seq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Blur(nn.Module):
    """3x3 binomial ([1, 2, 1] outer itself, / 16) depthwise blur with
    reflect padding (kornia `filter2d(normalized=True)`)."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("f", torch.tensor([1.0, 2.0, 1.0],
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        f = self.f.float()
        k = (f[:, None] * f[None, :] / f.sum() ** 2).to(x.dtype)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                        k.expand(c, 1, 3, 3), groups=c)


class DiscriminatorBlock(nn.Module):
    """Residual down block: a strided 1x1 conv on the shortcut; two 3x3
    convs with leaky ReLUs, the blur and a stride-2 3x3 conv on the main
    branch; their sum times 1 / sqrt(2).

    The scale is an f32 scalar, as JAX's NumPy scalar is: under a bf16
    forward the sum is promoted to f32 there, so every later block, the
    final conv and the linear layers run in f32, as JAX's do."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.conv_res = Conv2d(cin, cout, 1, stride=2, **kw)
        self.net = nn.Sequential(Conv2d(cin, cout, 3, padding=1, **kw),
                                 _leaky(),
                                 Conv2d(cout, cout, 3, padding=1, **kw),
                                 _leaky())
        self.downsample = nn.Sequential(
            Blur(**kw), Conv2d(cout, cout, 3, stride=2, padding=1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.conv_res(x)
        y = self.downsample(self.net(x))
        return (y + res).float() * (1.0 / math.sqrt(2.0))


class StyleGAN(nn.Module):
    """Upstream StyleGAN `Discriminator(image_size=...)` at its other
    defaults (3 input channels, channel multiplier 1): a 3x3 conv and leaky
    ReLU (`blocks.0`, `blocks.1`), one `DiscriminatorBlock` per halving
    down to 4 x 4, a 3x3 conv + leaky, the NCHW flatten and two linear
    layers (JAX `stylegan_apply`, whose NHWC flatten
    `stylegan_state_dict_from_jax` reorders)."""

    def __init__(self, image_size: int = 256, device=None):
        super().__init__()
        kw = dict(device=device)
        ch = STYLEGAN_CHANNELS
        log_size = int(math.log2(image_size))
        cin = ch[image_size]
        blocks = [Conv2d(3, cin, 3, padding=1, **kw), _leaky()]
        for i in range(log_size, 2, -1):
            cout = ch[2 ** (i - 1)]
            blocks.append(DiscriminatorBlock(cin, cout, **kw))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = nn.Sequential(
            Conv2d(cin, ch[4], 3, padding=1, **kw), _leaky())
        self.final_linear = nn.Sequential(
            Linear(ch[4] * 4 * 4, ch[4], **kw), _leaky(),
            Linear(ch[4], 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            h = block(h)
        h = self.final_conv(h)
        return self.final_linear(h.reshape(h.shape[0], -1))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in JAX's schemes. PatchGAN: convs normal(0,
    0.02), zero biases, BatchNorm scales normal(1, 0.02) and zero biases.
    StyleGAN: convs and linears uniform with bound sqrt(3 / fan_in),
    biases uniform with bound sqrt(1 / fan_in)."""
    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(seed)
    for m in model.modules():
        if isinstance(model, PatchGAN):
            if isinstance(m, Conv2d):
                m.weight.normal_(0.0, 0.02, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.normal_(1.0, 0.02, generator=g)
                m.bias.zero_()
        elif isinstance(m, (Conv2d, Linear)):
            bound = m.weight[0].numel() ** -0.5
            m.weight.uniform_(-3 ** 0.5 * bound, 3 ** 0.5 * bound,
                              generator=g)
            m.bias.uniform_(-bound, bound, generator=g)
    return model


def make_discriminator(disc_type: str = "patchgan", image_size: int = 256,
                       device=None, seed: int = 0) -> nn.Module:
    """A seeded PatchGAN or StyleGAN (JAX `init_discriminator`)."""
    if disc_type == "patchgan":
        return init_weights(PatchGAN(device=device), seed)
    if disc_type == "stylegan":
        return init_weights(StyleGAN(image_size=image_size, device=device),
                            seed)
    raise ValueError(f"unknown discriminator type {disc_type!r}")
