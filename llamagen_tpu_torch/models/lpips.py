"""LPIPS perceptual distance (frozen VGG16 features + learned 1x1 heads).

Counterpart of `llamagen_tpu/models/lpips.py` under upstream LlamaGen's
keys (`tokenizer_image/lpips.py`): the scaling layer, VGG16's five relu
slices (`net.slice{n}.{i}.*`, torchvision's `features` indices), each
feature map divided by its channel norm (+ 1e-10), the squared difference
through a 1x1 head without bias (`lin{k}.model.1.weight`), the spatial
mean, and the sum over the slices. Images are NHWC in [-1, 1]; the network
runs in their dtype over its own weights. Upstream's dropout before each
head is inactive where upstream runs LPIPS (eval mode), so the port holds
an identity there.

Weights: `load_lpips` takes a torchvision `vgg16` state dict
(`features.{i}.*`) and the reference's `vgg.pth` (the five heads); neither
is in this repository, so `init_weights` gives a seeded random network of
the same shapes. The module is frozen (`requires_grad_(False)`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from llamagen_tpu_torch.models.vq import Conv2d, maybe_checkpoint

# VGG16 `features`: conv channels, "M" = 2x2 max pool; the five slices are
# torchvision indices [0, 4), [4, 9), [9, 16), [16, 23), [23, 30)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
SLICE_STARTS = (0, 4, 9, 16, 23, 30)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg_layers() -> List[nn.Module]:
    """torchvision's vgg16().features, ReLUs not in place, to index 29."""
    layers: List[nn.Module] = []
    cin = 3
    for item in VGG16_CFG:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [Conv2d(cin, item, 3, padding=1), nn.ReLU()]
            cin = item
    return layers


class VGG16Slices(nn.Module):
    """The five relu slices (relu1_2, relu2_2, relu3_3, relu4_3,
    relu5_3) as `slice1` ... `slice5`, keyed by torchvision's indices."""

    def __init__(self):
        super().__init__()
        layers = _vgg_layers()
        for n in range(5):
            s = nn.Sequential()
            for i in range(SLICE_STARTS[n], SLICE_STARTS[n + 1]):
                s.add_module(str(i), layers[i])
            setattr(self, f"slice{n + 1}", s)

    def forward(self, x: torch.Tensor, remat: bool = False
                ) -> List[torch.Tensor]:
        """NCHW -> the five feature maps; `remat` checkpoints each slice,
        so a backward holds one slice's internals at a time."""
        feats = []
        for n in range(1, 6):
            x = maybe_checkpoint(remat, getattr(self, f"slice{n}"), x)
            feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    """A slice's head: `model.1` is the 1x1 conv to one channel, no bias."""

    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), Conv2d(c, 1, 1, bias=False))


class LPIPS(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.net = VGG16Slices()
        for k, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))
        self.to(device)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """NHWC images x, y in [-1, 1] -> the distance per sample
        [B, 1, 1, 1], in their dtype (JAX `lpips`)."""
        def features(img):
            img = img.permute(0, 3, 1, 2)
            img = (img - self.shift.to(img.dtype)) / self.scale.to(img.dtype)
            return self.net(img, remat)

        total = 0.0
        for k, (fx, fy) in enumerate(zip(features(x), features(y))):
            nx = fx / (fx.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            ny = fy / (fy.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            val = getattr(self, f"lin{k}").model((nx - ny) ** 2)
            total = total + val.mean(dim=(2, 3), keepdim=True)
        return total

    def mean(self, x: torch.Tensor, y: torch.Tensor,
             remat: bool = False) -> torch.Tensor:
        """The batch mean in f32 of the per-sample distances."""
        return self.forward(x, y, remat).float().mean()


# torchvision indices of VGG16's 13 convolutions
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def slice_of(i: int) -> int:
    return next(n for n in range(1, 6) if i < SLICE_STARTS[n])


def _vgg_key(sd: Mapping[str, torch.Tensor], i: int, name: str) -> str:
    """The key of conv i's `name` in a torchvision (`features.{i}`), bare
    (`{i}`) or upstream-sliced (`slice{n}.{i}`) state dict, the layouts
    JAX `convert_vgg16_features` reads."""
    n = slice_of(i)
    for key in (f"features.{i}.{name}", f"{i}.{name}",
                f"slice{n}.{i}.{name}"):
        if key in sd:
            return key
    raise KeyError(f"VGG16 conv {i} ({name}) is not in the state dict")


def lpips_state_dict(vgg_sd: Mapping[str, torch.Tensor],
                     lins_sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A VGG16 features state dict (torchvision or sliced keys) and the
    reference's `vgg.pth` heads -> the `LPIPS` state dict."""
    sd = {}
    for i in VGG16_CONVS:
        for name in ("weight", "bias"):
            sd[f"net.slice{slice_of(i)}.{i}.{name}"] = \
                vgg_sd[_vgg_key(vgg_sd, i, name)]
    for k in range(5):
        sd[f"lin{k}.model.1.weight"] = lins_sd[f"lin{k}.model.1.weight"]
    return sd


def load_lpips(vgg_sd: Mapping[str, torch.Tensor],
               lins_sd: Mapping[str, torch.Tensor], device=None) -> LPIPS:
    """A frozen `LPIPS` from the two state dicts (every key required)."""
    model = LPIPS(device=device)
    model.load_state_dict(lpips_state_dict(vgg_sd, lins_sd))
    return model


@torch.no_grad()
def init_weights(model: LPIPS, seed: int = 0) -> LPIPS:
    """Seeded random weights in JAX's `init_params` scheme: convs uniform
    with bound sqrt(3 / fan_in), zero biases, heads |normal| * 0.1."""
    g = torch.Generator(device=model.shift.device).manual_seed(seed)
    for i in VGG16_CONVS:
        conv = getattr(model.net, f"slice{slice_of(i)}")._modules[str(i)]
        bound = conv.weight[0].numel() ** -0.5
        conv.weight.uniform_(-3 ** 0.5 * bound, 3 ** 0.5 * bound,
                             generator=g)
        conv.bias.zero_()
    for k in range(5):
        w = getattr(model, f"lin{k}").model[1].weight
        w.normal_(0.0, 1.0, generator=g).abs_().mul_(0.1)
    return model
