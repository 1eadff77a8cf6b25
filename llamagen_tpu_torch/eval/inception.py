"""InceptionV3 feature extractor for FID / sFID / IS, in PyTorch (the
port's counterpart of `llamagen_tpu/eval/inception.py`).

The FID variant of the network that pytorch-fid ports from the 2015
TensorFlow weights, under pytorch-fid's state-dict keys
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`, ...,
`fc.weight` [1008, 2048]): `pt_inception-2015-12-05-6726825d.pth` loads
with `load_state_dict`. BasicConv2d is conv (no bias) + BatchNorm (eps
1e-3, eval mode) + ReLU; the A, C and E blocks pool with a 3x3 stride-1
average that leaves the padding out of the count, except `Mixed_7c`,
which takes a 3x3 stride-1 max pool (pytorch-fid's FIDInceptionE_2); the
stem's max pools are VALID; the head is the 1008-way fc.

Outputs per image batch:
  pool3   [N, 2048]      FID features
  spatial [N, 17*17*7]   the first 7 channels of Mixed_6e in NHWC order
                         (sFID features, the ADM suite's mixed_6/conv)
  logits  [N, 1008]      for the Inception Score

Without weights the network is random (seeded): architecture and shape
checks only, the metric values are then meaningless.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Features = Tuple[np.ndarray, np.ndarray, np.ndarray]


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """`max_pool` marks pytorch-fid's FIDInceptionE_2 (Mixed_7c)."""

    def __init__(self, cin: int, max_pool: bool = False):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool
                  else _avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], dim=1)


class FIDInceptionV3(nn.Module):
    """x [N, 3, 299, 299] in [-1, 1] -> (pool3, spatial, logits)."""

    def __init__(self, num_logits: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.fc = nn.Linear(2048, num_logits)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = F.max_pool2d(h, 3, stride=2)
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h))
        h = F.max_pool2d(h, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            h = getattr(self, name)(h)
        # the sFID features in NHWC order, as the TF graph flattens them
        spatial = h[:, :7].permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(h)))
        pool3 = h.mean(dim=(2, 3))
        return pool3, spatial, self.fc(pool3)


@torch.no_grad()
def init_weights(model: FIDInceptionV3, seed: int = 0) -> FIDInceptionV3:
    """Seeded random weights in the JAX package's scheme (`init_params`):
    convs normal * sqrt(2 / fan_in), identity BatchNorm, fc normal * 0.01
    with a zero bias."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=g) * (2.0 / fan) ** 0.5
            m.weight.copy_(w)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    model.fc.weight.copy_(torch.randn(model.fc.weight.shape, generator=g)
                          * 0.01)
    model.fc.bias.zero_()
    return model


def preprocess(batch: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> f32 [N, 3, 299, 299] in [-1, 1]: bilinear with
    half-pixel centres, antialiased when it shrinks (JAX's
    `jax.image.resize(..., "bilinear")`)."""
    x = batch.permute(0, 3, 1, 2).float() / 255.0
    if x.shape[2] != 299 or x.shape[3] != 299:
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=True)
    return x * 2.0 - 1.0


class FeatureExtractor:
    """Batched pool3 / spatial / logits extraction from uint8 images, on
    `device` (the card by default). Features are f32; on the card cuDNN
    runs f32 convolutions in TF32 unless `torch.backends.cudnn.allow_tf32`
    is False (the evaluation CLIs set it False)."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 64, device="cuda"):
        self.device = torch.device(device)
        self.model = FIDInceptionV3()
        if weights_path:
            sd = torch.load(weights_path, map_location="cpu",
                            weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            self.model.load_state_dict(sd)
        else:
            print("WARNING: no inception weights — random network, "
                  "metric values are meaningless")
            init_weights(self.model)
        self.model.to(self.device).eval()
        self.batch_size = batch_size

    def features(self, images_uint8: np.ndarray) -> Features:
        """images [N, H, W, 3] uint8 -> (pool3, spatial, logits) numpy."""
        n = len(images_uint8)
        return self.features_from_batches(
            images_uint8[i:i + self.batch_size]
            for i in range(0, n, self.batch_size))

    @torch.no_grad()
    def features_from_batches(self, batches: Iterable[np.ndarray]
                              ) -> Features:
        """Streaming variant: consumes an iterator of uint8 [b, H, W, 3]
        batches, so only the features are ever resident, never the 50k
        decoded images."""
        outs = ([], [], [])
        for batch in batches:
            x = torch.from_numpy(np.array(batch)).to(self.device)
            for acc, y in zip(outs, self.model(preprocess(x))):
                acc.append(y.cpu().numpy())
        return tuple(np.concatenate(acc) for acc in outs)
