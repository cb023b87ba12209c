"""EfficientNetV2-S encoder and U-Net (PyTorch port of
``ecologysemanticsegmentation_tpu/models/efficientnet_v2s.py``).

The V2-S stage plan (FusedMBConv stages 0-2, MBConv with squeeze-excite
stages 3-5); ``depth_multiplier`` scales the block counts.  The U-Net keeps
the JAX module's wiring exactly: the skips are the tensors before each
stride-2 block, ``zip(skips, widths)`` runs four decoder stages (the fifth
width, 24, is never used), each a materialized nearest x2 upsample
concatenated ``[up, skip]`` into a stride-1 MBDeconv, and the head is a
float32 nearest-x2 3x3 conv with bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvBNAct, NearestUpConcatConv, StochasticDropout, conv_f32, up2
from .mbdeconv import MBDeconv

# (block, expand, kernel, stride, features, num_blocks, use_se)
V2S_STAGES = [
    ("fused", 1, 3, 1, 24, 2, False),
    ("fused", 4, 3, 2, 48, 4, False),
    ("fused", 4, 3, 2, 64, 4, False),
    ("mbconv", 4, 3, 2, 128, 6, True),
    ("mbconv", 6, 3, 1, 160, 9, True),
    ("mbconv", 6, 3, 2, 256, 15, True),
]
STOCHASTIC_DEPTH_P = 0.05  # the JAX encoder's, fixed by its U-Net


class SqueezeExcite(nn.Module):
    """Global mean -> 1x1 ``reduce`` (bias) -> SiLU -> 1x1 ``expand``
    (bias) -> sigmoid gate on the input."""

    def __init__(self, features: int, reduced: int):
        super().__init__()
        self.reduce = nn.Conv2d(features, reduced, 1, bias=True)
        self.expand = nn.Conv2d(reduced, features, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.expand(F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class FusedMBConv(nn.Module):
    def __init__(self, in_features: int, features: int, expand_ratio: int, stride: int = 1,
                 drop_p: float = 0.0):
        super().__init__()
        mid = in_features * expand_ratio
        if expand_ratio != 1:
            self.fused = ConvBNAct(in_features, mid, 3, stride, act=F.silu)
            self.project = ConvBNAct(mid, features, 1, act=None)
        else:
            self.fused = ConvBNAct(in_features, features, 3, stride, act=F.silu)
            self.project = None
        self.residual = stride == 1 and features == in_features
        if self.residual:
            self.sd = StochasticDropout(drop_p)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = self.fused(x)
        if self.project is not None:
            y = self.project(y)
        if self.residual:
            y = self.sd(y, generator) + x
        return y


class MBConv(nn.Module):
    def __init__(self, in_features: int, features: int, expand_ratio: int, stride: int = 1,
                 use_se: bool = True, drop_p: float = 0.0):
        super().__init__()
        mid = in_features * expand_ratio
        self.expand = ConvBNAct(in_features, mid, 1, act=F.silu)
        self.depthwise = ConvBNAct(mid, mid, 3, stride, groups=mid, act=F.silu)
        self.se = SqueezeExcite(mid, max(in_features // 4, 1)) if use_se else None
        self.project = ConvBNAct(mid, features, 1, act=None)
        self.residual = stride == 1 and features == in_features
        if self.residual:
            self.sd = StochasticDropout(drop_p)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = self.depthwise(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        if self.residual:
            y = self.sd(y, generator) + x
        return y


class EfficientNetV2SEncoder(nn.Module):
    """Feature pyramid ``[/2, /4, /8, /16, /32]``: the tensor before each
    stride-2 block, then the last."""

    def __init__(self, depth_multiplier: float = 1.0):
        super().__init__()
        self.stem = ConvBNAct(3, 24, 3, 2, act=F.silu)
        self.blocks: list[tuple[str, bool]] = []  # (name, a skip is taken before it)
        self.skip_features: list[int] = []
        cin = 24
        for si, (kind, expand, _, stride, feat, blocks, use_se) in enumerate(V2S_STAGES):
            blocks = max(1, int(round(blocks * depth_multiplier)))
            for b in range(blocks):
                s = stride if b == 0 else 1
                name = f"stage{si}_block{b}"
                if kind == "fused":
                    block = FusedMBConv(cin, feat, expand, s, STOCHASTIC_DEPTH_P)
                else:
                    block = MBConv(cin, feat, expand, s, use_se, STOCHASTIC_DEPTH_P)
                self.add_module(name, block)
                self.blocks.append((name, s == 2))
                if s == 2:
                    self.skip_features.append(cin)
                cin = feat
        self.out_features = cin

    def forward(self, x: torch.Tensor, generator=None) -> list[torch.Tensor]:
        x = self.stem(x)
        features = []
        for name, skip in self.blocks:
            if skip:
                features.append(x)  # the pre-downsample tensor is a skip level
            x = getattr(self, name)(x, generator)
        features.append(x)  # /32
        return features


class EfficientNetV2SUNet(nn.Module):
    """NHWC images in, float32 NHWC logits out."""

    def __init__(self, num_classes: int = 1, depth_multiplier: float = 1.0):
        super().__init__()
        self.encoder = EfficientNetV2SEncoder(depth_multiplier)
        cin = self.encoder.out_features
        self.decoder = []
        skips = self.encoder.skip_features[::-1]  # deepest first
        for i, (skip, width) in enumerate(zip(skips, (160, 96, 64, 32, 24))):
            self.add_module(f"dec{i}", MBDeconv(cin + skip, width, stride=1))
            self.decoder.append(f"dec{i}")
            cin = width
        self.head = NearestUpConcatConv(cin, 0, num_classes, use_bias=True)

    def forward(self, images: torch.Tensor, generator=None) -> torch.Tensor:
        feats = self.encoder(images.permute(0, 3, 1, 2), generator)
        y = feats[-1]
        for name, skip in zip(self.decoder, feats[-2::-1]):
            y = torch.cat([up2(y), skip], dim=1)
            y = getattr(self, name)(y, generator)
        return conv_f32(self.head, up2(y.float())).permute(0, 2, 3, 1)
