"""ResNet-34 encoder (PyTorch port of
``ecologysemanticsegmentation_tpu/models/resnet.py``; the Bottleneck
ResNet-50 is not ported yet).

Submodules are named as the flax tree names them (``conv1``, ``bn1``,
``layer{s}_block{b}``, ``downsample_conv``/``downsample_bn``).
The encoder is built at output stride 16, the DeepLabV3+ encoder: every 3x3
conv of the last stage is dilated by 2 and keeps its stride at 1 (smp
``make_dilated``).  With a ``spatial`` partition it runs on this rank's row
block (:mod:`.common`); every feature map it returns is that rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, conv_rows, max_pool_3x3_s2


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) * dilation // 2, dilation, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, stride, dilation)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1, dilation)
        self.bn2 = BatchNorm2d(features)
        self.has_downsample = stride != 1 or in_features != features
        if self.has_downsample:
            self.downsample_conv = _conv(in_features, features, 1, stride)
            self.downsample_bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        y = F.relu(self.bn1(conv_rows(self.conv1, x, spatial), spatial))
        y = self.bn2(conv_rows(self.conv2, y, spatial), spatial)
        identity = (self.downsample_bn(self.downsample_conv(x), spatial) if self.has_downsample
                    else x)
        return F.relu(y + identity)


class ResNetEncoder(nn.Module):
    """ResNet-34 at output stride 16; returns the 5-level feature pyramid
    ``[/2, /4, /8, /16, /16 dilated]``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.stages: list[list[str]] = []
        cin = 64
        for stage, (num_blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            dilate_stage = stage == 3
            names = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0 and not dilate_stage) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, BasicBlock(cin, width, stride, 2 if dilate_stage else 1))
                names.append(name)
                cin = width
            self.stages.append(names)

    def forward(self, x: torch.Tensor, spatial=None) -> list[torch.Tensor]:
        x = F.relu(self.bn1(conv_rows(self.conv1, x, spatial), spatial))
        features = [x]  # /2
        x = max_pool_3x3_s2(x, spatial)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, spatial)
            features.append(x)
        return features
