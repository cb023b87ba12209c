"""ResNet-34 and ResNet-50 encoders (PyTorch port of
``ecologysemanticsegmentation_tpu/models/resnet.py``).

Submodules are named as the flax tree names them (``conv1``, ``bn1``,
``layer{s}_block{b}``, ``downsample_conv``/``downsample_bn``).
At output stride 32 (the U-Net's) every stage but the first halves the
resolution; at output stride 16 (DeepLabV3+'s) every 3x3 conv of the last
stage is dilated by 2 and keeps its stride at 1 (smp ``make_dilated``).
With a ``spatial`` partition it runs on this rank's row block
(:mod:`.common`); every feature map it returns is that rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, conv_rows, max_pool_3x3_s2


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) * dilation // 2, dilation, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride and dilation) -> 1x1 to 4x ``features``."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(in_features, features, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride, dilation)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.has_downsample = stride != 1 or in_features != out
        if self.has_downsample:
            self.downsample_conv = _conv(in_features, out, 1, stride)
            self.downsample_bn = BatchNorm2d(out)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), spatial))
        y = F.relu(self.bn2(conv_rows(self.conv2, y, spatial), spatial))
        y = self.bn3(self.conv3(y), spatial)
        identity = (self.downsample_bn(self.downsample_conv(x), spatial) if self.has_downsample
                    else x)
        return F.relu(y + identity)


class ResNetEncoder(nn.Module):
    """Returns the 5-level feature pyramid ``[/2, /4, /8, /16, /32]``, or
    ``[/2, /4, /8, /16, /16 dilated]`` at ``output_stride=16``."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), block: str = "basic", output_stride: int = 32):
        super().__init__()
        if output_stride not in (16, 32):
            raise ValueError(f"output_stride must be 16 or 32, got {output_stride}")
        block_cls = {"basic": BasicBlock, "bottleneck": Bottleneck}[block]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.stages: list[list[str]] = []
        cin = 64
        for stage, (num_blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            dilate_stage = stage == 3 and output_stride == 16
            names = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0 and not dilate_stage) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, block_cls(cin, width, stride, 2 if dilate_stage else 1))
                names.append(name)
                cin = width * block_cls.expansion
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


def resnet34(output_stride: int = 32) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), "basic", output_stride)


def resnet50(output_stride: int = 32) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), "bottleneck", output_stride)


ENCODER_FEATURES = {
    "resnet34": (64, 64, 128, 256, 512),
    "resnet50": (64, 256, 512, 1024, 2048),
}


def encoder_by_name(name: str, output_stride: int) -> ResNetEncoder:
    """The encoder the models' ``encoder_name`` names."""
    if name not in ENCODER_FEATURES:
        raise ValueError(f"unknown encoder {name!r}; choose from {tuple(ENCODER_FEATURES)}")
    return {"resnet34": resnet34, "resnet50": resnet50}[name](output_stride)
