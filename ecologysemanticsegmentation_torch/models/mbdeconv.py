"""MBDeconv, the inverted-residual upsampling block, and the small
MBDeconv-stack decoder (PyTorch port of
``ecologysemanticsegmentation_tpu/models/mbdeconv.py``).

Expand 1x1 -> depthwise 3x3 (at stride 2 on the nearest x2 upsample of
its input, :class:`.common.NearestUpDepthwiseConv`) -> project 1x1, with a
StochasticDropout on the residual path where the block keeps its shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvBNAct, StochasticDropout, conv_f32


class MBDeconv(nn.Module):
    """Expand ratio 4 and residual dropout p = 0.05, the JAX block's
    defaults and the only values its callers use."""

    expand_ratio = 4
    stochastic_dropout_p = 0.05

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        mid = in_features * self.expand_ratio
        self.stride = stride
        self.expand = ConvBNAct(in_features, mid, 1, act=F.silu)
        self.depthwise = ConvBNAct(mid, mid, 3, groups=mid, act=F.silu,
                                   up_skip=0 if stride == 2 else None)
        self.project = ConvBNAct(mid, features, 1, act=None)
        self.residual = stride == 1 and features == in_features
        if self.residual:
            self.sd = StochasticDropout(self.stochastic_dropout_p)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = self.expand(x)
        y = self.depthwise((y, None) if self.stride == 2 else y)
        y = self.project(y)
        if self.residual:
            y = self.sd(y, generator) + x
        return y


class EfficientNetDeconvDecoder(nn.Module):
    """Per stage an upsampling MBDeconv (``up{i}``) and a mixing one
    (``mix{i}``), then a float32 3x3 head with bias; NCHW in, float32 NCHW
    logits out."""

    def __init__(self, in_features: int, num_classes: int = 1,
                 stage_features: tuple[int, ...] = (256, 128, 64, 32)):
        super().__init__()
        self.stages = []
        for i, f in enumerate(stage_features):
            self.add_module(f"up{i}", MBDeconv(in_features, f, stride=2))
            self.add_module(f"mix{i}", MBDeconv(f, f, stride=1))
            self.stages.append((f"up{i}", f"mix{i}"))
            in_features = f
        self.head = nn.Conv2d(in_features, num_classes, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for up, mix in self.stages:
            x = getattr(self, up)(x, generator)
            x = getattr(self, mix)(x, generator)
        return conv_f32(self.head, x)
