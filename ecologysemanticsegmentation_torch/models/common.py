"""Shared model building blocks (PyTorch port of
``ecologysemanticsegmentation_tpu/models/common.py``).

Modules take and return NCHW tensors; the port keeps them in
``channels_last`` memory, so they are NHWC underneath and the permutes at
the model's NHWC boundary cost no copies.  Submodule names follow the flax
parameter tree (``conv``, ``bn``, ``depthwise``, ``pointwise``), which keeps
:mod:`.from_flax` a mechanical mapping.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.Module):
    """BatchNorm with flax.linen's semantics (``momentum=0.9, epsilon=1e-5``
    there; momentum 0.1 here in torch's convention).

    Differs from ``torch.nn.BatchNorm2d`` in one place: flax updates the
    running variance with the *biased* batch variance, torch with the
    unbiased one (at the ASPP pool branch, a 1x1 map at batch 2, the two
    differ by 2x).  Training mode normalizes with the batch statistics and
    updates the buffers itself from the batch mean and biased variance."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        # One pass: the normalized output plus the f32 batch mean and
        # 1/sqrt(var + eps), var biased.
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
        return y


class ConvBNAct(nn.Module):
    """Conv (no bias, symmetric padding) -> BatchNorm -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SeparableConvBNAct(nn.Module):
    """Depthwise 3x3 (dilated) + pointwise 1x1, both without bias, + BN +
    ReLU (smp ``SeparableConv2d``).

    The JAX block's ``DepthwiseConv`` lowers large dilations to a
    shift-and-add for the TPU; zero padding ``r`` at dilation ``r`` is the
    same math here.  A tuple of NCHW parts is a channel concat (the JAX
    ``_PointwiseConv`` contracts per part to avoid a lane-unaligned relayout
    on the TPU; on a GPU the concat is cheap)."""

    def __init__(self, in_features: int, features: int, dilation: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_features, in_features, 3, padding=dilation,
                                   dilation=dilation, groups=in_features, bias=False)
        self.pointwise = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, dim=1)
        return F.relu(self.bn(self.pointwise(self.depthwise(x))))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(kernel_size=3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, 2, 1)
