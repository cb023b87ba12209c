"""Shared model building blocks (PyTorch port of
``ecologysemanticsegmentation_tpu/models/common.py``).

Modules take and return NCHW tensors; the port keeps them in
``channels_last`` memory, so they are NHWC underneath and the permutes at
the model's NHWC boundary cost no copies.  Submodule names follow the flax
parameter tree (``conv``, ``bn``, ``depthwise``, ``pointwise``), which keeps
:mod:`.from_flax` a mechanical mapping.

Every module's ``forward`` takes an optional ``spatial``
(:class:`..parallel.Spatial`): this rank's part of a batch split over ranks.
BatchNorm then takes its statistics over every rank, and a convolution or
the max pool on a row block first fetches the rows its window reads across
the block's edges (:func:`conv_rows`).  Without it a module is the one-rank
module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum, halo_exchange


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

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if spatial is not None:
            return self._global_batch_norm(x, spatial.stats_group)
        # One pass: the normalized output plus the f32 batch mean and
        # 1/sqrt(var + eps), var biased.
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
        return y

    def _global_batch_norm(self, x: torch.Tensor, group) -> torch.Tensor:
        """Training mode over a batch split across ``group``'s ranks: the
        per-channel sums of x and x^2 and the count, all-reduced, give the
        global mean and flax's fast variance E[x^2] - E[x]^2 (what GSPMD's
        mean over sharded axes gives the JAX package).  Every rank reads
        the same reduced sums, so the running buffers stay equal."""
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        total = all_reduce_sum(local, group)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        return y.to(x.dtype)


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, spatial=None) -> torch.Tensor:
    """``conv(x)`` on this rank's row block: the rows its window reads
    above and below the block come from the neighbouring blocks
    (:func:`..parallel.halo_exchange`, zeros past the image's edges, as the
    conv's own padding), then the conv runs without row padding.  With a
    stride s the block's first row is a multiple of s, so the output is
    this rank's block of the one-rank output."""
    if spatial is None or spatial.row_group is None:
        return conv(x)
    k, s, d, p = conv.kernel_size[0], conv.stride[0], conv.dilation[0], conv.padding[0]
    top, bottom = p, max((k - 1) * d - p - (s - 1), 0)
    x = halo_exchange(x, top, bottom, 2, spatial.row_group, spatial.row_index,
                      spatial.row_count)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


class ConvBNAct(nn.Module):
    """Conv (no bias, symmetric padding) -> BatchNorm -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        return F.relu(self.bn(conv_rows(self.conv, x, spatial), spatial))


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

    def forward(self, x, spatial=None) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, dim=1)
        return F.relu(self.bn(self.pointwise(conv_rows(self.depthwise, x, spatial)), spatial))


def max_pool_3x3_s2(x: torch.Tensor, spatial=None) -> torch.Tensor:
    """torch ``MaxPool2d(kernel_size=3, stride=2, padding=1)``; on a row
    block, the row above the block joins it first, -inf past the image's
    top edge, as the pool's own padding."""
    if spatial is None or spatial.row_group is None:
        return F.max_pool2d(x, 3, 2, 1)
    x = halo_exchange(x, 1, 0, 2, spatial.row_group, spatial.row_index, spatial.row_count,
                      float("-inf"))
    return F.max_pool2d(x, 3, 2, (0, 1))
