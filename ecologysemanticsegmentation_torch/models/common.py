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

Randomness comes from explicit generators: a module that drops takes the
``generator`` its model was given.  :func:`checkpointed` runs a region
under ``torch.utils.checkpoint`` (the JAX package's ``remat``) without
changing what it computes: the region's dropout masks are kept from the
forward and handed back to its replay, and its BatchNorm layers leave their
running statistics alone in the replay.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.resize import upsample_nearest
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
        # Set by :func:`checkpointed` while backward replays this layer's
        # region: the forward already updated the running statistics.
        self.replaying = False

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
        if self.replaying:
            return y
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
        if self.replaying:
            return y.to(x.dtype)
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
    """Conv -> BatchNorm -> activation (``act``: ``F.relu``, ``F.silu`` or
    None), the JAX block with its ``strides``, ``dilation``, ``groups`` and
    ``use_bias``.  Padding is symmetric, ``(k - 1) * d // 2`` (``SAME`` at
    stride 1, the JAX block's explicit padding otherwise).

    ``up_skip`` (None by default) makes the entry the JAX block's
    ``(low, skip)`` tuple form: ``forward`` then takes ``(low, skip)`` and
    the ``conv`` is the 3x3 of the nearest x2 upsample of ``low``
    concatenated with ``skip`` (:class:`NearestUpConcatConv`, ``up_skip``
    skip channels, 0 for none), or with ``groups`` the depthwise 3x3 of the
    upsample (:class:`NearestUpDepthwiseConv`); the parameter is the same
    one kernel either way."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1, use_bias: bool = False,
                 act: Callable | None = F.relu, up_skip: int | None = None):
        super().__init__()
        self.act = act
        if up_skip is None:
            self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                                  (kernel_size - 1) * dilation // 2, dilation, groups,
                                  bias=use_bias)
        elif groups != 1:
            if not (up_skip == 0 and groups == features == in_features and kernel_size == 3):
                raise ValueError("the fused depthwise entry takes no skip and keeps the width")
            self.conv = NearestUpDepthwiseConv(features, use_bias)
        else:
            if (kernel_size, stride, dilation) != (3, 1, 1):
                raise ValueError("the fused entry is a 3x3 conv at stride 1")
            self.conv = NearestUpConcatConv(in_features, up_skip, features, use_bias)
        self.bn = BatchNorm2d(features)

    def forward(self, x, spatial=None) -> torch.Tensor:
        if isinstance(self.conv, NearestUpDepthwiseConv):
            y = self.bn(self.conv(x[0]), spatial)
        elif isinstance(self.conv, NearestUpConcatConv):
            y = self.bn(self.conv(*x), spatial)
        else:
            y = self.bn(conv_rows(self.conv, x, spatial), spatial)
        return y if self.act is None else self.act(y)


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


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(2, 2)`` (VGG)."""
    return F.max_pool2d(x, 2, 2)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """torch ``nn.LeakyReLU``'s default, negative slope 0.01."""
    return F.leaky_relu(x, 0.01)


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of NCHW ``x`` (``channels_last`` stays so)."""
    return upsample_nearest(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)


def conv_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` in float32 whatever the model's dtype and autocast: the
    JAX package's ``dtype=float32`` layers (heads whose logits must not
    round to bf16)."""
    bias = None if conv.bias is None else conv.bias.float()
    with torch.autocast(x.device.type, enabled=False):
        return F.conv2d(x.float(), conv.weight.float(), bias, conv.stride, conv.padding,
                        conv.dilation, conv.groups)


class NearestUpConcatConv(nn.Conv2d):
    """``conv3x3(concat(nearest_x2(low), skip))`` with one kernel over the
    concatenated channels, (3, 3, C_up + C_skip, F) in flax.  ``up_first``
    says which input-channel slice the upsampled operand owns: ``[up,
    skip]`` (the U-Nets) or ``[skip, up]`` (VGG).  The JAX module never
    materializes the upsample or the concat (it folds them into one
    lhs-dilated conv with a composed 4x4 kernel, the same function); on the
    card both are one copy each."""

    def __init__(self, up_features: int, skip_features: int, features: int,
                 use_bias: bool = False, up_first: bool = True):
        super().__init__(up_features + skip_features, features, 3, padding=1, bias=use_bias)
        self.up_first = up_first

    def forward(self, low: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        x = up2(low)
        if skip is not None:
            x = torch.cat([x, skip] if self.up_first else [skip, x], dim=1)
        return super().forward(x)


class NearestUpDepthwiseConv(nn.Conv2d):
    """``depthwise3x3(nearest_x2(low))``, kernel (3, 3, 1, C) in flax: the
    grouped twin of :class:`NearestUpConcatConv`."""

    def __init__(self, features: int, use_bias: bool = False):
        super().__init__(features, features, 3, padding=1, groups=features, bias=use_bias)

    def forward(self, low: torch.Tensor) -> torch.Tensor:
        return super().forward(up2(low))


class MaskTape:
    """The dropout masks of one :func:`checkpointed` call: drawn from
    ``generator`` and kept in the forward, handed back in the same order
    while backward replays the region (the JAX policy saves them as
    ``"sd_mask"`` residuals).  A :class:`StochasticDropout` given a tape in
    place of a generator draws through it."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator
        self.masks: list[torch.Tensor] = []
        self.replayed: int | None = None  # masks handed back, while replaying

    def keep_mask(self, x: torch.Tensor, keep: float) -> torch.Tensor:
        if self.replayed is not None:
            mask = self.masks[self.replayed]
            self.replayed += 1
            return mask
        mask = keep_mask(x, keep, self.generator)
        self.masks.append(mask)
        return mask


def keep_mask(x: torch.Tensor, keep: float, generator) -> torch.Tensor:
    """A Bernoulli(``keep``) mask of ``x``'s shape on ``x``'s device, drawn
    on ``generator``'s device (a CPU generator gives a card model the masks
    a CPU model draws); ``generator`` may be a :class:`MaskTape`."""
    if isinstance(generator, MaskTape):
        return generator.keep_mask(x, keep)
    device = x.device if generator is None else generator.device
    u = torch.rand(x.shape, generator=generator, device=device)
    return (u < keep).to(x.device)


class StochasticDropout(nn.Module):
    """Element-wise dropout with survival-rate scaling (the JAX
    ``StochasticDropout``): each element survives with probability
    ``1 - p`` and survivors are scaled by ``1 / (1 - p)``.  The JAX module
    draws its mask from 16 hardware-RNG bits (keep quantized to 1/65536);
    the port draws Bernoulli(keep) from ``generator``."""

    def __init__(self, p: float = 0.05):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return x * (keep_mask(x, keep, generator).to(x.dtype) / keep)


def checkpointed(module: nn.Module, fn: Callable, generator, *args) -> torch.Tensor:
    """``fn(*args, tape)`` under ``torch.utils.checkpoint``: its activations
    are recomputed in backward instead of kept (the JAX package's per-region
    ``remat``), with the same gradients.  ``tape`` (a :class:`MaskTape` of
    ``generator``) is what ``fn`` passes its dropouts for a generator, so
    the replay reuses the forward's masks; ``module``'s BatchNorm layers
    skip their running-statistics update in the replay.  (``checkpoint``'s
    own ``preserve_rng_state`` restores only the default generators.)"""
    tape = MaskTape(generator)
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]

    @contextlib.contextmanager
    def replay():
        tape.replayed = 0
        for m in norms:
            m.replaying = True
        try:
            yield
        finally:
            tape.replayed = None
            for m in norms:
                m.replaying = False

    return checkpoint(fn, *args, tape, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()))
