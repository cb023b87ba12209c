"""VGG19-BN U-Net with StochasticDropout, optional deep supervision and
optional rematerialization (PyTorch port of
``ecologysemanticsegmentation_tpu/models/vgg.py``).

* The encoder is vgg19_bn's feature stack truncated at the first stage
  wider than ``max_channels``; a ``StochasticDropout`` follows every ReLU
  from the first stage whose width reaches ``dropout_min_channels`` on.
  The tensors before each max pool are the skips, returned deepest first.
* The decoder's plan is ``[512 x 5, 256, 256, 128, 64]`` with upsample
  flags ``[T, F, F, T, F, T, F, T, T]``, filtered by ``max_channels``.  An
  upsampling block starts with the nearest x2 of its input concatenated
  after its skip (``[skip, up]``).
* ``DeconvNormActivation`` is N x (conv -> BN -> LeakyReLU -> optional
  dropout); the final 1x1 conv keeps its BN and LeakyReLU, a quirk of the
  reference.
* With ``deepsupervision`` the model also returns side heads, float32 3x3
  convs with bias over the tensors before each upsample, shallowest first.
* ``remat`` recomputes each encoder stage and each decoder block in
  backward instead of keeping its activations (:func:`.common.checkpointed`,
  the JAX package's per-region ``nn.remat``); the result is the same.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    BatchNorm2d,
    NearestUpConcatConv,
    StochasticDropout,
    checkpointed,
    conv_f32,
    leaky_relu,
    max_pool_2x2,
)

# vgg19_bn configuration "E": conv widths with 'M' max-pools.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

_DECODER_CHANNELS = [512, 512, 512, 512, 512, 256, 256, 128, 64]
# Dropout is on from the first stage (and in the decoder blocks) this wide.
DROPOUT_MIN_CHANNELS = 256
_DECODER_UPSAMPLE = [True, False, False, True, False, True, False, True, True]


def _encoder_stages() -> list[list[int]]:
    """VGG19_CFG split at the max pools: [[64, 64], [128, 128], [256] * 4, [512] * 4, [512] * 4]."""
    stages: list[list[int]] = []
    cur: list[int] = []
    for spec in VGG19_CFG:
        if spec == "M":
            stages.append(cur)
            cur = []
        else:
            cur.append(int(spec))
    if cur:
        stages.append(cur)
    return stages


def _decoder_plan(max_channels: int) -> tuple[list[int], list[bool]]:
    channels = list(_DECODER_CHANNELS)
    upsample = list(_DECODER_UPSAMPLE)
    if max_channels != 512:
        channels = [c for c in channels if c <= max_channels]
        upsample = upsample[-len(channels):]
    channels.insert(0, channels[0])
    return channels, upsample


def _run(owner: nn.Module, fn, remat: bool, generator, *args) -> torch.Tensor:
    """``fn(*args, generator)``, recomputed in backward with ``remat``
    (``owner`` holds the BatchNorm layers ``fn`` runs)."""
    if remat and torch.is_grad_enabled():
        return checkpointed(owner, fn, generator, *args)
    return fn(*args, generator)


class DeconvNormActivation(nn.Module):
    """N x (conv -> BN -> LeakyReLU -> optional StochasticDropout).  With
    ``skip_features`` block 0 is the fused entry: ``forward`` takes
    ``(skip, low)`` and block 0's conv runs on ``[skip, nearest_x2(low)]``
    (:class:`.common.NearestUpConcatConv`, ``up_first=False``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, num_blocks: int = 2,
                 dropout_p: float = 0.05, use_bias: bool = False,
                 skip_features: int | None = None):
        super().__init__()
        self.num_blocks, self.fused = num_blocks, skip_features is not None
        for i in range(num_blocks):
            if i == 0 and self.fused:
                conv = NearestUpConcatConv(in_features, skip_features, features, use_bias,
                                           up_first=False)
            else:
                conv = nn.Conv2d(in_features if i == 0 else features, features, kernel,
                                 padding=(kernel - 1) // 2, bias=use_bias)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", BatchNorm2d(features))
            if dropout_p != 0.0:
                self.add_module(f"dropout{i}", StochasticDropout(dropout_p))
        self.dropout = dropout_p != 0.0

    def forward(self, *args) -> torch.Tensor:
        """``(x, generator)``, or ``(skip, low, generator)`` when fused."""
        *x, generator = args
        for i in range(self.num_blocks):
            conv = getattr(self, f"conv{i}")
            y = conv(x[1], x[0]) if i == 0 and self.fused else conv(x[0] if i == 0 else y)
            y = leaky_relu(getattr(self, f"bn{i}")(y))
            if self.dropout:
                y = getattr(self, f"dropout{i}")(y, generator)
        return y


class VGGUNetEncoder(nn.Module):
    """Returns the bottom tensor and the skips, deepest first.  Per conv,
    ``conv{idx}`` (with bias) -> ``bn{idx}`` -> ReLU -> optional
    ``dropout{idx}``, numbered across the stages as the flax tree numbers
    them."""

    def __init__(self, max_channels: int = 512, dropout_p: float = 0.05, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stages: list[list[tuple[str, str, str | None]]] = []
        self.skip_features: list[int] = []
        flag, idx, cin = False, 0, 3
        for widths in _encoder_stages():
            if widths[0] > max_channels:
                break  # the truncation rule; stage widths are uniform
            layers = []
            for width in widths:
                flag = flag or width >= DROPOUT_MIN_CHANNELS
                drop = flag and dropout_p != 0.0
                self.add_module(f"conv{idx}", nn.Conv2d(cin, width, 3, padding=1, bias=True))
                self.add_module(f"bn{idx}", BatchNorm2d(width))
                if drop:
                    self.add_module(f"dropout{idx}", StochasticDropout(dropout_p))
                layers.append((f"conv{idx}", f"bn{idx}", f"dropout{idx}" if drop else None))
                idx, cin = idx + 1, width
            self.stages.append(layers)
            self.skip_features.insert(0, cin)
        self.out_features = cin

    def _stage(self, layers, x: torch.Tensor, generator) -> torch.Tensor:
        for conv, bn, drop in layers:
            x = F.relu(getattr(self, bn)(getattr(self, conv)(x)))
            if drop is not None:
                x = getattr(self, drop)(x, generator)
        return x

    def forward(self, x: torch.Tensor, generator=None):
        skips = []
        for layers in self.stages:
            x = _run(self, functools.partial(self._stage, layers), self.remat, generator, x)
            skips.append(x)
            x = max_pool_2x2(x)
        return x, skips[::-1]


class VGGUNetDecoder(nn.Module):
    def __init__(self, in_features: int, skip_features: list[int], num_classes: int = 1,
                 max_channels: int = 512, dropout_p: float = 0.05, remat: bool = False):
        super().__init__()
        self.remat = remat
        channels, self.upsample = _decoder_plan(max_channels)
        self.blocks: list[list[str]] = []
        self.ds_features: list[int] = []
        skip_idx, cin = 0, in_features
        for idx in range(len(channels) - 1):
            out_ch = channels[idx + 1]
            skip = None
            if self.upsample[idx]:
                self.ds_features.append(cin)
                skip = skip_features[skip_idx]
                skip_idx += 1
            dp = dropout_p if DROPOUT_MIN_CHANNELS <= out_ch else 0.0
            nb = 1 if idx == 0 and max_channels == 512 else 3
            names = [f"channel_block{idx}"]
            self.add_module(names[0], DeconvNormActivation(cin, out_ch, 3, nb, dp, False, skip))
            if idx != 0:
                names.append(f"conv_block{idx}")
                self.add_module(names[1], DeconvNormActivation(out_ch, out_ch, 1, 2, dp))
            self.blocks.append(names)
            cin = out_ch
        self.final_conv = DeconvNormActivation(cin, num_classes, 1, 1, 0.0, True)

    def forward(self, x: torch.Tensor, skips: list[torch.Tensor], generator=None):
        ds = []
        skip_idx = 0
        for idx, names in enumerate(self.blocks):
            first = getattr(self, names[0])
            if self.upsample[idx]:
                ds.append(x)
                x = _run(first, first, self.remat, generator, skips[skip_idx], x)
                skip_idx += 1
            else:
                x = _run(first, first, self.remat, generator, x)
            for name in names[1:]:
                block = getattr(self, name)
                x = _run(block, block, self.remat, generator, x)
        return _run(self.final_conv, self.final_conv, self.remat, generator, x), ds


class VGGUNet(nn.Module):
    """NHWC images in; float32 NHWC logits out, and with ``deepsupervision``
    the pair ``(logits, side heads shallowest first)``, each head NHWC
    float32 at its tensor's resolution."""

    def __init__(self, num_classes: int = 1, max_channels: int = 512, dropout_p: float = 0.05,
                 deepsupervision: bool = False, remat: bool = False):
        super().__init__()
        self.deepsupervision = deepsupervision
        self.encoder = VGGUNetEncoder(max_channels, dropout_p, remat)
        self.decoder = VGGUNetDecoder(self.encoder.out_features, self.encoder.skip_features,
                                      num_classes, max_channels, dropout_p, remat)
        self.ds_heads = []
        if deepsupervision:
            for i, width in enumerate(self.decoder.ds_features):
                self.add_module(f"ds_head{i}",
                                nn.Conv2d(width, num_classes, 3, padding=1, bias=True))
                self.ds_heads.append(f"ds_head{i}")

    def forward(self, images: torch.Tensor, generator=None):
        y, skips = self.encoder(images.permute(0, 3, 1, 2), generator)
        y, ds = self.decoder(y, skips, generator)
        y = y.permute(0, 2, 3, 1).float()
        if not self.deepsupervision:
            return y
        heads = [conv_f32(getattr(self, name), t).permute(0, 2, 3, 1)
                 for name, t in zip(self.ds_heads, ds)]
        return y, heads[::-1]
