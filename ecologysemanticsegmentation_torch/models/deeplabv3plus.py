"""DeepLabV3+ with a ResNet-34 (the flagship) or ResNet-50 encoder at output
stride 16, and the ``--depthwiseconv`` variant (PyTorch port of
``ecologysemanticsegmentation_tpu/models/deeplabv3plus.py``).

The model's public interface is NHWC, as the JAX module's: images
(B, H, W, 3) in, float32 logits (B, H, W, C) out, or (B, H/4, W/4, C) with
``upsample_head=False`` for the fused head loss.  Inside, the tensors are
NCHW views of ``channels_last`` memory.

With a ``spatial`` partition whose rows are split (``--spatial_partition``)
the model takes this rank's row block of the images and returns its row
block of the one-rank model's logits.  The encoder runs on the block with
halo exchanges; the 1/16 map is gathered over the row group before the
ASPP, whose dilations (12, 24, 36) reach further than a block, and the ASPP
and its output conv run on whole images, the same on every rank of the
group; each rank keeps its rows of the x4 resize, and with
``upsample_head`` gathers the 1/4-resolution head output to resize its
rows.  BatchNorm statistics are global throughout.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..parallel.collectives import all_gather_rows
from .common import ConvBNAct, SeparableConvBNAct, conv_f32
from .resnet import ENCODER_FEATURES, encoder_by_name


def _resize_nchw(x: torch.Tensor, out_hw, align_corners: bool, rows=None) -> torch.Tensor:
    y = resize_bilinear(x.permute(0, 2, 3, 1), tuple(out_hw), align_corners, rows)
    return y.permute(0, 3, 1, 2)


def _gather_rows(x: torch.Tensor, spatial) -> torch.Tensor:
    """The whole images of this rank's row block ``x`` (NCHW)."""
    y = all_gather_rows(x, 2, spatial.row_group, spatial.row_index, spatial.row_count)
    return y.contiguous(memory_format=torch.channels_last)


def _resize_to_block(x: torch.Tensor, block_hw, spatial, align_corners: bool) -> torch.Tensor:
    """This rank's row block, ``block_hw`` in size, of the resize of whole
    images ``x`` (NCHW) to ``row_count`` such blocks stacked."""
    rows = block_hw[0]
    out_hw = (rows * spatial.row_count, block_hw[1])
    return _resize_nchw(x, out_hw, align_corners, (spatial.row_index * rows, rows))


def _dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator (flax ``nn.Dropout``
    semantics: keep with probability ``1 - p``, scale by ``1 / (1 - p)``)."""
    if not training or p == 0.0:
        return x
    u = torch.empty_like(x, dtype=torch.float32).uniform_(0.0, 1.0, generator=generator)
    return x * (u >= p).to(x.dtype) / (1.0 - p)


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling (separable-conv variant)."""

    atrous_rates = (12, 24, 36)

    def __init__(self, in_features: int, features: int = 256, drop_rate: float = 0.5):
        super().__init__()
        self.drop_rate = drop_rate
        self.conv1x1 = ConvBNAct(in_features, features, 1)
        self.atrous = [f"atrous{i}" for i in range(len(self.atrous_rates))]
        for name, rate in zip(self.atrous, self.atrous_rates):
            self.add_module(name, SeparableConvBNAct(in_features, features, dilation=rate))
        self.pool_conv = ConvBNAct(in_features, features, 1)
        self.project = ConvBNAct(features * (2 + len(self.atrous_rates)), features, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                spatial=None) -> torch.Tensor:
        """``x`` whole images: a ``spatial`` partition here only makes the
        BatchNorm statistics global."""
        branches = [self.conv1x1(x, spatial)] + [getattr(self, n)(x, spatial)
                                                 for n in self.atrous]
        # Image-pooling branch: global average -> 1x1 conv/BN/ReLU -> broadcast.
        pooled = self.pool_conv(x.mean(dim=(2, 3), keepdim=True), spatial)
        branches.append(pooled.expand_as(branches[0]))
        y = self.project(torch.cat(branches, dim=1), spatial)
        return _dropout(y, self.drop_rate, self.training, generator)


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes: int = 1, encoder_name: str = "resnet34",
                 decoder_features: int = 256, aspp_dropout: float = 0.5,
                 upsample_head: bool = True):
        super().__init__()
        self.upsample_head = upsample_head
        self.encoder = encoder_by_name(encoder_name, output_stride=16)
        widths = ENCODER_FEATURES[encoder_name]
        self.aspp = ASPP(widths[4], decoder_features, aspp_dropout)
        self.aspp_out = SeparableConvBNAct(decoder_features, decoder_features)
        self.low_project = ConvBNAct(widths[1], 48, 1)
        # smp channel order: [aspp, low]
        self.fuse = SeparableConvBNAct(decoder_features + 48, decoder_features)
        # smp 0.3.3's SegmentationHead: a 1x1 conv with bias
        self.head = nn.Conv2d(decoder_features, num_classes, 1, bias=True)

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None,
                spatial=None) -> torch.Tensor:
        """``images`` NHWC -> NHWC float32 logits; ``generator`` draws the
        ASPP dropout mask in training mode.  Under a ``spatial`` partition
        (:class:`..parallel.Spatial`) ``images`` is this rank's part of the
        batch; the ranks of its row group must draw the same dropout mask."""
        x = images.permute(0, 3, 1, 2)
        feats = self.encoder(x, spatial)
        low, high = feats[1], feats[4]  # /4 and /16 (dilated)
        rows = spatial is not None and spatial.row_group is not None
        whole = spatial.whole_rows() if rows else spatial
        if rows:
            high = _gather_rows(high, spatial)
        y = self.aspp(high, generator, whole)
        y = self.aspp_out(y, whole)
        if rows:
            y = _resize_to_block(y, low.shape[2:], spatial, align_corners=True)
        else:
            y = _resize_nchw(y, low.shape[2:], align_corners=True)
        y = self.fuse((y, self.low_project(low, spatial)), spatial)
        y = self.head(y)
        if self.upsample_head:
            if rows:
                y = _resize_to_block(_gather_rows(y, spatial), x.shape[2:], spatial,
                                     align_corners=True)
            else:
                y = _resize_nchw(y, x.shape[2:], align_corners=True)
        return y.permute(0, 2, 3, 1).float()


class DeepLabV3PlusDepthwise(nn.Module):
    """The reference's ``--depthwiseconv`` variant (JAX
    ``DeepLabV3PlusDepthwise``): an inner DeepLabV3+ ``smp_deeplab_model``
    predicting ``num_classes * depthwise_multiplier`` channels at full
    resolution, then ``last_layers``, a 3x3 conv with bias back to
    ``num_classes``, in float32.  Its kernel is initialized kaiming-normal
    (``variance_scale`` 2, read by ``train.init_weights``)."""

    depthwise_multiplier = 5

    def __init__(self, num_classes: int = 1, encoder_name: str = "resnet34",
                 aspp_dropout: float = 0.5):
        super().__init__()
        width = num_classes * self.depthwise_multiplier
        self.smp_deeplab_model = DeepLabV3Plus(width, encoder_name, aspp_dropout=aspp_dropout)
        self.last_layers = nn.Conv2d(width, num_classes, 3, padding=1, bias=True)
        self.last_layers.variance_scale = 2.0

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        y = self.smp_deeplab_model(images, generator).permute(0, 3, 1, 2)
        return conv_f32(self.last_layers, y).permute(0, 2, 3, 1)
