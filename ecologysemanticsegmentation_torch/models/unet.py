"""ResNet-encoder U-Net (PyTorch port of
``ecologysemanticsegmentation_tpu/models/unet.py``).

The resnet34 or resnet50 encoder at output stride 32, then five decoder
stages of (nearest x2 upsample, concat ``[up, skip]``, ConvBNAct,
ConvBNAct) with channels (256, 128, 64, 32, 16), the last without a skip,
and a 3x3 head with bias.  NHWC images in, float32 NHWC logits out.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ConvBNAct
from .resnet import ENCODER_FEATURES, encoder_by_name


class UNet(nn.Module):
    decoder_channels = (256, 128, 64, 32, 16)

    def __init__(self, num_classes: int = 1, encoder_name: str = "resnet34"):
        super().__init__()
        self.encoder = encoder_by_name(encoder_name, output_stride=32)
        widths = ENCODER_FEATURES[encoder_name]
        # skips consumed deepest-first: /16, /8, /4, /2, none
        skips = (widths[3], widths[2], widths[1], widths[0], 0)
        cin = widths[4]
        self.decoder = []
        for i, (ch, skip) in enumerate(zip(self.decoder_channels, skips)):
            self.add_module(f"decoder{i}_conv1", ConvBNAct(cin, ch, up_skip=skip))
            self.add_module(f"decoder{i}_conv2", ConvBNAct(ch, ch))
            self.decoder.append((f"decoder{i}_conv1", f"decoder{i}_conv2"))
            cin = ch
        self.head = nn.Conv2d(cin, num_classes, 3, padding=1, bias=True)

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """``images`` NHWC -> NHWC float32 logits; ``generator`` is unused
        (the U-Net draws nothing), taken for the models' common call."""
        feats = self.encoder(images.permute(0, 3, 1, 2))
        y = feats[-1]
        skips = [feats[3], feats[2], feats[1], feats[0], None]
        for (first, second), skip in zip(self.decoder, skips):
            y = getattr(self, first)((y, skip))
            y = getattr(self, second)(y)
        return self.head(y).permute(0, 2, 3, 1).float()
