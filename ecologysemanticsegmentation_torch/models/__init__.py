"""Model zoo of the port, every model of the JAX package's ``build_model``:
DeepLabV3+ (the flagship) and its ``--depthwiseconv`` variant, the ResNet
U-Net, the VGG19-BN U-Net and the EfficientNetV2-S U-Net."""

from __future__ import annotations

import torch

from .. import resolve_device
from .deeplabv3plus import ASPP, DeepLabV3Plus, DeepLabV3PlusDepthwise
from .efficientnet_v2s import EfficientNetV2SEncoder, EfficientNetV2SUNet, FusedMBConv, MBConv
from .from_flax import (
    from_flax_variables,
    optimizer_from_flax,
    optimizer_to_flax,
    to_flax_variables,
)
from .mbdeconv import EfficientNetDeconvDecoder, MBDeconv
from .resnet import ENCODER_FEATURES, ResNetEncoder, resnet34, resnet50
from .unet import UNet
from .vgg import DeconvNormActivation, VGGUNet, VGGUNetDecoder, VGGUNetEncoder

MODEL_NAMES = (
    "deeplabv3plus", "deeplabv3plus_depthwise", "unet", "vgg_unet",
    "efficientnet_v2s_unet",
)


def build_model(name: str = "deeplabv3plus", num_classes: int = 1,
                encoder_name: str = "resnet34", max_channels: int = 256,
                depthwise: bool = False, deepsupervision: bool = False,
                upsample_head: bool = True, remat: bool = False,
                device=None) -> torch.nn.Module:
    """The named model with the JAX package's arguments, on ``device``
    (CUDA unless ``device="cpu"``), in ``channels_last`` memory.
    ``depthwise`` (the ``--depthwiseconv`` flag) wins over ``name``.
    ``upsample_head=False`` makes DeepLabV3+ emit 1/4-resolution logits for
    the fused head loss, and ``remat`` recomputes the VGG U-Net's stages in
    backward; the parameters are the same either way.  ``max_channels`` and
    ``deepsupervision`` are the VGG U-Net's, ``encoder_name`` (resnet34 or
    resnet50) the DeepLabV3+'s and the ResNet U-Net's."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; choose from {MODEL_NAMES}")
    device = resolve_device(device)
    if depthwise or name == "deeplabv3plus_depthwise":
        model = DeepLabV3PlusDepthwise(num_classes=num_classes, encoder_name=encoder_name)
    elif name == "deeplabv3plus":
        model = DeepLabV3Plus(num_classes=num_classes, encoder_name=encoder_name,
                              upsample_head=upsample_head)
    elif name == "unet":
        model = UNet(num_classes=num_classes, encoder_name=encoder_name)
    elif name == "vgg_unet":
        model = VGGUNet(num_classes=num_classes, max_channels=max_channels,
                        deepsupervision=deepsupervision, remat=remat)
    else:
        model = EfficientNetV2SUNet(num_classes=num_classes)
    return model.to(device=device, memory_format=torch.channels_last)


__all__ = [
    "ASPP", "DeconvNormActivation", "DeepLabV3Plus", "DeepLabV3PlusDepthwise",
    "ENCODER_FEATURES", "EfficientNetDeconvDecoder", "EfficientNetV2SEncoder",
    "EfficientNetV2SUNet", "FusedMBConv", "MBConv", "MBDeconv", "MODEL_NAMES", "ResNetEncoder",
    "UNet", "VGGUNet", "VGGUNetDecoder", "VGGUNetEncoder", "build_model",
    "from_flax_variables", "optimizer_from_flax", "optimizer_to_flax", "resnet34", "resnet50",
    "to_flax_variables",
]
