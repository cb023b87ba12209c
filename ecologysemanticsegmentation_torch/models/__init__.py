"""Model zoo of the port.  Only the flagship DeepLabV3+ (resnet34) is ported;
``build_model`` keeps the JAX package's names and raises for the others."""

from __future__ import annotations

import torch

from .. import resolve_device
from .deeplabv3plus import DeepLabV3Plus
from .from_flax import (
    from_flax_variables,
    optimizer_from_flax,
    optimizer_to_flax,
    to_flax_variables,
)

MODEL_NAMES = (
    "deeplabv3plus", "deeplabv3plus_depthwise", "unet", "vgg_unet",
    "efficientnet_v2s_unet",
)


def build_model(name: str = "deeplabv3plus", num_classes: int = 1,
                upsample_head: bool = True, device=None) -> torch.nn.Module:
    """The named model on ``device`` (CUDA unless ``device="cpu"``), in
    ``channels_last`` memory.  ``upsample_head=False`` makes DeepLabV3+ emit
    1/4-resolution logits for the fused head loss; the parameters are the
    same either way."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; choose from {MODEL_NAMES}")
    if name != "deeplabv3plus":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    model = DeepLabV3Plus(num_classes=num_classes, upsample_head=upsample_head)
    return model.to(device=resolve_device(device), memory_format=torch.channels_last)


__all__ = [
    "DeepLabV3Plus", "MODEL_NAMES", "build_model", "from_flax_variables", "optimizer_from_flax",
    "optimizer_to_flax", "to_flax_variables",
]
