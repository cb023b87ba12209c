"""PyTorch/CUDA port of ``ecologysemanticsegmentation_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package, module for module; the JAX package is
the reference the port is tested against, and the port imports nothing of
it (nor of JAX).  Public functions keep the JAX package's NHWC layout.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, CUDA by default; raises when CUDA is
    asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


# Imported after resolve_device, which the submodules use.
from .losses import (  # noqa: E402
    EPS,
    LOSS_NAMES,
    binary_cross_entropy,
    dice_score,
    return_union_sets_descending_order,
    seven_from_sums,
    seven_losses_lowres,
)
from .models import build_model  # noqa: E402
from .train import (  # noqa: E402
    TrainState,
    create_train_state,
    make_forward,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "EPS", "LOSS_NAMES", "TrainState", "binary_cross_entropy", "build_model",
    "create_train_state", "dice_score", "make_forward", "make_optimizer", "make_train_step",
    "resolve_device", "return_union_sets_descending_order", "seven_from_sums",
    "seven_losses_lowres",
]
