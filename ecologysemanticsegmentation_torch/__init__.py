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
    binary_cross_entropy_list,
    classification_dice_list,
    composite_jitters,
    cross_entropy_list,
    dice_score,
    focal_list,
    intersection_loss,
    prob_cross_entropy,
    relative_ratios,
    return_union_sets_descending_order,
    sequential_cross_organ_losses,
    sequential_densenet_composite,
    sequential_densenet_composite_deadbranch,
    seven_from_sums,
    seven_losses,
    seven_losses_composite_general,
    seven_losses_lowres,
    seven_losses_lowres_spatial,
    union_loss,
)
from .models import build_model  # noqa: E402
from .train import (  # noqa: E402
    TrainState,
    create_train_state,
    make_eval_step,
    make_forward,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "EPS", "LOSS_NAMES", "TrainState", "binary_cross_entropy", "binary_cross_entropy_list",
    "build_model", "classification_dice_list", "composite_jitters", "create_train_state",
    "cross_entropy_list", "dice_score", "focal_list", "intersection_loss", "make_eval_step",
    "make_forward", "make_optimizer", "make_train_step", "prob_cross_entropy",
    "relative_ratios", "resolve_device", "return_union_sets_descending_order",
    "sequential_cross_organ_losses", "sequential_densenet_composite",
    "sequential_densenet_composite_deadbranch", "seven_from_sums", "seven_losses",
    "seven_losses_composite_general", "seven_losses_lowres", "seven_losses_lowres_spatial",
    "union_loss",
]
