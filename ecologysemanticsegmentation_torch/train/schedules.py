"""LR schedules, the background-weight schedule and the loss curriculum
gates of the port (counterpart of
``ecologysemanticsegmentation_tpu/train/schedules.py``, equal to it at
every epoch).

Host-side and epoch-indexed, as the reference steps its schedulers.
"""

from __future__ import annotations

import numpy as np


def cosine_annealing_warm_restarts(
    base_lr: float, t_0: int = 100, eta_min: float = 0.0
):
    """torch ``CosineAnnealingWarmRestarts(optimizer, T_0)`` equivalent with
    T_mult=1 (reference ``train_multiclass.py:81,241-242`` steps it with
    ``epoch + 1``)."""

    def lr_at(epoch: int) -> float:
        t_cur = epoch % t_0
        return eta_min + (base_lr - eta_min) * (1 + np.cos(np.pi * t_cur / t_0)) / 2

    return lr_at


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(factor=0.75, patience=50, mode='min')``
    equivalent (reference sequential trainer ``..._densenetloss.py:81``)."""

    def __init__(self, base_lr: float, factor: float = 0.75, patience: int = 50):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


class BackgroundWeightSchedule:
    """The piecewise/randomized background-weight schedule
    (reference ``train_multiclass.py:50-72``):

    * keyed breakpoints 0 -> 0, 1.6·N/5 -> 0.5, 1.8·N/5 -> 0.7 (the N/5 -> 0.3
      entry exists in the dict but is shadowed because it is missing from the
      key list — kept shadowed here for parity),
    * from 2·N/5 every 100 epochs an alternating randomized weight:
      0.3 + 0.2·U[0,1) vs 0.7 − 0.3·U[0,1),
    * lookup returns the weight of the last breakpoint *before* the epoch;
      epoch 0 -> 0.

    Deviation: past the final breakpoint the reference's lookup falls off the
    list and returns ``None`` (a latent crash on the last epoch); we return
    the final weight instead.
    """

    def __init__(self, num_epochs: int, seed: int | None = None):
        rng = np.random.RandomState(seed)
        self.keys = [0, int(1.6 * num_epochs // 5), int(1.8 * num_epochs // 5)]
        self.weights = {
            0: 0.0,
            num_epochs // 5: 0.3,  # shadowed, see docstring
            int(1.6 * num_epochs // 5): 0.5,
            int(1.8 * num_epochs // 5): 0.7,
        }
        binary_flag = False
        for epoch_cycle in range(2 * num_epochs // 5, num_epochs, 100):
            if binary_flag:
                self.weights[epoch_cycle] = 0.3 + 0.2 * rng.rand()
            else:
                self.weights[epoch_cycle] = 0.7 - 0.3 * rng.rand()
            self.keys.append(epoch_cycle)
            binary_flag = not binary_flag

    def __call__(self, x: int) -> float:
        if x == 0:
            return 0.0
        for idx, b in enumerate(self.keys):
            if b > x:
                return float(self.weights[self.keys[idx - 1]])
        return float(self.weights[self.keys[-1]])


def curriculum_gates(epoch: int) -> dict[str, float]:
    """Loss curriculum weights (reference ``train_multiclass.py:92-100``):
    gates over generalized-dice/focal-dice/BCE/focal terms as epoch predicates.
    """
    generalized_dice_w = int(epoch < 1000) + int(1500 < epoch < 2500)
    generalized_dice_w = int(generalized_dice_w > 0)
    focal_dice_w = int(epoch > 2000) + int(
        generalized_dice_w != 1 or (2000 < epoch < 2500)
    )
    focal_dice_w = int(focal_dice_w > 0)
    bce_l_w = int(epoch < 2000) or int(epoch % 5 == 0)
    fl_l_w = int(1200 < epoch < 2000) or int(epoch % 6 == 0)
    return {
        "generalized_dice_w": float(generalized_dice_w),
        "focal_dice_w": float(focal_dice_w),
        "bce_l_w": float(bce_l_w),
        "fl_l_w": float(fl_l_w),
    }
