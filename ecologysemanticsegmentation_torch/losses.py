"""Loss library, the subset on the flagship train step (PyTorch port of
``ecologysemanticsegmentation_tpu/losses.py``).

NHWC tensors, one channel per organ, labels in {0, 1} with ``-1`` ignored.
The reference's quirks are kept as the JAX package keeps them: the 7-tuple
order ``[ce, bce, focal, dice, generalized_dice, twersky, focal_dice]``, the
BCE-with-logits formula applied to probabilities (row 6 of the sums), ``p*p``
dice denominators, the x2 standard-dice background denominator, negative
dice, and the x3.3 multiplier on the dice family.
"""

from __future__ import annotations

from typing import Sequence

import torch

EPS = 1e-7

# Index names for the 7-loss tuple.
LOSS_NAMES = ("ce", "bce", "focal", "dice", "generalized_dice", "twersky", "focal_dice")


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits, mean over the non-ignored (``targets >= 0``) elements:
    ``mean(max(x, 0) - x*y + log(1 + exp(-|x|)))``."""
    x, y = logits, targets
    w = (y >= 0).float()
    per = torch.clamp(x, min=0.0) - x * (y * w) + torch.log1p(torch.exp(-x.abs()))
    return (w * per).sum() / torch.clamp(w.sum(), min=1.0)


def seven_from_sums(sums: torch.Tensor, background_weight: float | torch.Tensor = 0.0
                    ) -> torch.Tensor:
    """The (7, C) loss tuple from the (8, C) sums [Σg, Σp, Σp², Σgp, focal-fg,
    focal-bg, bce-p-part, N]; ``N`` is guarded with ``max(N, 1)`` so a channel
    ignored everywhere gives constants instead of 0/0."""
    bg = background_weight
    s_g, s_p, s_pp, s_gp, s_flfg, s_flbg, s_bce, n = sums.unbind(0)

    n = torch.clamp(n, min=1.0)
    ce = torch.zeros_like(s_g)
    bce = (s_bce - s_gp) / n
    focal = (-s_flfg - bg * s_flbg) / n

    s_g0p0 = n - s_g - s_p + s_gp
    s_g1_p1sq = s_g + s_pp
    s_g0_p0sq = 2.0 * n - s_g - 2.0 * s_p + s_pp

    dice_fg = (2.0 * s_gp + EPS) / (s_g1_p1sq + EPS)
    dice_bg = (2.0 * s_g0p0 + EPS) / (2.0 * s_g0_p0sq + EPS)
    dice = -dice_fg - bg * dice_bg

    gd_fg = (s_gp + EPS) / (s_g1_p1sq + EPS)
    gd_bg = (s_g0p0 + EPS) / (s_g0_p0sq + EPS)
    generalized_dice = -(gd_fg + bg * gd_bg)

    alpha, beta = 0.5, 0.3
    tw_fg_d = s_gp + alpha * (s_g - s_gp) + beta * (s_p - s_gp)
    tw_fg = -(s_gp + EPS) / (tw_fg_d + EPS)
    tw_bg_d = s_g0p0 + alpha * (s_p - s_gp) + beta * (s_g - s_gp)
    tw_bg = -(s_g0p0 + EPS) / (tw_bg_d + EPS)
    twersky = tw_fg + bg * tw_bg

    gamma = 1.8
    fdc_fg = (2.0 * s_gp + EPS) / (s_g1_p1sq + EPS)
    fdc_bg = (2.0 * s_g0p0 + EPS) / (s_g0_p0sq + EPS)
    fd_fg = -torch.pow(1.0 - fdc_fg, gamma) * torch.log(fdc_fg + EPS)
    fd_bg = -torch.pow(1.0 - fdc_bg, gamma) * torch.log(fdc_bg + EPS)
    focal_dice = fd_fg + bg * fd_bg

    m = 10.0 * 0.33
    return torch.stack(
        [ce, bce, focal, dice * m, generalized_dice * m, twersky * m, focal_dice * m]
    )


def seven_losses_lowres(logits_lr: torch.Tensor, g: torch.Tensor,
                        background_weight: float | torch.Tensor = 0.0) -> torch.Tensor:
    """The (7,) loss vector, summed over organs, of
    ``sigmoid(upsample_x4(logits_lr))`` against full-resolution labels ``g``,
    through the fused head-loss kernel.  Multi-organ only (``C > 1``): the
    reference's per-channel recursion restores the gt/pred roles and drops
    ``background_weight``."""
    del background_weight  # dropped by the reference's multi-organ recursion
    if g.shape[-1] <= 1:
        raise ValueError("seven_losses_lowres is multi-organ only")
    from .ops.head_loss import fused_head_loss_sums

    # Labels are exactly {-1, 0, 1}, so bf16 halves the kernel's label bytes
    # losslessly.
    sums = fused_head_loss_sums(logits_lr, g.to(torch.bfloat16))
    return seven_from_sums(sums, 0.0).sum(-1)


def dice_score(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-organ evaluation Dice, shape (C,), with the reference's call-site
    argument swap; ``-1`` label pixels drop out of both sums."""
    g, p = pred.float(), gt.float()  # call-site swap
    w = (p >= 0).float()
    p = p * w
    red = (0, 1, 2)
    num = 2.0 * (g * p).sum(red) + EPS
    den = (w * (g + p * p)).sum(red) + EPS
    return num / den


def return_union_sets_descending_order(ann: torch.Tensor, exclude_indices: Sequence[int] = (0,),
                                       reverse: bool = False) -> torch.Tensor:
    """Union-set label transform over the organ (last) axis, NHWC.

    Forward: channel ``k`` becomes the clipped union of channels ``k..C-1``;
    ``-1`` channels are left out of the union, and a channel whose own label
    is ``-1`` stays ``-1``.  Reverse: adjacent absolute differences, from the
    second-to-last channel down.  Channels in ``exclude_indices`` are left
    untouched."""
    C = ann.shape[-1]
    excl = {int(i) for i in exclude_indices}
    out = ann.clone()
    if not reverse:
        pos = torch.clamp(ann, min=0)
        for idx in range(C - 1):
            if idx in excl:
                continue
            union = pos[..., idx:].sum(-1)
            out[..., idx] = torch.where(ann[..., idx] < 0, ann[..., idx], union)
        return torch.clamp(out, max=1)
    for idx in range(C - 2, -1, -1):
        if idx in excl:
            continue
        out[..., idx] = (out[..., idx] - out[..., idx + 1]).abs()
    return out
