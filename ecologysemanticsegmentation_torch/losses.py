"""Loss library (PyTorch port of ``ecologysemanticsegmentation_tpu/losses.py``):
the 7-loss tuple at full and at 1/4 resolution, the composite set-theory
losses, the list variants, the union transform and the eval Dice.

NHWC tensors, one channel per organ, labels in {0, 1} with ``-1`` ignored.
The reference's quirks are kept as the JAX package keeps them: the 7-tuple
order ``[ce, bce, focal, dice, generalized_dice, twersky, focal_dice]``, the
BCE-with-logits formula applied to probabilities (row 6 of the sums), ``p*p``
dice denominators, the x2 standard-dice background denominator, negative
dice, the x3.3 multiplier on the dice family, and the argument roles: call
sites pass ``(pred, gt)`` to ``(gt, pred)`` signatures, the multi-organ
per-channel recursion swaps them back (and drops ``background_weight``), and
single-organ calls stay swapped all the way into the sums.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.loss_sums import loss_sums_nhwc

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


def prob_cross_entropy(pred: torch.Tensor, target_probs: torch.Tensor,
                       axis: int = -1) -> torch.Tensor:
    """Probability-target cross entropy, ``mean(-sum(p * log_softmax(x), axis))``;
    identically 0 on a width-1 channel axis (the reference's ``ce`` slot)."""
    logp = torch.log_softmax(pred, dim=axis)
    return (-(target_probs * logp).sum(axis)).mean()


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


def _seven_per_channel(gt: torch.Tensor, pred: torch.Tensor,
                       background_weight: float | torch.Tensor = 0.0) -> torch.Tensor:
    """The (7, C) tuple of each channel, from the eight sums of
    ``loss_sums_nhwc(pred, gt)`` (the loss-sums kernel on a CUDA tensor)."""
    sums = loss_sums_nhwc(pred.float(), gt.float())
    return seven_from_sums(sums, background_weight)


def seven_losses(x: torch.Tensor, g: torch.Tensor,
                 background_weight: float | torch.Tensor = 0.0) -> torch.Tensor:
    """The reference's ``losses_fn``: the (7,) loss vector of sigmoided
    predictions ``x`` against labels ``g``, summed over organs.

    Multi-organ (``C > 1``) takes (gt=g, pred=x) and drops
    ``background_weight``, as the reference's per-channel recursion does.
    Single-organ keeps the call-site swap: the sums are taken with the
    labels in the prediction slot and the predictions in the label slot, so
    the ignore mask is taken on the predictions and the gradient reaches
    ``x`` through the label slot."""
    if x.shape[-1] > 1:
        gt, pred = g, x
        background_weight = 0.0  # dropped by the reference's recursion
    else:
        gt, pred = x, g
    return _seven_per_channel(gt, pred, background_weight).sum(-1)


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
    # losslessly.  (A float64 model's logits may come out of cuDNN in NCHW
    # memory, which the NHWC kernel reads only after a copy.)
    sums = fused_head_loss_sums(logits_lr.contiguous(), g.to(torch.bfloat16).contiguous())
    return seven_from_sums(sums, 0.0).sum(-1)


def seven_losses_lowres_spatial(logits_lr: torch.Tensor, g: torch.Tensor, mesh,
                                background_weight: float | torch.Tensor = 0.0) -> torch.Tensor:
    """:func:`seven_losses_lowres` of a batch split over ``mesh``'s ranks:
    ``logits_lr`` (B_l, h_l, w, C) and ``g`` (B_l, H_l, W, C) are this
    rank's row block.  The 1/4-resolution logits are gathered over the model
    group (they are ~16x smaller than the labels; the JAX package replicates
    them), the per-shard head-loss kernel sums this rank's label rows, and
    one all-reduce over the world gives every rank the global (8, C) sums
    (its backward passes the cotangent through: every rank computes this
    same loss)."""
    del background_weight  # dropped by the reference's multi-organ recursion
    if g.shape[-1] <= 1:
        raise ValueError("seven_losses_lowres is multi-organ only")
    from .ops.head_loss import fused_head_loss_sums_shard
    from .parallel.collectives import all_gather_rows, all_reduce_sum

    x = logits_lr
    if mesh.model > 1:
        x = all_gather_rows(x, 1, mesh.model_group, mesh.model_index, mesh.model)
    rows = g.shape[1]
    part = fused_head_loss_sums_shard(x.contiguous(), g.to(torch.bfloat16).contiguous(),
                                      rows * mesh.model, rows * mesh.model_index)
    sums = all_reduce_sum(part, mesh.world, grad="identity")
    return seven_from_sums(sums, 0.0).sum(-1)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative at 0, +1 (``torch.abs`` gives 0 there),
    so a tie between two organs' probabilities sends the reference's
    gradient."""
    return torch.where(x >= 0, x, -x)


def intersection_loss(superset_p: torch.Tensor, set_p: torch.Tensor,
                      set_g: torch.Tensor) -> torch.Tensor:
    """``losses_fn(superset_p * set_p, set_g)``, doubled as every
    single-channel composite term is (reference ``loss_composite.py:42``)."""
    return 2.0 * seven_losses(superset_p * set_p, set_g)


def union_loss(superset_p: torch.Tensor, set_p: torch.Tensor,
               superset_g: torch.Tensor) -> torch.Tensor:
    """Regularized union loss with the label in the prediction slot, as the
    reference passes it; doubled as :func:`intersection_loss`."""
    union_expr = superset_p * (1.0 - set_p) + (superset_p * set_p + set_p) * 0.5
    return 2.0 * seven_losses(superset_g, union_expr)


def seven_losses_composite_general(
    x: torch.Tensor,
    g: torch.Tensor,
    background_weight: float | torch.Tensor = 0.0,
    relative_set_ratios: Sequence[float] = (1.0, 0.43197708, 0.22319692),
    early_stop_weights=None,
) -> torch.Tensor:
    """The generalized composite set-theory ``losses_fn``
    (reference ``loss_composite.py:22-81``): the doubled base tuple plus, for
    every superset ``idx`` and subset ``jdx > idx``, intersection,
    regularized-union, difference-set and Russel's-paradox terms weighted by
    ``1/relative_set_ratios``.

    ``early_stop_weights``: host jitter factors of shape ``(num_pairs, 3)``
    for ``(w_idx, w_jdx, w_diff)`` per pair (:func:`composite_jitters`; a
    tensor is read back to the host once), or None for no jitter."""
    C = g.shape[-1]
    ratios = list(relative_set_ratios)
    if isinstance(early_stop_weights, torch.Tensor):
        early_stop_weights = early_stop_weights.detach().cpu().numpy()

    total = seven_losses(x, g, background_weight) * 2.0
    pair_idx = 0
    for idx in range(C - 1):
        for jdx in range(idx + 1, C):
            if early_stop_weights is None:
                j_i = j_j = j_d = 1.0
            else:
                j_i, j_j, j_d = (float(v) for v in early_stop_weights[pair_idx][:3])
            pair_idx += 1

            w_idx = (1.0 / ratios[idx]) * j_i
            w_jdx = (1.0 / ratios[jdx]) * j_j
            w_diff = (1.0 / (ratios[idx] - ratios[jdx])) * j_d

            xs, xj = x[..., idx:idx + 1], x[..., jdx:jdx + 1]
            gs, gj = g[..., idx:idx + 1], g[..., jdx:jdx + 1]
            xdiff = _abs(xs - xj)
            gdiff = _abs(gs - gj)

            total = total + intersection_loss(xs, xj, gj) * w_jdx
            total = total + union_loss(xs, xj, gs) * w_idx
            total = total + intersection_loss(xs, xdiff, gdiff) * w_diff
            total = total + union_loss(xs, xdiff, gs) * w_idx
            total = total + intersection_loss(xs, xdiff * xs, gdiff) * w_diff
            total = total + union_loss(xs, xdiff * xs, gs) * (w_idx * w_idx * w_jdx)
    return total


def sequential_cross_organ_losses(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The sequential trainer's executed loss (reference
    ``train_multiclass_sequential_densenetloss.py:279-290``): the per-organ
    tuples summed plus ``losses_fn(g1 - g2, |x1 - x2|)``, a single-channel
    call (so swapped) with no abs on the label difference."""
    if x.shape[-1] < 3:
        raise ValueError("the sequential cross-organ loss needs at least 3 organs")
    base = seven_losses(x, g)
    cross = seven_losses(g[..., 1:2] - g[..., 2:3], _abs(x[..., 1:2] - x[..., 2:3]))
    return base + cross


def sequential_densenet_composite_deadbranch(
    x: torch.Tensor,
    g: torch.Tensor,
    background_weight: float | torch.Tensor = 0.0,
    early_stop_jitters=None,
) -> torch.Tensor:
    """Working form of the sequential script's unreachable composite branch
    (reference ``train_multiclass_sequential_densenetloss.py:304-362``), as
    the JAX package implements it.  ``early_stop_jitters``: (2,) factors
    for the ventral-union and dorsal weights, or None for 1.0."""
    base = seven_losses(x, g, background_weight)

    wb_g, wb_p = g[..., 0:1], x[..., 0:1]
    vu_g, vu_p = g[..., 1:2], x[..., 1:2]
    ds_g, ds_p = g[..., 2:3], x[..., 2:3]
    vs_g = _abs(vu_g - ds_g)
    vs_p = _abs(vu_p - ds_p)

    if early_stop_jitters is None:
        jv, jd = 1.0, 1.0
    else:
        jv, jd = float(early_stop_jitters[0]), float(early_stop_jitters[1])
    ventral_union_w = 2.4376792669332903 * jv
    dorsal_side_w = 4.480348563949717 * jd
    ventral_side_w = 4.789727146487483  # the branch's NameError, per its comment

    def union_expr(sup_p, sub_p):
        return sup_p * (1.0 - sub_p) + (sup_p * sub_p + sub_p) * 0.5

    vu_neg = seven_losses(vu_g, wb_p * vu_p)
    vs_neg = seven_losses(vs_g, wb_p * vs_p)
    vr_neg = seven_losses(vs_g, vu_p * vs_p)
    ds_neg = seven_losses(ds_g, wb_p * ds_p)
    du_neg = seven_losses(ds_g, vu_p * ds_p)

    vu_pos = seven_losses(wb_g, union_expr(wb_p, vu_p))
    vs_pos = seven_losses(wb_g, union_expr(wb_p, vs_p))
    vr_pos = seven_losses(vs_g, union_expr(vu_p, vs_p))
    ds_pos = seven_losses(wb_g, union_expr(wb_p, ds_p))
    du_pos = seven_losses(vu_g, union_expr(vu_p, ds_p))

    r1 = (base + ventral_side_w * (vs_neg + ds_neg)
          + ventral_union_w * (vu_neg + du_neg) + 4.0 * vr_neg)
    r2 = (base + dorsal_side_w * (2.0 * ds_pos + vs_pos)
          + vu_pos + 4.0 * ventral_union_w * du_pos + 4.0 * vr_pos)
    return r1 + r2


# The earlier name of the dead-branch form, kept as the JAX package keeps it.
sequential_densenet_composite = sequential_densenet_composite_deadbranch


def composite_jitters(rng: np.random.RandomState | None, num_pairs: int,
                      early_stopped: bool) -> np.ndarray:
    """Host early-stop jitter factors ``1 - early_stopped * choice([0,1]) * rand()``
    (reference ``loss_composite.py:48-52``), numpy as in the JAX package."""
    if not early_stopped:
        return np.ones((num_pairs, 3), np.float64)
    rng = rng or np.random.RandomState()
    return 1.0 - rng.randint(0, 2, (num_pairs, 3)) * rng.rand(num_pairs, 3)


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


def _zeros(shape, preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """f32 zeros on the pyramid's device: the list variants' accumulator."""
    return torch.zeros(shape, dtype=torch.float32,
                       device=preds[0].device if len(preds) else None)


def binary_cross_entropy_list(gts: Sequence[torch.Tensor],
                              preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Deep-supervision BCE summed over a pyramid of (gt, pred) pairs; the
    reference's accumulator has 6 slots, so longer lists are rejected."""
    if len(gts) > 6:
        raise ValueError("binary_cross_entropy_list supports at most 6 levels")
    total = _zeros((), preds)
    for y, p in zip(gts, preds):
        total = total + binary_cross_entropy(p, y)
    return total


def cross_entropy_list(gts: Sequence[torch.Tensor],
                       preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Working form of the reference's ``cross_entropy_list``: the sum of
    :func:`prob_cross_entropy` over the pyramid."""
    total = _zeros((), preds)
    for y, p in zip(gts, preds):
        total = total + prob_cross_entropy(p, y)
    return total


def focal_list(gts: Sequence[torch.Tensor], preds: Sequence[torch.Tensor],
               factor: float = 0.1) -> torch.Tensor:
    """Working form of the reference's ``focal_list``: ``factor`` times the
    mean of ``-(1-p)^1.5 log(p+eps)`` per level, summed."""
    total = _zeros((), preds)
    for _, p in zip(gts, preds):
        fl = -torch.pow(1.0 - p, 1.5) * torch.log(p + EPS)
        total = total + factor * fl.mean()
    return total


def classification_dice_list(gts: Sequence[torch.Tensor],
                             preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Working form of the reference's ``classification_dice_list``: the
    four dice-family losses per level with background weight 1 and the
    callee's default factor (multiplier 330), summed into a (4,) vector."""
    total = _zeros((4,), preds)
    for y, p in zip(gts, preds):
        per = _seven_per_channel(y, p, background_weight=1.0)
        total = total + 100.0 * per[3:7].sum(-1)
    return total


def relative_ratios(segments: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-organ positive-pixel ratios of NHWC binary ``segments``,
    normalized so the largest organ is 1 (reference ``fish_dataset.py:117-141``)."""
    del num_classes
    sums = segments.sum((0, 1, 2))
    return sums / torch.clamp(sums.max(), min=1.0)
