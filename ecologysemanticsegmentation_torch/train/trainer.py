"""Train step, eval step, train state and inference forward (PyTorch port
of ``ecologysemanticsegmentation_tpu/train/trainer.py``): device
augmentation, then either the fused low-resolution head loss (the flagship,
DeepLabV3+ with ``upsample_head=False``) or the full-resolution losses
(plain, sequential or general composite) through the loss-sums kernel.

On a CUDA device the model runs under bf16 autocast with float32 parameters
(the JAX package's bf16-compute/f32-params); on the CPU it runs in float32,
which is how the tests hold it against the JAX package's float32 model.

On a ``(data, model)`` mesh (:mod:`..parallel`) the same step runs on every
rank, each on its block of the batch: data parallelism, and with a model
axis above 1 the row-partitioned (``--spatial_partition``) step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
from torch import nn

from ..data import augment as _augment
from ..data.augment import augment_batch as _augment_batch_uniform
from ..data.augment import augment_batch_per_sample
from ..losses import (
    LOSS_NAMES,
    binary_cross_entropy,
    binary_cross_entropy_list,
    dice_score,
    return_union_sets_descending_order,
    sequential_cross_organ_losses,
    seven_losses,
    seven_losses_composite_general,
    seven_losses_lowres,
    seven_losses_lowres_spatial,
)
from ..models.common import BatchNorm2d
from ..models.deeplabv3plus import DeepLabV3Plus
from ..ops.loss_sums import spatial_mesh_context
from ..ops.resize import resize_nearest
from ..parallel.collectives import all_reduce_grads
from ..parallel.mesh import batch_block, row_block

# AUGMENT_PER_SAMPLE=1 (read at import, as the JAX trainer reads it) makes
# the step draw the augmentation per sample, the reference's granularity;
# the default draws the geometry and the OneOf choices once per batch.  A
# module attribute, looked up at each call, so a caller may rebind it.
augment_batch = augment_batch_per_sample if _augment.PER_SAMPLE else _augment_batch_uniform


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState``'s counterpart: the model holds the parameters
    and the BatchNorm statistics, the optimizer holds Adam's moments."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer | MultiSteps


class MultiSteps:
    """``optax.MultiSteps`` over a torch optimizer: each :meth:`step` folds
    the parameters' ``.grad`` into a running mean (optax's Welford form,
    ``acc + (g - acc) / (n + 1)``); the ``every_k``-th step hands the mean
    to the inner optimizer, which updates the parameters and advances its
    step count, and starts a new mean.  In between the parameters do not
    move.  ``param_groups`` and ``state`` are the inner optimizer's, so the
    train step sets the learning rate as it does on Adam."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k, self.mini_step = inner, int(every_k), 0
        self._params = [p for group in inner.param_groups for p in group["params"]]
        self._acc = [torch.zeros_like(p) for p in self._params]

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self._params, self._acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return
        for p, acc in zip(self._params, self._acc):
            p.grad = acc.clone()
            acc.zero_()
        self.mini_step = 0
        self.inner.step()


def make_optimizer(lr: float = 3e-4, grad_accum: int = 1
                   ) -> Callable[..., torch.optim.Optimizer | MultiSteps]:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), as a factory
    of parameters; the train step sets the learning rate on every call.

    ``grad_accum=K`` wraps it in :class:`MultiSteps` (the JAX package's
    ``optax.MultiSteps``): the mean of K micro-batch gradients feeds one
    Adam update.  BatchNorm statistics update on every micro-step, and the
    dice-family terms normalize over each micro-batch, as in the JAX
    package."""
    adam = functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if grad_accum == 1:
        return adam
    return lambda params: MultiSteps(adam(params), grad_accum)


def _truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: a normal truncated to +-2 std (inverse-CDF draw)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    draw = torch.empty(t.shape).uniform_(lo, hi, generator=generator)
    draw.erfinv_().mul_(std * math.sqrt(2)).clamp_(-2 * std, 2 * std)
    t.copy_(draw)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` as flax's ``model.init`` does: conv kernels
    lecun-normal (variance 1/fan_in, truncated), or kaiming-normal (variance
    2/fan_in, truncated) where the conv has ``variance_scale`` 2, conv
    biases 0, BatchNorm scale 1, bias 0, mean 0, var 1.  Draws on the host
    from ``generator``, so one seed gives the same weights on every
    device."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            scale = getattr(m, "variance_scale", 1.0)
            _truncated_normal_(m.weight, math.sqrt(scale / fan_in) / .87962566103423978,
                               generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def create_train_state(model: nn.Module, generator: torch.Generator,
                       tx: Callable[..., torch.optim.Optimizer]) -> TrainState:
    """Initialize ``model`` from ``generator`` (a seeded CPU generator) and
    build its optimizer with ``tx`` (:func:`make_optimizer`)."""
    init_weights(model, generator)
    return TrainState(step=0, model=model, optimizer=tx(model.parameters()))


def _prepare_labels(labels: torch.Tensor) -> torch.Tensor:
    """Binarize positives, then the union-set transform."""
    labels = torch.where(labels > 0, 1.0, labels)
    return return_union_sets_descending_order(labels)


def _autocast(device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=device.type == "cuda")


COMPOSITE_MODES = ("none", "general", "sequential")


def make_train_step(model: nn.Module, tx, composite_mode: str = "none", augment: bool = True,
                    loss_formula: str = "multiclass", deepsupervision: bool = False,
                    lowres_head: bool = False, k_steps: int = 1, scan_unroll: int = 1,
                    spatial_mesh=None) -> Callable:
    """The train step, with the JAX package's signature and defaults.

    ``step(state, batch, rng, bg_weight, gates3, lr, jitters) -> (state, metrics)``
    with ``batch = {"image": (B, H, W, 3), "label": (B, H, W, C)}`` NHWC,
    ``gates3 = [focal_dice_w, bce_w, generalized_dice_w]``.  ``rng`` is a
    ``torch.Generator`` on the model's device (ASPP dropout); with
    ``augment=True`` it is the pair ``(host_gen, device_gen)``: a CPU
    generator for the augmentation's batch-uniform draws and the device
    generator, which draws the augmentation's per-sample values and then
    the dropout masks.  Augmentation (this module's ``augment_batch``:
    :func:`..data.augment.augment_batch`, or
    :func:`..data.augment.augment_batch_per_sample` under
    ``AUGMENT_PER_SAMPLE=1``; CLAHE form from ``AUGMENT_TILED_CLAHE``) runs
    on the device before label prep, as in the JAX step.

    ``deepsupervision`` (a VGG U-Net built with it, which returns its logits
    and side heads): the loss adds
    :func:`..losses.binary_cross_entropy_list` of each side head's sigmoid
    against the prepared labels resized nearest to its resolution.

    ``lowres_head=False`` (a model built with ``upsample_head=True``): the
    loss is ``composite_mode``'s 7-tuple of ``sigmoid(logits)`` at full
    resolution through the loss-sums kernel: "none" is
    :func:`..losses.seven_losses` with ``bg_weight`` (which only a
    single-organ model uses), "sequential" the sequential trainer's
    :func:`..losses.sequential_cross_organ_losses`, "general"
    :func:`..losses.seven_losses_composite_general` with ``jitters`` as its
    early-stop weights (None for none).  ``lowres_head=True`` (a model built
    with ``upsample_head=False``): the fused low-resolution head loss,
    plain multi-organ losses only.  ``loss_formula`` ("multiclass" or
    "sequential") names the trainer whose gate sum is used; both sums are
    the same.

    ``spatial_mesh`` (a :class:`..parallel.Mesh`, this rank's place in a
    ``(data, model)`` grid on the model's device): every rank calls the step
    with the same global batch and keeps its block, the batch block of its
    data index and the row block of its model index; the model runs on the
    block (:mod:`..models.deeplabv3plus`), the loss's (8, C) sums are
    all-reduced over the world before ``seven_from_sums``
    (:func:`..losses.seven_losses_lowres_spatial`, or the full-resolution
    losses inside :func:`..ops.loss_sums.spatial_mesh_context`), and the
    parameter gradients are summed over the world after backward, so every
    rank takes the one-rank step on the global batch.  A model axis of 1 is
    plain data parallelism.  The ranks must start from the same weights
    (:func:`..parallel.broadcast_state`), and the ranks of one data group
    must draw the same random values (seed ``rng``'s device generator per
    data group, its host generator the same on every rank): with
    ``augment=True`` each rank augments its data group's whole images and
    keeps its rows, and the gathered 1/16 stage draws one dropout mask.
    ``k_steps`` and ``scan_unroll`` are the JAX signature's; only their
    defaults are ported.

    ``state`` is updated in place and returned.  ``tx`` is consumed by
    :func:`create_train_state`, which puts the optimizer in the state."""
    if composite_mode not in COMPOSITE_MODES:
        raise ValueError(f"composite_mode {composite_mode!r} is not one of {COMPOSITE_MODES}")
    if loss_formula not in ("multiclass", "sequential"):
        raise ValueError(f"loss_formula {loss_formula!r} is not 'multiclass' or 'sequential'")
    if lowres_head and composite_mode != "none":
        raise ValueError("lowres_head folds the upsample into the plain seven_losses path; "
                         f"composite_mode={composite_mode!r} needs lowres_head=False")
    if lowres_head and deepsupervision:
        raise ValueError("lowres_head folds the upsample into the plain seven_losses path; "
                         "deepsupervision needs lowres_head=False")
    if k_steps != 1:
        raise NotImplementedError("k_steps > 1 is the JAX package's scan of steps in one "
                                  "dispatch, which amortizes TPU dispatch and changes no "
                                  "result; it is not ported (ROADMAP, 'Not ported on purpose')")
    mesh = spatial_mesh
    if mesh is not None:
        if not hasattr(mesh, "spatial"):
            raise TypeError(f"spatial_mesh must be a parallel.Mesh, got {type(mesh).__name__}")
        if not isinstance(model, DeepLabV3Plus):
            raise NotImplementedError(f"the step on a mesh runs DeepLabV3+; "
                                      f"{type(model).__name__} on a mesh comes with the "
                                      "multi-rank trainers (ROADMAP queue 1, item 10)")
        if mesh.device != next(model.parameters()).device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the model is on "
                             f"{next(model.parameters()).device}")
    spatial = mesh.spatial() if mesh is not None else None
    del tx, scan_unroll

    def seven_fn(probs, labels, bg_weight, jitters):
        if composite_mode == "general":
            return seven_losses_composite_general(probs, labels, bg_weight,
                                                  early_stop_weights=jitters)
        if composite_mode == "sequential":
            return sequential_cross_organ_losses(probs, labels)
        return seven_losses(probs, labels, bg_weight)

    def step(state: TrainState, batch, rng, bg_weight, gates3, lr, jitters):
        if state.model is not model:
            raise ValueError("state was created for another model")
        param = next(model.parameters())
        dev = param.device
        images = torch.as_tensor(batch["image"], device=dev)
        labels = torch.as_tensor(batch["label"], device=dev)
        if mesh is not None:
            images, labels = batch_block(images, mesh), batch_block(labels, mesh)
        if augment:
            if not (isinstance(rng, tuple) and len(rng) == 2):
                raise TypeError("with augment=True, rng is the pair (host_gen, device_gen)")
            images, labels = augment_batch(rng, images, labels)
            rng = rng[1]
        if mesh is not None:
            images, labels = row_block(images, mesh), row_block(labels, mesh)
        labels = _prepare_labels(labels)
        # Images are rounded to bf16 before the model, as in the JAX step.
        images = images.to(torch.bfloat16).to(param.dtype)
        gates = torch.as_tensor(gates3, dtype=torch.float32, device=dev)

        model.train()
        with _autocast(dev):
            out = (model(images, generator=rng) if mesh is None
                   else model(images, generator=rng, spatial=spatial))
        if deepsupervision:
            out, heads = out
        if lowres_head:
            seven = (seven_losses_lowres(out, labels) if mesh is None
                     else seven_losses_lowres_spatial(out, labels, mesh))
        elif mesh is None:
            seven = seven_fn(torch.sigmoid(out.float()), labels, bg_weight, jitters)
        else:
            with spatial_mesh_context(mesh):
                seven = seven_fn(torch.sigmoid(out.float()), labels, bg_weight, jitters)
        loss = gates[0] * seven[6] + gates[1] * seven[1] + gates[2] * (seven[4] + seven[5])
        if deepsupervision:
            loss = loss + binary_cross_entropy_list(
                [resize_nearest(labels, h.shape[1:3]) for h in heads],
                [torch.sigmoid(h.float()) for h in heads])

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh.world)
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()
        state.step += 1

        metrics = {name: seven[i].detach() for i, name in enumerate(LOSS_NAMES)}
        metrics["loss"] = loss.detach()
        metrics["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        return state, metrics

    return step


def make_eval_step(model: nn.Module, apply_union_reverse: bool = False) -> Callable:
    """Eval step: forward, sigmoid, per-organ Dice and the val BCE.

    ``eval_step(state, batch) -> {"probs", "dice", "bce", "valid"}``:
    probabilities (B, H, W, C) f32 of the main head (a tuple output's
    first element), the per-organ :func:`..losses.dice_score` against the
    binarized labels, :func:`..losses.binary_cross_entropy` of the
    probabilities, and ``valid`` (C,), 1 where the batch has a non-ignored
    label pixel of the organ.  ``apply_union_reverse`` turns the predicted
    nested unions back into organ sets before scoring (the sequential
    evaluator).  ``state`` is accepted for the JAX signature; the model holds
    its weights."""

    @torch.no_grad()
    def eval_step(state, batch):
        del state
        param = next(model.parameters())
        dev = param.device
        images = torch.as_tensor(batch["image"], device=dev).to(torch.bfloat16).to(param.dtype)
        labels = torch.as_tensor(batch["label"], device=dev)
        labels = torch.where(labels > 0, 1.0, labels)
        model.eval()
        with _autocast(dev):
            out = model(images)
        if isinstance(out, tuple):
            out = out[0]
        probs = torch.sigmoid(out.float())
        scored = probs
        if apply_union_reverse:
            scored = return_union_sets_descending_order(probs, reverse=True)
        dice = dice_score(scored, labels)
        valid = ((labels >= 0).sum((0, 1, 2)) > 0).float()
        bce = binary_cross_entropy(probs, labels)
        return {"probs": probs, "dice": dice, "bce": bce, "valid": valid}

    return eval_step


def make_forward(model: nn.Module) -> Callable:
    """Inference forward: ``forward(state, images) -> sigmoid probabilities``
    (NHWC, float32).  ``state`` is accepted for the JAX signature; the model
    holds its weights."""

    @torch.no_grad()
    def forward(state, images):
        del state
        param = next(model.parameters())
        dev = param.device
        x = torch.as_tensor(images, device=dev).to(torch.bfloat16).to(param.dtype)
        model.eval()
        with _autocast(dev):
            out = model(x)
        if isinstance(out, tuple):  # deep supervision: the main head
            out = out[0]
        return torch.sigmoid(out.float())

    return forward
