"""Main trainer CLI of the port:
``python -m ecologysemanticsegmentation_torch.train_multiclass``.

The JAX package's ``train_multiclass`` on one NVIDIA card, with its flags,
names and defaults:

* env ``EXPTNAME``/``ORGANS``/``IMGSIZE``/``MAXCHANNELS``/``SAMPLE``;
  ``--model`` (DeepLabV3+ by default) with ``--encoder`` (resnet34 or
  resnet50) and ``classes=len(ORGANS)``; ``--deepsupervision`` trains the
  VGG U-Net with its side heads, at ``max_channels=MAXCHANNELS``, and
  ``--remat`` recomputes its stages in backward;
* per epoch the curriculum gates, the background weight and the cosine
  learning rate (T_0 = 100, stepped with ``epoch + 1``);
* ``Batcher(pad_final=True)``, each batch staged in pinned memory and
  copied to the card one batch ahead (:func:`..data.cuda_prefetch`);
  images per second count the batch's distinct (``n_real``) images;
* a checkpoint every 10 epochs and a final one, at
  ``models/<EXPT>/channels<MC>/img<SZ>/<EXPT>_epoch<N>.ckpt``, in the JAX
  package's msgpack format; resume from the latest (or ``--start_epoch``);
* the val BCE loop and PNG triplets of the first 10 val images in
  ``val_images/<epoch>/``; ``metrics.csv`` in ``models/<EXPT>/``.

DeepLabV3+ with more than one organ trains on 1/4-resolution logits through
the fused head loss unless ``--no_fused_head_loss`` (or
``--deepsupervision``); eval uses the full-resolution view of the same
parameters.  Every other model trains on full-resolution logits through
the loss-sums kernel.  Each step draws its random
values from generators seeded by ``(seed, epoch * 1_000_003 + i)``, as the
JAX package folds its key, so a resumed run draws what an unbroken run
would.  The step's metrics come to the host in one transfer a step.

The card is the default device and the run raises without one;
``--platform cpu`` is the only way to run on the CPU.  Flags whose parts are
not ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch_size", default=7, type=int,
                    help="Global batch size (reference default 7; README suggests 54)")
    ap.add_argument("--start_epoch", default=0, type=int,
                    help="Resume from a specific epoch (0 = latest checkpoint)")
    ap.add_argument("--lr", default=0.0003, type=float, help="Adam learning rate")
    ap.add_argument("--num_epochs", default=5000, type=int)
    ap.add_argument("--early_stop_epoch", default=500, type=int)
    ap.add_argument("--dataset", default="registry", choices=["registry", "synthetic"],
                    help="'synthetic' = in-memory fixture dataset, no data dir needed")
    ap.add_argument("--models_dir", default="models")
    ap.add_argument("--model", default="deeplabv3plus")
    ap.add_argument("--encoder", default="resnet34")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; the default (or 'gpu', 'cuda') is the card")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--log_every", default=None, type=int)
    ap.add_argument("--no_augment", action="store_true")
    ap.add_argument("--deepsupervision", action="store_true",
                    help="Train vgg_unet with side heads + BCE label pyramids")
    ap.add_argument("--ckpt", default="msgpack", choices=["msgpack", "orbax"],
                    help="Checkpoint backend: msgpack = reference filename "
                         "layout (orbax is not ported yet)")
    ap.add_argument("--spatial_partition", default=1, type=int,
                    help="shard image rows over a mesh 'model' axis of this "
                         "size (needs the multi-rank CLI, not ported yet; "
                         "1 = one rank)")
    ap.add_argument("--no_fused_head_loss", action="store_true",
                    help="Disable folding the head's x4 upsample + sigmoid "
                         "into the fused loss kernel (on by default for "
                         "multi-organ deeplabv3plus; parameters and "
                         "checkpoints are identical either way)")
    ap.add_argument("--grad_accum", default=1, type=int,
                    help="Average this many micro-batch gradients into "
                         "one Adam update; resume with the same value")
    ap.add_argument("--remat", action="store_true",
                    help="Per-stage rematerialization for vgg_unet (recomputes "
                         "activations in backward; numerics and checkpoints "
                         "unchanged)")
    ap.add_argument("--aot_cache", default=None, metavar="DIR",
                    help="Cache of the compiled train step (not ported yet)")
    return ap


def _unported(args) -> str | None:
    """Why ``args`` asks for a part that is not ported, or None."""
    if args.aot_cache:
        return "--aot_cache is not ported yet (ROADMAP queue 1, item 11)"
    if args.spatial_partition > 1:
        return ("--spatial_partition > 1 needs the multi-rank CLI, not ported yet "
                "(ROADMAP queue 1, item 10)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return "a launch of more than one rank needs the multi-rank CLI (ROADMAP queue 1, item 10)"
    return None


def device_of(platform: str | None):
    """The device of ``--platform``: the card unless ``cpu``."""
    from . import resolve_device

    if platform not in (None, "cpu", "gpu", "cuda"):
        raise ValueError(f"--platform {platform!r}: use 'cpu', or 'gpu'/'cuda' (the default)")
    return resolve_device("cpu" if platform == "cpu" else "cuda")


def step_generators(seed: int, key: int, device, augment: bool):
    """The step's random streams, seeded from ``(seed, key)`` alone: the pair
    ``(host_gen, device_gen)`` with augmentation, else ``device_gen``."""
    import torch

    host_seed, device_seed = np.random.SeedSequence([seed, key]).generate_state(2, np.uint64)
    device_gen = torch.Generator(device=device).manual_seed(int(device_seed))
    if not augment:
        return device_gen
    return torch.Generator().manual_seed(int(host_seed)), device_gen


def save_val_triplets(out_dir: str, epoch: int, j: int, image, labels, probs, organs):
    """Reference val-image dump: ``val_images/<epoch>/<j>_{img,gt_organN,pred_organN}.png``
    (``train_multiclass.py:207-236``); numpy HWC inputs."""
    from .data import imops

    d = os.path.join(out_dir, str(epoch))
    os.makedirs(d, exist_ok=True)
    base = os.path.join(d, str(j))
    imops.imwrite_bgr(base + "_img.png",
                      (np.asarray(image)[..., ::-1] * 255).astype(np.uint8))
    for idx in range(len(organs)):
        imops.imwrite_bgr(base + f"_gt_organ{idx}.png",
                          (np.clip(np.asarray(labels[..., idx]), 0, 1) * 255).astype(np.uint8))
        imops.imwrite_bgr(base + f"_pred_organ{idx}.png",
                          (np.asarray(probs[..., idx]) * 255).astype(np.uint8))


def train(args=None):
    args = args if args is not None else build_argparser().parse_args()
    reason = _unported(args)
    if reason:
        raise NotImplementedError(reason)
    import torch

    from .config import EnvConfig
    from .data import Batcher, cuda_prefetch, get_split_datasets
    from .losses import LOSS_NAMES
    from .models import build_model
    from .train import (
        BackgroundWeightSchedule,
        create_train_state,
        cosine_annealing_warm_restarts,
        curriculum_gates,
        make_checkpointer,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from .utils import MetricsLogger

    device = device_of(args.platform)
    cfg = EnvConfig.from_env()
    print(f"Organs: {list(cfg.organs)}")
    save_dir = cfg.checkpoint_dir(args.models_dir)
    ckptr = make_checkpointer(args.ckpt, save_dir, cfg.expt_name)
    batch_size = args.batch_size

    train_ds, val_ds, _ = get_split_datasets(cfg, synthetic=args.dataset == "synthetic")
    assert len(train_ds) > 0, "empty training dataset — check data dir or use --dataset synthetic"

    model_name = "vgg_unet" if args.deepsupervision else args.model
    # Fused head loss: train on 1/4-resolution logits (the upsample and the
    # sigmoid folded into the loss kernel); eval reads the same parameters
    # through the upsampling head.
    lowres = (model_name == "deeplabv3plus" and cfg.num_classes > 1
              and not args.deepsupervision and not args.no_fused_head_loss)
    model = build_model(model_name, num_classes=cfg.num_classes, encoder_name=args.encoder,
                        max_channels=cfg.max_channels, deepsupervision=args.deepsupervision,
                        upsample_head=not lowres, remat=args.remat, device=device)
    eval_model = model
    if lowres:
        eval_model = copy.copy(model)  # shares every parameter and buffer
        eval_model.upsample_head = True
    tx = make_optimizer(args.lr, grad_accum=args.grad_accum)
    state = create_train_state(model, torch.Generator().manual_seed(args.seed), tx)
    start_epoch, state = ckptr.restore(
        state, epoch=None if args.start_epoch == 0 else args.start_epoch)

    augment = not args.no_augment
    train_step = make_train_step(model, tx, augment=augment,
                                 deepsupervision=args.deepsupervision, lowres_head=lowres)
    eval_step = make_eval_step(eval_model)

    lr_at = cosine_annealing_warm_restarts(args.lr, t_0=100)
    bg_schedule = BackgroundWeightSchedule(args.num_epochs, seed=args.seed)

    loader = Batcher(train_ds, batch_size, shuffle=True, seed=args.seed, pad_final=True)
    val_loader = Batcher(val_ds, 1, shuffle=False) if len(val_ds) else None
    log_every = args.log_every if args.log_every is not None else max(len(loader) // 5, 1)
    metrics_log = MetricsLogger(os.path.join(args.models_dir, cfg.expt_name, "metrics.csv"))
    keys = (*LOSS_NAMES, "loss")

    for epoch in range(start_epoch + 1, args.num_epochs):
        train_ds.set_augment_flag(True)
        bg_weight = bg_schedule(epoch + 1)
        gates = curriculum_gates(epoch)
        gates3 = [gates["focal_dice_w"], gates["bce_l_w"], gates["generalized_dice_w"]]
        lr = lr_at(epoch + 1)

        running = {k: 0.0 for k in keys}
        count = 0
        t0 = time.time()
        images_seen = 0
        for i, batch in enumerate(cuda_prefetch(iter(loader), device)):
            rng = step_generators(args.seed, epoch * 1_000_003 + i, device, augment)
            arrays = {"image": batch["image"], "label": batch["label"]}
            state, metrics = train_step(state, arrays, rng, bg_weight, gates3, lr, None)
            images_seen += batch.get("n_real", arrays["image"].shape[0])
            # One device-to-host transfer for all metrics.
            host = dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()))
            for k in running:
                running[k] += host[k]
            count += 1
            if i % log_every == log_every - 1 or len(loader) < log_every:
                print(
                    "Epoch: %d ; Batch: %d/%d : Training Loss: %.8f" % (
                        epoch + 1, i + 1, len(loader), running["loss"] / count)
                )
                print(
                    "\t CE: %.8f; BCE: %.8f; Focal: %.8f; Dice: %.8f "
                    "[D: %.6f, GD: %.6f, TwD: %.6f, FocD: %.6f]" % (
                        running["ce"] / count, running["bce"] / count,
                        running["focal"] / count,
                        sum(running[k] for k in ("dice", "generalized_dice", "twersky",
                                                 "focal_dice")) / count,
                        running["dice"] / count, running["generalized_dice"] / count,
                        running["twersky"] / count, running["focal_dice"] / count,
                    )
                )
                running = {k: 0.0 for k in running}
                count = 0
        dt = time.time() - t0
        if images_seen:
            print(f"epoch {epoch}: {images_seen / dt:.1f} images/sec "
                  f"(bg_w={bg_weight:.3f}, lr={lr:.2e})")
            metrics_log.log(
                epoch=epoch, step=int(state.step), lr=lr, bg_weight=bg_weight,
                loss=host["loss"], bce=host["bce"], focal_dice=host["focal_dice"],
                images_per_sec=images_seen / dt,
            )

        if epoch % 10 == 0:
            ckptr.save(epoch, state)

        if val_loader is not None:
            train_ds.set_augment_flag(False)
            val_loss, n_val = 0.0, 0
            for j, batch in enumerate(cuda_prefetch(iter(val_loader), device)):
                out = eval_step(state, {"image": batch["image"], "label": batch["label"]})
                val_loss += float(out["bce"])
                n_val += batch["image"].shape[0]
                if j < 10:
                    save_val_triplets(
                        "val_images", epoch, j, batch["image"][0].cpu().numpy(),
                        batch["label"][0].cpu().numpy(), out["probs"][0].cpu().numpy(),
                        cfg.organs,
                    )
            print("\nVal Loss: %.8f!" % (val_loss / max(n_val, 1)))

    # final checkpoint so short runs always leave an artifact
    ckptr.save(args.num_epochs - 1, state)
    ckptr.finalize()
    print("finished training")
    return state


if __name__ == "__main__":
    train()
