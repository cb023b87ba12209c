"""Sequential ("densenet-loss") trainer CLI of the port:
``python -m ecologysemanticsegmentation_torch.train_multiclass_sequential_densenetloss``.

The JAX package's sequential trainer on one NVIDIA card, with its flags,
names and defaults:

* more than one organ selects ``composite_mode="sequential"`` (the
  cross-organ term on organ 1, two loss-sums calls a step), which assumes
  the three organs whole_body, ventral_side, dorsal_side; one organ trains
  the plain losses;
* lr 1e-3 under ``ReduceLROnPlateau(factor=0.75, patience=50)``, stepped on
  the val BCE each epoch; the background weight and the curriculum gates
  per epoch; full-resolution logits (no fused head loss);
* a checkpoint every 5 epochs and a final one, in the JAX package's
  msgpack format and layout; resume from the latest (or ``--start_epoch``);
* the divergence guard: a val batch with no positive prediction aborts
  ("gradient descent gave no positives! aborting").

Each step draws from generators seeded by ``(seed, epoch * 1_000_003 + i)``
and reads batches staged one ahead on the card (:func:`.data.cuda_prefetch`),
as ``train_multiclass`` does.  The card is the default device and the run
raises without one; ``--platform cpu`` runs on the CPU.  ``--depthwiseconv``
trains ``DeepLabV3PlusDepthwise`` and ``--encoder`` picks resnet34 or
resnet50.  ``--spatial_partition > 1`` and a launch of more than one rank
(item 10) and ``--ckpt orbax`` (item 12) raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch_size", default=7, type=int)
    ap.add_argument("--start_epoch", default=0, type=int)
    ap.add_argument("--lr", default=0.001, type=float)
    ap.add_argument("--num_epochs", default=11000, type=int)
    ap.add_argument("--early_stop_epoch", default=400, type=int)
    ap.add_argument("--depthwiseconv", action="store_true",
                    help="DeepLabV3PlusDepthwise head")
    ap.add_argument("--dataset", default="registry", choices=["registry", "synthetic"])
    ap.add_argument("--models_dir", default="models")
    ap.add_argument("--encoder", default="resnet34")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; the default (or 'gpu', 'cuda') is the card")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--no_augment", action="store_true")
    ap.add_argument("--ckpt", default="msgpack", choices=["msgpack", "orbax"],
                    help="Checkpoint backend: msgpack = reference filename "
                         "layout (orbax is not ported yet)")
    ap.add_argument("--grad_accum", default=1, type=int,
                    help="Average this many micro-batch gradients into "
                         "one Adam update; resume with the same value")
    ap.add_argument("--spatial_partition", default=1, type=int,
                    help="shard image rows over a mesh 'model' axis of this "
                         "size (needs the multi-rank CLI, not ported yet; "
                         "1 = one rank)")
    return ap


def _unported(args) -> str | None:
    """Why ``args`` asks for a part that is not ported, or None."""
    if args.spatial_partition > 1:
        return ("--spatial_partition > 1 needs the multi-rank CLI, not ported yet "
                "(ROADMAP queue 1, item 10)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return "a launch of more than one rank needs the multi-rank CLI (ROADMAP queue 1, item 10)"
    if args.ckpt == "orbax":
        return "--ckpt orbax (asynchronous checkpoints) is not ported yet (ROADMAP queue 1, item 12)"
    return None


def train(args=None):
    args = args if args is not None else build_argparser().parse_args()
    reason = _unported(args)
    if reason:
        raise NotImplementedError(reason)
    import torch

    from .config import EnvConfig
    from .data import Batcher, cuda_prefetch, get_split_datasets
    from .models import build_model
    from .train import (
        BackgroundWeightSchedule,
        ReduceLROnPlateau,
        create_train_state,
        curriculum_gates,
        make_checkpointer,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from .train_multiclass import device_of, step_generators

    device = device_of(args.platform)
    cfg = EnvConfig.from_env()
    composite_flag = cfg.num_classes > 1
    print(f"Organs: {list(cfg.organs)} (composite set-theory losses: {composite_flag})")
    if composite_flag and cfg.num_classes != 3:
        raise AssertionError("sequential composite losses hardcode the 3-organ "
                             "whole_body/ventral_side/dorsal_side structure (reference :304-362)")
    save_dir = cfg.checkpoint_dir(args.models_dir)
    ckptr = make_checkpointer(args.ckpt, save_dir, cfg.expt_name)

    train_ds, val_ds, _ = get_split_datasets(cfg, synthetic=args.dataset == "synthetic")
    if not len(train_ds):
        raise AssertionError("empty training dataset")

    model = build_model("deeplabv3plus", num_classes=cfg.num_classes, encoder_name=args.encoder,
                        depthwise=args.depthwiseconv, device=device)
    tx = make_optimizer(args.lr, grad_accum=args.grad_accum)
    state = create_train_state(model, torch.Generator().manual_seed(args.seed), tx)
    start_epoch, state = ckptr.restore(
        state, epoch=None if args.start_epoch == 0 else args.start_epoch)

    augment = not args.no_augment
    train_step = make_train_step(
        model, tx, composite_mode="sequential" if composite_flag else "none", augment=augment)
    eval_step = make_eval_step(model, apply_union_reverse=False)

    plateau = ReduceLROnPlateau(args.lr, factor=0.75, patience=50)
    bg_schedule = BackgroundWeightSchedule(args.num_epochs, seed=args.seed)

    loader = Batcher(train_ds, args.batch_size, shuffle=True, seed=args.seed, pad_final=True)
    val_loader = Batcher(val_ds, 1, shuffle=False) if len(val_ds) else None

    lr = args.lr
    for epoch in range(start_epoch + 1, args.num_epochs):
        train_ds.set_augment_flag(True)
        bg_weight = bg_schedule(epoch + 1)
        gates = curriculum_gates(epoch)
        gates3 = [gates["focal_dice_w"], gates["bce_l_w"], gates["generalized_dice_w"]]
        t0, images_seen, ep_loss, n_batches = time.time(), 0, 0.0, 0
        # The composite jitters belong to the reference's unreachable
        # set-theory branch; the executed loss takes none.
        for i, batch in enumerate(cuda_prefetch(iter(loader), device)):
            rng = step_generators(args.seed, epoch * 1_000_003 + i, device, augment)
            state, metrics = train_step(
                state, {"image": batch["image"], "label": batch["label"]},
                rng, bg_weight, gates3, lr, None)
            ep_loss += float(metrics["loss"])
            n_batches += 1
            # n_real excludes wrap-around padding in the final batch.
            images_seen += batch.get("n_real", batch["image"].shape[0])
        dt = time.time() - t0
        if n_batches:
            print(
                f"Epoch {epoch + 1}: loss {ep_loss / n_batches:.6f} "
                f"({images_seen / dt:.1f} img/s, lr={lr:.2e}, bg={bg_weight:.3f})"
            )

        if epoch % 5 == 0:
            ckptr.save(epoch, state)

        if val_loader is not None:
            train_ds.set_augment_flag(False)
            val_loss, n_val = 0.0, 0
            for batch in cuda_prefetch(iter(val_loader), device):
                out = eval_step(state, {"image": batch["image"], "label": batch["label"]})
                positives, bce = torch.stack([out["probs"].sum(), out["bce"]]).tolist()
                # Divergence guard (reference :246).
                if not positives > 0:
                    raise AssertionError("gradient descent gave no positives! aborting")
                val_loss += bce
                n_val += 1
            val_loss /= max(n_val, 1)
            lr = plateau.step(val_loss)
            print("Val Loss: %.8f!" % val_loss)

    ckptr.save(args.num_epochs - 1, state)
    ckptr.finalize()
    print("finished training")
    return state


if __name__ == "__main__":
    train()
