"""Eval CLI of the port: ``python -m ecologysemanticsegmentation_torch.test_multiclass``.

The JAX package's ``test_multiclass`` on one NVIDIA card, with its flags,
names and output:

* sweeps every checkpoint in ``models/<EXPT>/channels<MC>/img<SZ>/`` (the
  JAX package's msgpack files and the reference's ``.pt`` weights), or one
  epoch with ``--single_model N``;
* per-organ Dice: the mean over test batches of the eval step's Dice,
  each batch weighted by whether it holds a non-ignored pixel of the organ;
* idempotent skip: an existing ``<results_dir>/<epoch4>/<organs>``
  directory skips that epoch; corrupt or incompatible files are skipped;
* ``--single_model``: batch 1, and each test image's gt and pred overlays
  as PNGs (``display_composite_annotations``);
* the final report ranks the epochs by each organ's Dice.

``--model`` and ``--encoder`` pick the model, ``--depthwiseconv`` the
DeepLabV3+ wrapper and ``--deepsupervision`` the VGG U-Net with its side
heads (scored on its main head), at ``max_channels=MAXCHANNELS``.  The card
is the default device and the run raises without one; ``--platform cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--single_model", type=int, default=None,
                    help="Epoch number for model selection vs testing the entire sweep")
    ap.add_argument("--models_dir", default=None)
    ap.add_argument("--results_dir", default="test_results")
    ap.add_argument("--batch_size", type=int, default=45)
    ap.add_argument("--dataset", default="registry", choices=["registry", "synthetic"])
    ap.add_argument("--model", default="deeplabv3plus")
    ap.add_argument("--encoder", default="resnet34")
    ap.add_argument("--depthwiseconv", action="store_true",
                    help="DeepLabV3PlusDepthwise checkpoints")
    ap.add_argument("--deepsupervision", action="store_true",
                    help="Score checkpoints trained with --deepsupervision "
                         "(vgg_unet; the main head is scored)")
    ap.add_argument("--union_reverse", action="store_true",
                    help="Apply the reverse union-set transform to predictions "
                         "before scoring (sequential-variant eval semantics)")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; the default (or 'gpu', 'cuda') is the card")
    return ap


def build_eval_model(args, cfg, device):
    """The model whose checkpoints the sweep scores: ``--deepsupervision``
    checkpoints carry the VGG U-Net's side-head parameters, so it builds
    that model, whose main head the eval step scores."""
    from .models import build_model

    name = "vgg_unet" if args.deepsupervision else args.model
    return build_model(name, num_classes=cfg.num_classes, encoder_name=args.encoder,
                       max_channels=cfg.max_channels, depthwise=args.depthwiseconv,
                       deepsupervision=args.deepsupervision, device=device)


def eval_template(model):
    """The state every checkpoint of the sweep loads into: ``model`` and an
    Adam of the JAX package's default optimizer layout.  Its weights are
    not initialized on purpose: each load overwrites all of them, and a
    file that does not load is skipped."""
    from .train import TrainState, make_optimizer

    return TrainState(step=0, model=model, optimizer=make_optimizer()(model.parameters()))


def evaluate_checkpoint(
    eval_step, state, loader, organs, results_dir, saved_epoch, single_model, union_reverse=False
):
    """One checkpoint over the test set; per-organ Dice, or None if the
    epoch's results directory already exists (the idempotent skip).
    ``loader`` yields batches of tensors on the model's device
    (:func:`..data.cuda_prefetch`); the Dice of every batch comes to the
    host in one transfer at the end."""
    import torch

    from .data import imops
    from .utils import display_composite_annotations

    del union_reverse  # the eval step applies it
    dir_name = os.path.join(results_dir, str(saved_epoch).zfill(4), ",".join(organs))
    if os.path.isdir(dir_name):
        print(f"Skipping epoch {saved_epoch}! Test already done!")
        return None
    os.makedirs(dir_name, exist_ok=True)

    scores = []
    for j, batch in enumerate(loader):
        out = eval_step(state, {"image": batch["image"], "label": batch["label"]})
        scores.append(torch.stack([out["dice"].float(), out["valid"].float()]))
        if single_model:
            img8 = (batch["image"][0].cpu().numpy() * 255).astype(np.uint8)
            gt8 = (np.clip(batch["label"][0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            pred8 = (out["probs"][0].cpu().numpy() * 255).astype(np.uint8)
            preds = display_composite_annotations(img8, pred8, list(organs), verbose=False)
            gts = display_composite_annotations(img8, gt8, list(organs), verbose=False)
            for entry_p, entry_g in zip(preds, gts):
                key = list(entry_g.keys())[0]
                imops.imwrite_bgr(os.path.join(dir_name, f"{key}_{j}_gt.png"),
                                  entry_g[key][..., ::-1])
                imops.imwrite_bgr(os.path.join(dir_name, f"{key}_{j}_pred.png"),
                                  entry_p[key][..., ::-1])
    # Weight each batch by per-organ validity: an organ that is entirely
    # -1 (ignore) in a batch contributes nothing instead of a degenerate
    # eps/eps score of 1.0.
    total = np.zeros(len(organs))
    counts = np.zeros(len(organs))
    for dice, valid in (torch.stack(scores).cpu().numpy() if scores else []):
        total += dice * valid
        counts += valid
    if counts.max() == 0:
        return None
    # An organ with no valid batch at all reports nan (no data), not a score.
    dice = total / np.maximum(counts, 1)
    dice = np.where(counts > 0, dice, np.nan)
    print(f"Epoch {saved_epoch}: \n\t Test Dice Score: ", dice)
    print("Finished Testing")
    return dice


def test(args=None):
    args = args if args is not None else build_argparser().parse_args()
    from .config import EnvConfig
    from .data import Batcher, cuda_prefetch, get_split_datasets
    from .train import list_checkpoints, load_checkpoint_file, make_eval_step
    from .train_multiclass import device_of

    device = device_of(args.platform)
    cfg = EnvConfig.from_env()
    _, _, test_ds = get_split_datasets(cfg, synthetic=args.dataset == "synthetic")
    test_ds.set_augment_flag(False)
    if not len(test_ds):
        raise AssertionError("empty test dataset")

    batch_size = 1 if args.single_model else args.batch_size
    print(f"Using batch size: {batch_size}")
    loader = Batcher(test_ds, batch_size, shuffle=False, drop_last_if_single=False)

    model = build_eval_model(args, cfg, device)
    template = eval_template(model)
    eval_step = make_eval_step(model, apply_union_reverse=args.union_reverse)

    save_dir = cfg.checkpoint_dir(args.models_dir or "models")
    pairs = list_checkpoints(save_dir, cfg.expt_name)
    if args.single_model is not None:
        pairs = [(e, p) for e, p in pairs if e == args.single_model]
    if not pairs:
        print(f"No checkpoints found under {save_dir}")
        return []

    test_losses = []
    for saved_epoch, path in pairs:
        state = load_checkpoint_file(path, template)
        if state is None:
            print(f"Skipped epoch {saved_epoch} because of model file incompatibility!")
            continue
        dice = evaluate_checkpoint(
            eval_step, state, cuda_prefetch(iter(loader), device), cfg.organs,
            args.results_dir, saved_epoch, bool(args.single_model), args.union_reverse,
        )
        if dice is None:
            continue
        test_losses.append([saved_epoch, dice])

    for organ_idx in range(len(cfg.organs)):
        for epoch, dice in sorted(test_losses, key=lambda x: x[1][organ_idx]):
            print(
                "Epoch %d : Organ : %s DICE Score " % (epoch, cfg.organs[organ_idx]),
                dice[organ_idx],
            )
    return test_losses


if __name__ == "__main__":
    test()
