"""Sequential-variant eval CLI of the port:
``python -m ecologysemanticsegmentation_torch.test_multiclass_sequential_densenetloss``.

:mod:`.test_multiclass` with the JAX package's sequential-variant
semantics: the predictions go back from nested unions to organ sets
(``return_union_sets_descending_order(reverse=True)``) before scoring,
always; ``--edge_analysis`` with ``--single_model`` also writes the
inner-edge analysis of the first two test images as PNGs
(:func:`..utils.detect_inner_edges`) under
``<results_dir>/edge_analysis_epoch<N>/``.
"""

from __future__ import annotations


def build_argparser():
    from .test_multiclass import build_argparser as base

    ap = base()
    ap.set_defaults(union_reverse=True)
    ap.add_argument("--edge_analysis", action="store_true",
                    help="Write inner/outer edge-membership analysis PNGs in "
                         "single-model mode (reference detect_inner_edges)")
    return ap


def test(args=None):
    args = args if args is not None else build_argparser().parse_args()
    args.union_reverse = True
    from .test_multiclass import test as base_test

    results = base_test(args)

    if getattr(args, "edge_analysis", False) and args.single_model is not None:
        _edge_analysis(args)
    return results


def _edge_analysis(args):
    import numpy as np

    from .config import EnvConfig
    from .data import Batcher, get_split_datasets
    from .losses import return_union_sets_descending_order
    from .models import build_model
    from .test_multiclass import eval_template
    from .train import list_checkpoints, load_checkpoint_file, make_eval_step
    from .train_multiclass import device_of
    from .utils import detect_inner_edges

    device = device_of(args.platform)
    cfg = EnvConfig.from_env()
    _, _, test_ds = get_split_datasets(cfg, synthetic=args.dataset == "synthetic")
    model = build_model(args.model, num_classes=cfg.num_classes, encoder_name=args.encoder,
                        depthwise=args.depthwiseconv, device=device)
    template = eval_template(model)
    save_dir = cfg.checkpoint_dir(args.models_dir or "models")
    pairs = [(e, p) for e, p in list_checkpoints(save_dir, cfg.expt_name) if e == args.single_model]
    if not pairs:
        return
    state = load_checkpoint_file(pairs[0][1], template)
    if state is None:
        return
    eval_step = make_eval_step(model, apply_union_reverse=False)
    batch = next(iter(Batcher(test_ds, 2, shuffle=False, drop_last_if_single=False)))
    out = eval_step(state, {"image": batch["image"], "label": batch["label"]})
    probs = return_union_sets_descending_order(out["probs"], reverse=True)
    gts = np.where(batch["label"] > 0, 1.0, 0.0)
    detect_inner_edges(
        probs.cpu().numpy(), gts, img=batch["image"],
        out_dir=f"{args.results_dir}/edge_analysis_epoch{args.single_model}",
    )


if __name__ == "__main__":
    test()
