"""The CLIs' model flags, called in-process on the CPU (``--platform cpu``)
at ``SAMPLE=1 IMGSIZE=32``, three organs, one step of batch 32 an epoch
(27 training images, padded), without augmentation:

* ``train_multiclass --model vgg_unet --deepsupervision`` for 2 epochs,
  and again with ``--remat``: the remat run's checkpoint is the plain
  run's, byte for byte (dropout on, from the same seeds);
* ``train_multiclass --model unet --encoder resnet50`` for 1 epoch;
* ``train_multiclass_sequential_densenetloss --depthwiseconv --encoder
  resnet50`` for 1 epoch;

each run's checkpoint is loaded by the JAX package's ``load_recent_model``
into a template of the JAX package's own model (``jax.eval_shape`` of its
``init``) and equals the run's state leaf for leaf.  Then the evaluators
score those checkpoints: ``test_multiclass --deepsupervision``, ``--model
unet --encoder resnet50`` and ``--depthwiseconv --encoder resnet50``, and
``test_multiclass_sequential_densenetloss --depthwiseconv --encoder
resnet50``; each gives a per-organ Dice finite in [0, 1] for every
checkpoint, equal to the port's eval step on the loaded model.
"""

import contextlib
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import unflatten_dict

from ecologysemanticsegmentation_torch import test_multiclass as pevalcli
from ecologysemanticsegmentation_torch import test_multiclass_sequential_densenetloss as pseqeval
from ecologysemanticsegmentation_torch import train_multiclass as tcli
from ecologysemanticsegmentation_torch import train_multiclass_sequential_densenetloss as scli
from ecologysemanticsegmentation_torch.train import checkpoint as tck
from ecologysemanticsegmentation_tpu import models as jm
from ecologysemanticsegmentation_tpu.train import checkpoint as jck
from ecologysemanticsegmentation_tpu.train import trainer as jtrainer
from _torch_models import flax_shapes
from _torch_parallel_ranks import bound_threads

bound_threads()

ORGANS = ("whole_body", "ventral_side", "dorsal_side")
ENV = {"SAMPLE": "1", "IMGSIZE": "32", "ORGANS": ",".join(ORGANS)}
ARGS = ["--platform", "cpu", "--dataset", "synthetic", "--batch_size", "32", "--no_augment"]
SAVE_DIR = os.path.join("models", "deeplabv3p", "channels256", "img32")

# name -> (CLI module, flags, epochs, the JAX package's model of its files)
RUNS = {
    "vgg_ds": (tcli, ["--model", "vgg_unet", "--deepsupervision"], 2,
               lambda: jm.build_model("vgg_unet", 3, max_channels=256, deepsupervision=True)),
    "vgg_ds_remat": (tcli, ["--deepsupervision", "--remat"], 2, None),
    "unet_resnet50": (tcli, ["--model", "unet", "--encoder", "resnet50"], 1,
                      lambda: jm.build_model("unet", 3, encoder_name="resnet50")),
    "sequential_depthwise": (scli, ["--depthwiseconv", "--encoder", "resnet50"], 1,
                             lambda: jm.build_model("deeplabv3plus", 3, encoder_name="resnet50",
                                                    depthwise=True)),
}


def _call(fn, args):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = fn(args)
    return out, log.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run in a directory of its own; the checkpoints (up to ~0.4 GB
    each) are removed at the end of the module."""
    root = tmp_path_factory.mktemp("models_cli")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXPTNAME", "MAXCHANNELS", "IMG_SIZE", "BBOX_DIR", "WORLD_SIZE"):
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        for name, (cli, flags, epochs, _) in RUNS.items():
            work = root / name
            work.mkdir()
            mp.chdir(work)
            state, log = _call(cli.train, cli.build_argparser().parse_args(
                ARGS + flags + ["--num_epochs", str(epochs)]))
            out[name] = {"work": work, "state": state, "log": log, "epochs": epochs}
        yield out
    shutil.rmtree(root, ignore_errors=True)


def _checkpoints(run):
    return sorted(os.listdir(run["work"] / SAVE_DIR))


def test_files_at_jax_layout(runs):
    for name, run in runs.items():
        want = sorted(f"deeplabv3p_epoch{e}.ckpt" for e in {0, run["epochs"] - 1})
        assert _checkpoints(run) == want, name
        assert "finished training" in run["log"], name
        assert run["state"].step == run["epochs"], name


def test_remat_checkpoint_equals_plain(runs):
    plain, remat = runs["vgg_ds"], runs["vgg_ds_remat"]
    assert plain["state"].model.decoder.remat is False
    assert remat["state"].model.encoder.remat is True
    for ckpt in _checkpoints(plain):
        a = (plain["work"] / SAVE_DIR / ckpt).read_bytes()
        assert a == (remat["work"] / SAVE_DIR / ckpt).read_bytes(), ckpt


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[3] is not None])
def test_jax_restores_checkpoint(runs, name):
    run = runs[name]
    shapes = flax_shapes(RUNS[name][3]())
    zeros = {col: unflatten_dict({k: np.zeros(s, np.float32) for k, s in shapes[col].items()})
             for col in shapes}
    template = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=zeros["params"],
        batch_stats=zeros["batch_stats"],
        opt_state=jtrainer.make_optimizer(3e-4).init(zeros["params"]))
    epoch, restored = jck.load_recent_model(str(run["work"] / SAVE_DIR), template, "deeplabv3p")
    assert epoch == run["epochs"] - 1
    flat = jax.tree_util.tree_flatten_with_path
    want = flat(tck.state_to_flax(run["state"]))[0]
    got = dict(flat(serialization.to_state_dict(jax.device_get(restored)))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), leaf), jax.tree_util.keystr(path)


# (the run whose checkpoints are scored, evaluator, flags)
EVALS = {
    "deepsupervision": ("vgg_ds", pevalcli, ["--deepsupervision"]),
    "unet_resnet50": ("unet_resnet50", pevalcli, ["--model", "unet", "--encoder", "resnet50"]),
    "depthwise_resnet50": ("sequential_depthwise", pevalcli,
                           ["--depthwiseconv", "--encoder", "resnet50"]),
    "sequential_depthwise_resnet50": ("sequential_depthwise", pseqeval,
                                      ["--depthwiseconv", "--encoder", "resnet50"]),
}


@pytest.mark.parametrize("case", list(EVALS))
def test_evaluator_scores_checkpoints(runs, case, monkeypatch):
    from ecologysemanticsegmentation_torch.config import EnvConfig
    from ecologysemanticsegmentation_torch.data import Batcher, get_split_datasets
    from ecologysemanticsegmentation_torch.train import make_eval_step

    name, module, flags = EVALS[case]
    run = runs[name]
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(run["work"])
    results, _ = _call(module.test, module.build_argparser().parse_args(
        ["--platform", "cpu", "--dataset", "synthetic", "--results_dir", f"scores_{case}"]
        + flags))
    epochs = sorted({0, run["epochs"] - 1})
    assert [e for e, _ in results] == epochs
    for _, dice in results:
        assert dice.shape == (3,) and np.isfinite(dice).all()
        assert ((dice >= 0) & (dice <= 1)).all()
    # the last epoch's score is the eval step's on the run's final model
    _, _, test_ds = get_split_datasets(EnvConfig.from_env(), synthetic=True)
    test_ds.set_augment_flag(False)
    batch = next(iter(Batcher(test_ds, 45, shuffle=False, drop_last_if_single=False)))
    model = run["state"].model
    out = make_eval_step(model, apply_union_reverse=module is pseqeval)(
        None, {"image": torch.as_tensor(batch["image"]), "label": torch.as_tensor(batch["label"])})
    np.testing.assert_allclose(results[-1][1], out["dice"].numpy(), rtol=1e-6, atol=1e-7)
