"""The port's sequential trainer CLI,
``train_multiclass_sequential_densenetloss``, called in-process on the CPU
(``--platform cpu``) at ``SAMPLE=1 IMGSIZE=32``, three organs, batch 8,
without augmentation, for 6 epochs (4 steps each), held to the JAX
package's CLI of the same name:

* its checkpoints sit at the JAX layout: every 5 epochs and the final one
  (epochs 0 and 5 here), and the JAX package's ``load_recent_model``
  restores the last one leaf for leaf;
* the CLI builds ``ReduceLROnPlateau(lr, factor=0.75, patience=50)``,
  steps it on each epoch's val loss and trains the next epoch at its
  learning rate; the recorded plateau is made to decay on every epoch
  (patience 0, no val loss counted as a gain), so the lr changes each
  epoch, and it equals the JAX package's plateau in the same state;
* more than one organ trains ``composite_mode="sequential"`` (which wants
  exactly three organs), one organ ``"none"``, and ``--grad_accum`` wraps
  Adam as ``train_multiclass`` does;
* the divergence guard aborts a run whose model predicts no positive;
* the flags whose parts are not ported raise ``NotImplementedError`` naming
  their ROADMAP item, and the card is the default device.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import ecologysemanticsegmentation_torch.train as ptrain
from ecologysemanticsegmentation_torch import train_multiclass_sequential_densenetloss as scli
from ecologysemanticsegmentation_torch.models.from_flax import to_flax_variables
from ecologysemanticsegmentation_torch.train import checkpoint as tck
from ecologysemanticsegmentation_tpu.train import checkpoint as jck
from ecologysemanticsegmentation_tpu.train import schedules as js
from ecologysemanticsegmentation_tpu.train import trainer as jtrainer
from _torch_parallel_ranks import bound_threads

bound_threads()

ORGANS = ("whole_body", "ventral_side", "dorsal_side")
ARGS = ["--platform", "cpu", "--dataset", "synthetic", "--batch_size", "8", "--no_augment"]
SAVE_DIR = os.path.join("models", "deeplabv3p", "channels256", "img32")
EPOCHS, STEPS = 6, 4  # 27 training images in batches of 8, the last padded


def _train(argv, organs=ORGANS, patch=None):
    """One in-process call in a fresh directory; what it recorded: the
    plateau's inputs and outputs, the lr of every step, the step's
    composite mode, its output and its final state."""
    record = {"plateau": [], "lr": [], "modes": []}

    class Plateau(ptrain.ReduceLROnPlateau):
        """Decays on every step, so that the lr the steps get shows
        whether the CLI feeds them the plateau's output."""

        def __init__(self, *args, **kwargs):
            record["plateau_args"] = (args, kwargs)
            super().__init__(*args, **{**kwargs, "patience": 0})
            self.best = float("-inf")

        def step(self, metric):
            lr = super().step(metric)
            record["plateau"].append((metric, lr))
            return lr

    make_train_step = ptrain.make_train_step

    def recording_make_train_step(model, tx, **kwargs):
        record["modes"].append(kwargs.get("composite_mode"))
        step = make_train_step(model, tx, **kwargs)

        def recorded(state, batch, rng, bg_weight, gates3, lr, jitters):
            record["lr"].append(lr)
            return step(state, batch, rng, bg_weight, gates3, lr, jitters)

        return recorded

    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXPTNAME", "MAXCHANNELS", "IMG_SIZE", "BBOX_DIR", "WORLD_SIZE"):
            mp.delenv(k, raising=False)
        mp.setenv("SAMPLE", "1")
        mp.setenv("IMGSIZE", "32")
        mp.setenv("ORGANS", ",".join(organs))
        mp.setattr(ptrain, "ReduceLROnPlateau", Plateau)
        mp.setattr(ptrain, "make_train_step", recording_make_train_step)
        if patch:
            patch(mp)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            record["state"] = scli.train(scli.build_argparser().parse_args(ARGS + argv))
    record["log"] = log.getvalue()
    return record


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("sequential_cli")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        record = _train(["--num_epochs", str(EPOCHS)])
    finally:
        os.chdir(cwd)
    record["work"] = work
    return record


def test_files_at_jax_layout(run):
    files = sorted(os.path.relpath(os.path.join(d, f), run["work"])
                   for d, _, fs in os.walk(run["work"]) for f in fs)
    assert files == [os.path.join(SAVE_DIR, f"deeplabv3p_epoch{e}.ckpt") for e in (0, 5)]
    log = run["log"]
    assert "finished training" in log
    assert [f"Epoch {e + 1}: loss" in log for e in range(EPOCHS)] == [True] * EPOCHS
    assert log.count("Val Loss: ") == EPOCHS
    assert run["state"].step == EPOCHS * STEPS


def test_jax_restores_last_checkpoint(run):
    state = run["state"]
    v = to_flax_variables(state.model.state_dict())
    template = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                   batch_stats=v["batch_stats"],
                                   opt_state=jtrainer.make_optimizer(1e-3).init(v["params"]))
    epoch, restored = jck.load_recent_model(os.path.join(run["work"], SAVE_DIR), template,
                                            "deeplabv3p")
    assert epoch == EPOCHS - 1
    flat = jax.tree_util.tree_flatten_with_path
    want = flat(tck.state_to_flax(state))[0]
    got = dict(flat(serialization.to_state_dict(jax.device_get(restored)))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), leaf), jax.tree_util.keystr(path)
    assert int(restored.opt_state.count) == EPOCHS * STEPS


def test_plateau_lr_matches_jax(run):
    assert run["plateau_args"] == ((1e-3,), {"factor": 0.75, "patience": 50})
    val_losses = [m for m, _ in run["plateau"]]
    assert len(val_losses) == EPOCHS and np.isfinite(val_losses).all()
    printed = [float(line[len("Val Loss: "):-1]) for line in run["log"].splitlines()
               if line.startswith("Val Loss: ")]
    np.testing.assert_allclose(printed, val_losses, rtol=0, atol=5e-9)
    jax_plateau = js.ReduceLROnPlateau(1e-3, factor=0.75, patience=0)
    jax_plateau.best = float("-inf")
    decayed = [jax_plateau.step(m) for m in val_losses]
    assert len(set(decayed)) == EPOCHS
    assert [lr for _, lr in run["plateau"]] == decayed
    want = [1e-3] + decayed[:-1]
    assert run["lr"] == [lr for lr in want for _ in range(STEPS)]
    assert run["modes"] == ["sequential"]


def test_one_organ_and_grad_accum(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    record = _train(["--num_epochs", "1", "--grad_accum", "2"], organs=("whole_body",))
    assert record["modes"] == ["none"]
    opt = record["state"].optimizer
    assert isinstance(opt, ptrain.MultiSteps) and opt.every_k == 2
    assert os.path.exists(os.path.join(SAVE_DIR, "deeplabv3p_epoch0.ckpt"))
    monkeypatch.setenv("ORGANS", "whole_body,ventral_side")
    with pytest.raises(AssertionError, match="3-organ"):
        scli.train(scli.build_argparser().parse_args(ARGS + ["--num_epochs", "1"]))


def test_divergence_guard(tmp_path, monkeypatch):
    """A head bias of -1e4 makes every probability 0 (sigmoid underflows):
    the first val batch aborts the run."""
    monkeypatch.chdir(tmp_path)
    create_train_state = ptrain.create_train_state

    def no_positives(model, generator, tx):
        state = create_train_state(model, generator, tx)
        with torch.no_grad():
            model.head.bias.fill_(-1e4)
        return state

    with pytest.raises(AssertionError, match="gradient descent gave no positives! aborting"):
        _train(["--num_epochs", "1"],
               patch=lambda mp: mp.setattr(ptrain, "create_train_state", no_positives))


@pytest.mark.parametrize("flags,item", [
    (["--spatial_partition", "2"], "item 10"),
    (["--ckpt", "orbax"], "item 12"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        scli.train(scli.build_argparser().parse_args(ARGS + flags))


def test_refuses_other_launches_and_devices(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 10"):
        scli.train(scli.build_argparser().parse_args(ARGS))
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="platform"):
        scli.train(scli.build_argparser().parse_args(["--platform", "tpu"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scli.train(scli.build_argparser().parse_args(["--dataset", "synthetic"]))
