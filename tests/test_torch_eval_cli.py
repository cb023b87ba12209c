"""The port's eval CLIs, ``test_multiclass`` and
``test_multiclass_sequential_densenetloss``, called in-process on the CPU
(``--platform cpu``) beside the JAX package's, over the same checkpoints.

The sweep directory (``SAMPLE=1 IMGSIZE=32``, three organs; 4 test images)
holds two files written by the JAX package's ``save_checkpoint`` (epochs 3
and 7: random weights, BatchNorm leaves perturbed from their init) and one
reference ``.pt`` state dict (epoch 9), all made once for the module.
Both packages' CLIs run with float64 models (the JAX package's
``build_model`` with ``dtype=float64`` under ``jax.enable_x64``, the
port's with ``.double()``), so each holds the other at the tolerance
``tests/test_torch_train_step_fullres.py`` holds ``make_eval_step`` to:
per-organ Dice rtol 1e-5.  To keep the JAX side to three compiles of its
eval step (at XLA's CPU optimization level 1), its template state and its
compiled eval steps are made once and shared between its calls (patches of
the JAX package's namespaces in this module only).

* the sweeps (batch 2, and 1 for the sequential one) score every epoch
  alike and print the same ranking;
* a second call skips every epoch and writes nothing;
* ``--single_model 7`` writes the same PNG names, and the gt overlays are
  equal pixel for pixel (the pred overlays within one grey level);
* the sequential evaluator's ``--edge_analysis`` writes the same PNGs;
* the card is the default device (the model flags are held by
  ``tests/test_torch_models_cli.py``).
"""

import contextlib
import functools
import io
import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import ecologysemanticsegmentation_torch.models as pmodels
import ecologysemanticsegmentation_tpu.models as jmodels
import ecologysemanticsegmentation_tpu.train as jtrain
from ecologysemanticsegmentation_torch import test_multiclass as ptm
from ecologysemanticsegmentation_torch import test_multiclass_sequential_densenetloss as pts
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus, to_flax_variables
from ecologysemanticsegmentation_tpu import test_multiclass as jtm
from ecologysemanticsegmentation_tpu import test_multiclass_sequential_densenetloss as jts
from ecologysemanticsegmentation_tpu.train import checkpoint as jck
from ecologysemanticsegmentation_tpu.train import trainer as jtrainer
from _torch_parallel_ranks import bound_threads
from test_torch_import_torch import fake_smp_state_dict

bound_threads()

ORGANS = ("whole_body", "ventral_side", "dorsal_side")
ENV = {"SAMPLE": "1", "IMGSIZE": "32", "ORGANS": ",".join(ORGANS)}
SAVE_DIR = os.path.join("models", "deeplabv3p", "channels256", "img32")
EPOCHS = [3, 7, 9]
DICE_RTOL = 1e-5
CLIS = {"multiclass": (jtm, ptm), "sequential": (jts, pts)}
TEMPLATE_MODEL = DeepLabV3Plus(num_classes=len(ORGANS))
# (name, cli, flags); every run once per package, in this order.  The JAX
# eval step compiles for (union_reverse, batch): (False, 2) serves the
# multiclass sweep and the edge analysis, (True, 1) the sequential sweep
# and its single model, (False, 1) the multiclass single model.  No two of
# these can merge: the edge analysis evaluates at batch 2 and
# ``--single_model`` at batch 1, in both CLIs.
RUNS = [
    ("sweep", "multiclass", ["--batch_size", "2"]),
    ("skip", "multiclass", ["--batch_size", "2"]),
    ("sweep", "sequential", ["--batch_size", "1"]),
    ("skip", "sequential", ["--batch_size", "1"]),
    ("single", "multiclass", ["--single_model", "7"]),
    ("single", "sequential", ["--single_model", "7", "--edge_analysis"]),
]


def _variables(seed: int) -> dict:
    """Random flax variables of the port's DeepLabV3+ in numpy: kernels of
    variance 1/fan_in, BatchNorm leaves around their init."""
    rs = np.random.RandomState(seed)
    out = {}
    for col, tree in to_flax_variables(TEMPLATE_MODEL.state_dict()).items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            if path[-1] == "kernel":
                a = rs.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
            elif path[-1] == "scale":
                a = 1.0 + 0.1 * rs.randn(*a.shape)
            elif path[-1] in ("bias", "mean"):
                a = 0.1 * rs.randn(*a.shape)
            elif path[-1] == "var":
                a = rs.uniform(0.5, 1.5, a.shape)
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _jax_state(variables, step=0):
    return jtrainer.TrainState(step=jnp.asarray(step, jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=jtrainer.make_optimizer().init(variables["params"]))


def _results_dir(package, name, cli):
    """The run's results directory; the second call reuses the sweep's."""
    return f"{package}_{'sweep' if name == 'skip' else name}_{cli}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("eval_cli")
    save_dir = work / SAVE_DIR
    states = [_jax_state(_variables(seed), step=4 * epoch) for epoch, seed in ((3, 0), (7, 1))]
    for epoch, state in zip((3, 7), states):
        jck.save_checkpoint(str(save_dir), "deeplabv3p", epoch, state)
    template = states[0]
    torch.save(fake_smp_state_dict(np.random.RandomState(2)),
               str(save_dir / "deeplabv3p_epoch9.pt"))

    compiled = {}
    make_eval_step, build_port_model = jtrain.make_eval_step, pmodels.build_model

    def shared_eval_step(model, apply_union_reverse=False):
        """The JAX eval step, compiled once per (union_reverse, batch shape)
        at XLA's CPU optimization level 1 (it compiles faster)."""
        jitted = make_eval_step(model, apply_union_reverse)

        def eval_step(state, batch):
            key = (apply_union_reverse, batch["image"].shape)
            if key not in compiled:
                compiled[key] = jitted.lower(state, batch).compile(
                    compiler_options={"xla_backend_optimization_level": 1})
            return compiled[key](state, batch)

        return eval_step

    out = {"work": work}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for k in ("EXPTNAME", "MAXCHANNELS", "IMG_SIZE", "BBOX_DIR"):
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setattr(jmodels, "build_model",
                   functools.partial(jmodels.build_model, dtype=jnp.float64))
        mp.setattr(jtrain, "create_train_state", lambda *a, **k: template)
        mp.setattr(jtrain, "make_eval_step", shared_eval_step)
        mp.setattr(pmodels, "build_model",
                   lambda *a, **k: build_port_model(*a, **k).double())
        for name, cli, flags in RUNS:
            for package, index in (("jax", 0), ("port", 1)):
                module = CLIS[cli][index]
                argv = flags + ["--dataset", "synthetic",
                                "--results_dir", _results_dir(package, name, cli)]
                if package == "port":
                    argv += ["--platform", "cpu"]
                log = io.StringIO()
                with contextlib.redirect_stdout(log), jax.enable_x64(package == "jax"):
                    result = module.test(module.build_argparser().parse_args(argv))
                out[package, name, cli] = (result, log.getvalue())
    return out


def _ranking(log):
    return re.findall(r"^Epoch (\d+) : Organ : (\S+) DICE Score", log, re.M)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("cli", list(CLIS))
def test_sweep_scores_as_jax(runs, cli):
    (want, want_log), (got, got_log) = runs["jax", "sweep", cli], runs["port", "sweep", cli]
    assert [e for e, _ in got] == [e for e, _ in want] == EPOCHS
    for (epoch, g), (_, w) in zip(got, want):
        assert g.shape == (len(ORGANS),) and np.isfinite(g).all()
        assert ((g >= 0) & (g <= 1)).all()
        np.testing.assert_allclose(g, w, rtol=DICE_RTOL, err_msg=f"epoch {epoch}")
    assert _ranking(got_log) == _ranking(want_log)
    assert len(_ranking(got_log)) == len(EPOCHS) * len(ORGANS)
    assert got_log.count("Finished Testing") == len(EPOCHS)
    # the two packages' Dice of the three epochs differ, so the ranking means something
    assert len({tuple(np.round(d, 3)) for _, d in got}) == len(EPOCHS)


@pytest.mark.parametrize("cli", list(CLIS))
def test_second_call_skips(runs, cli):
    for package in ("jax", "port"):
        result, log = runs[package, "skip", cli]
        assert result == []
        for e in EPOCHS:
            assert f"Skipping epoch {e}! Test already done!" in log
    for package in ("jax", "port"):
        root = runs["work"] / _results_dir(package, "sweep", cli)
        assert _files(root) == [] and sorted(os.listdir(root)) == [
            str(e).zfill(4) for e in EPOCHS]


@pytest.mark.parametrize("cli", list(CLIS))
def test_single_model_overlays(runs, cli):
    work = runs["work"]
    root = {p: work / _results_dir(p, "single", cli) / "0007" / ",".join(ORGANS)
            for p in ("jax", "port")}
    names = _files(root["jax"])
    # 4 test images x (3 organs + all_parts) x (gt, pred)
    assert _files(root["port"]) == names and len(names) == 4 * 4 * 2
    for n in names:
        got = cv2.imread(str(root["port"] / n))
        want = cv2.imread(str(root["jax"] / n))
        assert got is not None and got.shape == (32, 32, 3), n
        if n.endswith("_gt.png"):
            assert np.array_equal(got, want), n
        else:
            assert np.abs(got.astype(int) - want).max() <= 1, n
    (want, _), (got, _) = runs["jax", "single", cli], runs["port", "single", cli]
    assert [e for e, _ in got] == [e for e, _ in want] == [7]
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=DICE_RTOL)


def test_edge_analysis_pngs(runs):
    work = runs["work"]
    root = {p: work / _results_dir(p, "single", "sequential") / "edge_analysis_epoch7"
            for p in ("jax", "port")}
    names = _files(root["jax"])
    # 2 images x 2 adjacent organ pairs x 3 maps
    assert _files(root["port"]) == names and len(names) == 12
    for n in names:
        got = cv2.imread(str(root["port"] / n), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(root["jax"] / n), cv2.IMREAD_UNCHANGED)
        assert got is not None and got.shape == want.shape == (32, 32), n
        assert np.abs(got.astype(int) - want).max() <= 1, n


@pytest.mark.parametrize("cli", list(CLIS))
def test_card_is_default_device(cli, monkeypatch):
    module = CLIS[cli][1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.test(module.build_argparser().parse_args(["--dataset", "synthetic"]))
    with pytest.raises(ValueError, match="platform"):
        module.test(module.build_argparser().parse_args(["--platform", "tpu"]))
