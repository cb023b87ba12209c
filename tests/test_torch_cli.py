"""The port's ``train_multiclass`` CLI, called in-process on the CPU
(``--platform cpu``) at ``SAMPLE=1 IMGSIZE=32``, three organs, batch 8,
3 epochs without augmentation, then resumed with ``--num_epochs 4``.

* its files sit at the JAX package's layout; ``metrics.csv`` has the JAX
  CLI's columns, and its per-epoch ``lr`` and ``bg_weight`` are the JAX
  schedules'; the ``val_images/<epoch>/`` names are the JAX CLI's;
* the resumed call loads the latest file and runs one epoch;
* the JAX package's ``load_recent_model`` restores the CLI's file;
* the flags whose parts are not ported raise ``NotImplementedError``
  naming their ROADMAP item, and the card is the default device;
* one epoch runs with neither cv2 nor PIL: the port's numpy drawing and
  its own PNG writer, whose triplets cv2 reads back.
"""

import contextlib
import io
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ecologysemanticsegmentation_torch import train_multiclass as tcli
from ecologysemanticsegmentation_torch.data import imops as timops
from ecologysemanticsegmentation_torch.data import native as tnative
from ecologysemanticsegmentation_torch.models.from_flax import to_flax_variables
from ecologysemanticsegmentation_torch.train import checkpoint as tck
from ecologysemanticsegmentation_tpu import train_multiclass as jcli
from ecologysemanticsegmentation_tpu.train import checkpoint as jck
from ecologysemanticsegmentation_tpu.train import schedules as js
from ecologysemanticsegmentation_tpu.train import trainer as jtrainer
from _torch_parallel_ranks import bound_threads

bound_threads()

ORGANS = ("whole_body", "ventral_side", "dorsal_side")
ENV = {"SAMPLE": "1", "IMGSIZE": "32", "ORGANS": ",".join(ORGANS)}
ARGS = ["--platform", "cpu", "--dataset", "synthetic", "--batch_size", "8", "--no_augment"]
SAVE_DIR = os.path.join("models", "deeplabv3p", "channels256", "img32")
# The row the JAX CLI logs each epoch (its train_multiclass.py:300-305).
JAX_METRICS = sorted(["epoch", "step", "lr", "bg_weight", "loss", "bce", "focal_dice",
                      "images_per_sec"])


def _listing(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Train 3 epochs, then resume with --num_epochs 4; the files and output
    of each call."""
    work = str(tmp_path_factory.mktemp("torch_cli"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for k in ("EXPTNAME", "MAXCHANNELS", "IMG_SIZE", "BBOX_DIR"):
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        for name, epochs in (("first", "3"), ("resumed", "4")):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                state = tcli.train(tcli.build_argparser().parse_args(
                    ARGS + ["--num_epochs", epochs]))
            with open(os.path.join("models", "deeplabv3p", "metrics.csv")) as f:
                rows = [line.strip().split(",") for line in f]
            out[name] = {"log": log.getvalue(), "files": _listing(work), "rows": rows,
                         "state": state}
    out["work"] = work
    return out


def test_cli_files_at_jax_layout(runs):
    files = runs["first"]["files"]
    ckpts = [f for f in files if f.endswith(".ckpt")]
    assert ckpts == [os.path.join(SAVE_DIR, f"deeplabv3p_epoch{e}.ckpt") for e in (0, 2)]
    assert "finished training" in runs["first"]["log"]
    # 27 training images in batches of 8 (the last padded): 4 steps an epoch
    assert runs["first"]["log"].count("Epoch: 1 ; Batch:") == 4


def test_cli_metrics_match_jax_schedules(runs):
    header, *rows = runs["first"]["rows"]
    assert header == JAX_METRICS
    col = {name: i for i, name in enumerate(header)}
    lr_at = js.cosine_annealing_warm_restarts(3e-4, t_0=100)
    bg = js.BackgroundWeightSchedule(3, seed=0)
    assert [float(r[col["epoch"]]) for r in rows] == [0.0, 1.0, 2.0]
    for r in rows:
        epoch = int(float(r[col["epoch"]]))
        assert float(r[col["lr"]]) == lr_at(epoch + 1)
        assert float(r[col["bg_weight"]]) == bg(epoch + 1)
        assert float(r[col["step"]]) == 4 * (epoch + 1)
        assert np.isfinite([float(r[col[k]]) for k in ("loss", "bce", "focal_dice")]).all()


def test_cli_val_images_named_as_jax(runs, tmp_path):
    got = [f for f in runs["first"]["files"] if f.startswith("val_images")]
    img = np.zeros((32, 32, 3), np.float32)
    lab = np.zeros((32, 32, 3), np.float32)
    for epoch in range(3):
        jcli.save_val_triplets(str(tmp_path / "val_images"), epoch, 0, img, lab, lab, ORGANS)
    assert got == _listing(str(tmp_path))


def test_cli_resumes_from_latest(runs):
    log = runs["resumed"]["log"]
    assert "Used latest model file: " + os.path.join(SAVE_DIR, "deeplabv3p_epoch2.ckpt") in log
    assert "Epoch: 4 ; Batch: 4/4" in log and "Epoch: 3 ;" not in log
    header, *rows = runs["resumed"]["rows"]
    assert [float(r[header.index("epoch")]) for r in rows] == [0.0, 1.0, 2.0, 3.0]
    assert os.path.join(SAVE_DIR, "deeplabv3p_epoch3.ckpt") in runs["resumed"]["files"]
    assert runs["resumed"]["state"].step == 16


def test_jax_restores_cli_checkpoint(runs):
    state = runs["resumed"]["state"]
    v = to_flax_variables(state.model.state_dict())
    template = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                   batch_stats=v["batch_stats"],
                                   opt_state=jtrainer.make_optimizer(3e-4).init(v["params"]))
    epoch, restored = jck.load_recent_model(os.path.join(runs["work"], SAVE_DIR), template,
                                            "deeplabv3p")
    assert epoch == 3
    flat = jax.tree_util.tree_flatten_with_path
    want = flat(tck.state_to_flax(state))[0]
    got = dict(flat(serialization.to_state_dict(jax.device_get(restored)))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), leaf), jax.tree_util.keystr(path)
    assert int(restored.opt_state.count) == 16


@pytest.mark.parametrize("flags,item", [
    (["--aot_cache", "cache"], "item 11"),
    (["--spatial_partition", "2"], "item 10"),
])
def test_cli_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.train(tcli.build_argparser().parse_args(ARGS + flags))


def test_cli_refuses_other_launches_and_devices(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 10"):
        tcli.train(tcli.build_argparser().parse_args(ARGS))
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="platform"):
        tcli.train(tcli.build_argparser().parse_args(["--platform", "tpu"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.train(tcli.build_argparser().parse_args(["--dataset", "synthetic"]))


def test_step_generators_depend_on_seed_and_key_alone():
    def draws(seed, key):
        host, dev = tcli.step_generators(seed, key, "cpu", augment=True)
        return torch.rand(4, generator=host), torch.rand(4, generator=dev)

    a, b = draws(0, 1_000_003 + 2), draws(0, 1_000_003 + 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(draws(0, 3)[0], a[0]) and not torch.equal(draws(1, 1_000_005)[0], a[0])
    assert isinstance(tcli.step_generators(0, 5, "cpu", augment=False), torch.Generator)


def test_cli_runs_without_cv2_or_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(timops, "cv2", None)
    monkeypatch.setattr(tnative, "cv2", None)
    monkeypatch.setattr(timops, "_pil_image", lambda: None)
    for k in ("EXPTNAME", "MAXCHANNELS", "IMG_SIZE", "BBOX_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.train(tcli.build_argparser().parse_args(ARGS + ["--num_epochs", "1"]))
    assert os.path.join(SAVE_DIR, "deeplabv3p_epoch0.ckpt") in _listing(str(work))
    pngs = [f for f in _listing(str(work)) if f.startswith("val_images")]
    img = np.zeros((32, 32, 3), np.float32)
    lab = np.zeros((32, 32, 3), np.float32)
    jcli.save_val_triplets(str(tmp_path / "jax" / "val_images"), 0, 0, img, lab, lab, ORGANS)
    assert pngs == _listing(str(tmp_path / "jax"))
    for png in pngs:
        back = cv2.imread(str(work / png), cv2.IMREAD_UNCHANGED)
        assert back is not None and back.shape[:2] == (32, 32), png
