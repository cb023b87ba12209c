"""The port's per-sample augmentation (``augment_batch_per_sample``,
``AUGMENT_PER_SAMPLE=1``) held to the JAX package's definition of it
(``tests/test_augment_parity.py``): sample ``i`` of the per-sample pipeline
is the batch-uniform pipeline run on the singleton batch ``[i]`` with that
sample's values, bitwise.

* B = 6 at 32 px, in both CLAHE forms, with draws forced so that every
  OneOf op, the crop, the flip and the rotation each occur (alone and
  composed), and one sample has no gate on;
* an identity warp (every gate off) leaves a sample bitwise unchanged;
* ``AUGMENT_PER_SAMPLE=1`` at import selects the per-sample path in the
  train step, and a per-sample augmented step equals the step on the
  batch the per-sample pipeline returns from the same generators;
* each OneOf op runs once a call, whatever the batch;
* the draws: where they live, their dtypes and their rates.

The batch-uniform ops reused here are held against the JAX package by
``tests/test_torch_augment.py``.  Inputs are made with numpy from a seed.
No JAX is compiled.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_torch.data import augment as pa
from ecologysemanticsegmentation_torch.train import trainer as ptrainer
from _torch_parallel_ranks import bound_threads

bound_threads()

B, H, W = 6, 32, 32
ROOT = Path(__file__).resolve().parent.parent


def _batch(b=B, h=H, w=W, seed=0):
    rs = np.random.RandomState(seed)
    images = torch.from_numpy(rs.rand(b, h, w, 3).astype(np.float32))
    masks = torch.from_numpy(
        rs.choice(np.array([-1.0, 0.0, 1.0, 2.0], np.float32), size=(b, h, w, 3)))
    return images, masks


def _forced_params(seed=1):
    """Per-sample draws with every OneOf op and every warp case forced:
    sample 0 has every gate off, 1 crops, 2 flips, 3 rotates, 4 crops,
    flips and rotates, 5 flips and rotates; each OneOf op is some sample's
    choice, with its gates on."""
    params = pa.draw_augment_params_per_sample(torch.Generator().manual_seed(seed),
                                               torch.Generator().manual_seed(seed + 100),
                                               B, H, W)
    on = torch.ones(B, 1, 1, 1, dtype=torch.bool)
    params["outer"] = on.clone()
    params["outer"][0] = False
    for block in ("blur", "color"):
        params[f"{block}_gate"] = on.clone()
        params[f"{block}_gate"][0] = False
    params["blur_choice"] = torch.tensor([0, 0, 1, 2, 3, 3])
    params["color_choice"] = torch.tensor([1, 0, 1, 2, 3, 0])
    params["crop_gate"] = torch.tensor([False, True, False, False, True, False])
    params["flip_gate"] = torch.tensor([False, False, True, False, True, True])
    params["rot_gate"] = torch.tensor([False, False, False, True, True, True])
    params["degree"] = torch.tensor([0.0, 12.0, 0.0, 37.0, 33.0, 71.0])
    for k in ("pca_gate", "shuffle_gate", "gray_gate", "hsv_gate", "clahe_gate", "tone_gate"):
        params[k] = torch.tensor([False, True, True, False, True, True])[:, None, None, None]
    return params


@pytest.mark.parametrize("tiled", [False, True], ids=["global", "tiled"])
def test_per_sample_equals_singleton_applies(tiled):
    images, masks = _batch()
    params = _forced_params()
    img, mask = pa.apply_augment_per_sample(images, masks, params, tiled_clahe=tiled)
    assert img.dtype == mask.dtype == torch.bfloat16 and img.shape == images.shape
    ops, warps = set(), set()
    for i in range(B):
        one = pa.sample_augment_params(params, i)
        if bool(one["outer"].all()):
            ops |= {one["blur_op"], one["color_op"]}
        warps.add(tuple(one[k] for k in ("crop_gate", "flip_gate", "rot_gate")))
        want_img, want_mask = pa.apply_augment(images[i:i + 1], masks[i:i + 1], one,
                                               tiled_clahe=tiled)
        assert torch.equal(img[i], want_img[0]), i
        assert torch.equal(mask[i], want_mask[0]), i
    assert ops == set(pa.BLUR_NAMES) | set(pa.COLOR_NAMES)
    assert {(True, False, False), (False, True, False), (False, False, True),
            (True, True, True), (False, False, False)} <= warps
    # the warps moved the samples whose gates fired
    assert not torch.equal(mask[1], masks[1].to(torch.bfloat16))


def test_identity_warp_is_bitwise_noop():
    images, masks = _batch(seed=3)
    params = pa.draw_augment_params_per_sample(torch.Generator().manual_seed(5),
                                               torch.Generator().manual_seed(6), B, H, W)
    off = torch.zeros(B, dtype=torch.bool)
    ys, xs = pa._composed_warp_coords_per_sample(H, W, off, params["crop_box"], off, off,
                                                 params["degree"])
    assert torch.equal(ys, torch.arange(H, dtype=torch.float32)[:, None].expand(B, H, W))
    assert torch.equal(xs, torch.arange(W, dtype=torch.float32)[None, :].expand(B, H, W))
    img = (images * 1.3 - 0.1).to(torch.bfloat16)  # out of range too, as after an earlier op
    assert torch.equal(pa._bilinear_warp(img, ys, xs), img)
    assert torch.equal(pa._nearest_warp(masks.to(torch.bfloat16), ys, xs),
                       masks.to(torch.bfloat16))


def test_per_sample_flag_selects_trainer_path():
    """``AUGMENT_PER_SAMPLE`` is read at import (a fresh interpreter for the
    flag; the default in this one)."""
    assert pa.PER_SAMPLE is False
    assert ptrainer.augment_batch is pa.augment_batch
    code = ("from ecologysemanticsegmentation_torch.data import augment as a\n"
            "from ecologysemanticsegmentation_torch.train import trainer as t\n"
            "print(a.PER_SAMPLE, t.augment_batch is a.augment_batch_per_sample)\n")
    env = dict(os.environ, AUGMENT_PER_SAMPLE="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.split() == ["True", "True"]


def test_per_sample_step_is_step_of_augmented_batch(monkeypatch):
    from ecologysemanticsegmentation_torch.models import DeepLabV3Plus
    from ecologysemanticsegmentation_torch.train import create_train_state, make_optimizer
    from ecologysemanticsegmentation_torch.train import make_train_step

    monkeypatch.setattr(ptrainer, "augment_batch", pa.augment_batch_per_sample)
    images, masks = _batch(b=2, seed=6)
    batch = {"image": images, "label": masks.clamp(max=1.0)}
    runs = []
    for augment in (True, False):
        model = DeepLabV3Plus(num_classes=3, decoder_features=16, aspp_dropout=0.5,
                              upsample_head=False).to(memory_format=torch.channels_last)
        tx = make_optimizer(1e-3)
        state = create_train_state(model, torch.Generator().manual_seed(0), tx)
        step = make_train_step(model, tx, augment=augment, lowres_head=True)
        host, dev = torch.Generator().manual_seed(2), torch.Generator().manual_seed(3)
        if augment:
            state, met = step(state, batch, (host, dev), 0.0, [1.0, 1.0, 1.0], 1e-3, None)
        else:
            aimg, alab = pa.augment_batch_per_sample((host, dev), batch["image"],
                                                     batch["label"])
            state, met = step(state, {"image": aimg, "label": alab}, dev, 0.0,
                              [1.0, 1.0, 1.0], 1e-3, None)
        runs.append((met, [p.detach().clone() for p in model.parameters()]))
    (met_a, par_a), (met_b, par_b) = runs
    for k in met_a:
        assert torch.equal(met_a[k], met_b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(par_a, par_b))


def test_each_one_of_op_runs_once_per_call(monkeypatch):
    calls = []

    def counted(ops):
        return tuple((name, lambda x, _f=fn, _n=name, **p: calls.append((_n, x.shape[0]))
                      or _f(x, **p), spec) for name, fn, spec in ops)

    monkeypatch.setattr(pa, "_BLUR_OPS", counted(pa._BLUR_OPS))
    monkeypatch.setattr(pa, "_COLOR_OPS", counted(pa._COLOR_OPS))
    b = 32
    images, masks = _batch(b=b, h=16, w=16, seed=7)
    params = pa.draw_augment_params_per_sample(torch.Generator().manual_seed(8),
                                               torch.Generator().manual_seed(9), b, 16, 16)
    pa.apply_augment_per_sample(images, masks, params)
    names = [n for n, _ in calls]
    assert sorted(names) == sorted(set(names)) == sorted(pa.BLUR_NAMES + pa.COLOR_NAMES)
    assert sum(n for _, n in calls) == 2 * b


def test_per_sample_draws():
    b = 4096
    params = pa.draw_augment_params_per_sample(torch.Generator().manual_seed(0),
                                               torch.Generator().manual_seed(1), b, H, W)
    for block, ops in (("blur", pa.BLUR_NAMES), ("color", pa.COLOR_NAMES)):
        choice = params[f"{block}_choice"]
        assert choice.device.type == "cpu" and choice.dtype == torch.int64
        assert set(choice.tolist()) == set(range(len(ops)))
        assert set(params[block]) == set(ops)
    assert params["blur"]["fog"]["field"].shape == (b, 2, 2, 1)
    assert params["color"]["color_jitter"]["hshift"].shape == (b, 1, 1)
    assert params["color"]["gamma"]["g"].dtype == torch.bfloat16
    top, left, ch, cw = params["crop_box"]
    assert all(v.shape == (b,) and v.dtype == torch.float32 for v in params["crop_box"])
    assert bool((ch >= 8).all() and (ch <= H).all() and (top >= 0).all()
                and (top + ch <= H + 1e-4).all() and (left + cw <= W + 1e-4).all())
    for k, p in (("crop_gate", 0.21), ("flip_gate", 0.35), ("rot_gate", 0.4)):
        assert params[k].shape == (b,) and abs(params[k].float().mean().item() - p) < 0.03, k
    degree = params["degree"]
    assert bool((degree == degree.round()).all() and (degree >= 0).all() and (degree < 90).all())
    assert abs((degree == 0).float().mean().item() - (0.2 + 0.8 / 90)) < 0.03


def test_augment_sample_is_singleton_batch():
    images, masks = _batch(b=1, seed=10)
    gens = (torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
    img, mask = pa.augment_sample(gens, images[0], masks[0])
    gens = (torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
    want_img, want_mask = pa.augment_batch(gens, images, masks)
    assert img.dtype == mask.dtype == torch.float32 and img.shape == (H, W, 3)
    assert torch.equal(img, want_img[0].float()) and torch.equal(mask, want_mask[0].float())
