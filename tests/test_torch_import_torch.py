"""The port's import of the reference's PyTorch checkpoints
(``ecologysemanticsegmentation_torch/models/import_torch.py`` and the
``.pt`` branch of ``train/checkpoint.py::load_checkpoint_file``) held
against the JAX package's ``models/import_torch.py``.

One seeded synthetic smp 0.3.3 ``DeepLabV3Plus(resnet34)`` state dict (the
key layout of the reference's ``torch.save(net.state_dict())``, made here
after ``tests/test_import_torch.py``) is mapped by both:

* every leaf of the port's flax trees equals JAX's, bitwise, and the port's
  ``state_dict`` equals ``from_flax_variables`` of JAX's trees, bitwise;
* ``load_checkpoint_file`` of the ``.pt`` file (bare and under a
  ``"state_dict"`` key) gives a model whose eval forward at 64 px matches
  the JAX model's forward of JAX's import (float32 on both sides; rtol 1e-4
  / atol 1e-4, the tolerance ``tests/test_torch_model.py`` holds the
  port's DeepLabV3+ to);
* a checkpoint of another class count gives None, as does the depthwise
  wrapper's layout in a plain DeepLabV3+ template; the wrapper's trees
  equal JAX's (its forward: ``tests/test_torch_models_resnet.py``);
* ``strip_smp_deeplab_prefix`` equals JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ecologysemanticsegmentation_tpu.models import import_torch as jimp
from ecologysemanticsegmentation_tpu.models.deeplabv3plus import DeepLabV3Plus as FlaxDeepLab
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus, from_flax_variables
from ecologysemanticsegmentation_torch.models import import_torch as pimp
from ecologysemanticsegmentation_torch.train import create_train_state, make_optimizer
from ecologysemanticsegmentation_torch.train.checkpoint import load_checkpoint_file
from _torch_parallel_ranks import bound_threads

bound_threads()

TOL = dict(rtol=1e-4, atol=1e-4)
CLASSES, IMG, BATCH = 3, 64, 2


def fake_smp_state_dict(rs: np.random.RandomState, classes: int = CLASSES,
                        prefix: str = "") -> dict[str, torch.Tensor]:
    """A seeded smp-0.3.3 DeepLabV3Plus(resnet34) state dict of torch
    tensors: conv weights at scale 0.02, BatchNorm leaves around 1."""
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = (0.02 * rs.normal(size=(o, i, k, k))).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1.0 + 0.1 * rs.normal(size=c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rs.normal(size=c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rs.normal(size=c)).astype(np.float32)
        sd[f"{name}.running_var"] = rs.uniform(0.5, 1.5, size=c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    def sep(name, i, o, bn_name):
        sd[f"{name}.0.weight"] = (0.02 * rs.normal(size=(i, 1, 3, 3))).astype(np.float32)
        sd[f"{name}.1.weight"] = (0.02 * rs.normal(size=(o, i, 1, 1))).astype(np.float32)
        bn(bn_name, o)

    conv("encoder.conv1", 64, 3, 7)
    bn("encoder.bn1", 64)
    in_ch = 64
    for layer, blocks, width in [(1, 3, 64), (2, 4, 128), (3, 6, 256), (4, 3, 512)]:
        for b in range(blocks):
            base = f"encoder.layer{layer}.{b}"
            conv(f"{base}.conv1", width, in_ch if b == 0 else width, 3)
            bn(f"{base}.bn1", width)
            conv(f"{base}.conv2", width, width, 3)
            bn(f"{base}.bn2", width)
            if b == 0 and in_ch != width:
                conv(f"{base}.downsample.0", width, in_ch, 1)
                bn(f"{base}.downsample.1", width)
        in_ch = width
    conv("decoder.aspp.0.convs.0.0", 256, 512, 1)
    bn("decoder.aspp.0.convs.0.1", 256)
    for i in (1, 2, 3):
        sep(f"decoder.aspp.0.convs.{i}.0", 512, 256, f"decoder.aspp.0.convs.{i}.1")
    conv("decoder.aspp.0.convs.4.1", 256, 512, 1)
    bn("decoder.aspp.0.convs.4.2", 256)
    conv("decoder.aspp.0.project.0", 256, 256 * 5, 1)
    bn("decoder.aspp.0.project.1", 256)
    sep("decoder.aspp.1", 256, 256, "decoder.aspp.2")
    conv("decoder.block1.0", 48, 64, 1)
    bn("decoder.block1.1", 48)
    sep("decoder.block2.0", 256 + 48, 256, "decoder.block2.1")
    conv("segmentation_head.0", classes, 256, 1)
    sd["segmentation_head.0.bias"] = (0.1 * rs.normal(size=classes)).astype(np.float32)
    return {prefix + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def state_dict():
    return fake_smp_state_dict(np.random.RandomState(0))


def _template(classes=CLASSES):
    model = DeepLabV3Plus(num_classes=classes).to(memory_format=torch.channels_last)
    return create_train_state(model, torch.Generator().manual_seed(1), make_optimizer())


def test_import_equals_jax_leaf_for_leaf(state_dict):
    got, want = pimp.smp_checkpoint_to_variables(state_dict), \
        jimp.smp_checkpoint_to_variables(state_dict)
    for col in ("params", "batch_stats"):
        g, w = flatten_dict(got[col]), flatten_dict(want[col])
        assert set(g) == set(w) and len(w) > 80, col
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg="/".join(k))
    port_sd = from_flax_variables(got)
    jax_sd = from_flax_variables(want)
    assert set(port_sd) == set(jax_sd) == set(_template().model.state_dict())
    for k, v in jax_sd.items():
        assert torch.equal(port_sd[k], v), k
    enc = pimp.resnet_encoder_from_torch(state_dict, prefix="encoder.")
    jenc = jimp.resnet_encoder_from_torch(state_dict, prefix="encoder.")
    for a, b in zip(enc, jenc):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert set(fa) == set(fb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fb)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "state_dict_key"])
def test_pt_file_forward_matches_jax(state_dict, tmp_path, wrapped):
    path = str(tmp_path / "reference_epoch3.pt")
    torch.save({"state_dict": state_dict} if wrapped else state_dict, path)
    state = load_checkpoint_file(path, _template())
    assert state is not None and state.step == 0
    images = np.random.RandomState(2).rand(BATCH, IMG, IMG, 3).astype(np.float32)
    model = state.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    variables = jimp.smp_checkpoint_to_variables(state_dict)
    want = FlaxDeepLab(num_classes=CLASSES, dtype=jnp.float32).apply(
        variables, jnp.asarray(images), train=False)
    assert got.shape == (BATCH, IMG, IMG, CLASSES)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.abs(got).max() > 0.1  # the weights reached the output


def test_mismatched_or_unported_pt_returns_none(state_dict, tmp_path):
    path = str(tmp_path / "one_class.pt")
    torch.save(fake_smp_state_dict(np.random.RandomState(3), classes=1), path)
    assert load_checkpoint_file(path, _template(classes=CLASSES)) is None
    assert load_checkpoint_file(path, _template(classes=1)) is not None
    wrapper = {**{f"smp_deeplab_model.{k}": v for k, v in state_dict.items()},
               "last_layers.weight": torch.zeros(3, 3, 1, 1), "last_layers.bias": torch.zeros(3)}
    path = str(tmp_path / "depthwise.pt")
    torch.save(wrapper, path)
    assert load_checkpoint_file(path, _template()) is None
    got, want = pimp.smp_checkpoint_to_variables(wrapper), jimp.smp_checkpoint_to_variables(
        wrapper)
    for col in ("params", "batch_stats"):
        g, w = flatten_dict(got[col]), flatten_dict(want[col])
        assert set(g) == set(w) and ("last_layers", "kernel") in flatten_dict(got["params"])
        assert all(np.array_equal(g[k], np.asarray(w[k])) for k in w)
    corrupt = tmp_path / "corrupt.pt"
    corrupt.write_bytes(b"not a checkpoint")
    assert load_checkpoint_file(str(corrupt), _template()) is None


def test_strip_prefix_equals_jax(state_dict):
    wrapped = {**{f"smp_deeplab_model.{k}": v for k, v in state_dict.items()},
               "last_layers.weight": torch.zeros(3, 3, 1, 1)}
    got, want = pimp.strip_smp_deeplab_prefix(wrapped), jimp.strip_smp_deeplab_prefix(wrapped)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)
    assert not any("segmentation_head" in k for k in got)
