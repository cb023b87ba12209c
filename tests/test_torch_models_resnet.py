"""The port's ResNet-encoder models held against the JAX package's, from
the same weights, in float64 on the CPU at 32 px, batch 2, C = 3:

* the ResNet U-Net with resnet34 (its train mode too, at 64 px) and
  resnet50, DeepLabV3+ with resnet50 (full-resolution and 1/4-resolution
  heads) and ``DeepLabV3PlusDepthwise`` (resnet34; its tree with resnet50
  too): each model's flax tree, from
  ``jax.eval_shape(model.init, ...)``, equals the port's key for key and
  shape for shape, both ways; the eval forward matches; the U-Net's
  train-mode forward and BatchNorm statistics match;
* a seeded synthetic torchvision resnet50 state dict and a depthwise
  wrapper ``.pt`` (smp layout under ``smp_deeplab_model.``, and
  ``last_layers``) map as the JAX importer maps them, leaf for leaf, and
  load into the port's models (the ``.pt`` through ``load_checkpoint_file``).

Tolerance: ``_torch_models.TOL``; the train-mode statistics at rtol / atol
1e-6 (flax takes the variance as E[x^2] - E[x]^2, torch in two passes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ecologysemanticsegmentation_tpu import models as jm
from ecologysemanticsegmentation_tpu.models import import_torch as jimp
from ecologysemanticsegmentation_torch import models as pm
from ecologysemanticsegmentation_torch.models import import_torch as pimp
from ecologysemanticsegmentation_torch.models.resnet import resnet50
from ecologysemanticsegmentation_torch.train import create_train_state, make_optimizer
from ecologysemanticsegmentation_torch.train.checkpoint import load_checkpoint_file
from _torch_models import TOL, assert_same_tree, jax_apply, load, perturbed_variables
from _torch_parallel_ranks import bound_threads
from test_torch_import_torch import fake_smp_state_dict

bound_threads()

CLASSES, IMG, BATCH = 3, 32, 2

# id -> (port model, flax model)
MODELS = {
    "unet_resnet34": lambda dt: (pm.UNet(CLASSES, "resnet34"),
                                 jm.UNet(CLASSES, "resnet34", dtype=dt)),
    "unet_resnet50": lambda dt: (pm.UNet(CLASSES, "resnet50"),
                                 jm.UNet(CLASSES, "resnet50", dtype=dt)),
    "deeplabv3plus_resnet50": lambda dt: (
        pm.DeepLabV3Plus(CLASSES, "resnet50", aspp_dropout=0.0),
        jm.DeepLabV3Plus(CLASSES, "resnet50", aspp_dropout=0.0, dtype=dt)),
    "depthwise_resnet34": lambda dt: (
        pm.DeepLabV3PlusDepthwise(CLASSES, "resnet34", aspp_dropout=0.0),
        jm.DeepLabV3PlusDepthwise(CLASSES, "resnet34", aspp_dropout=0.0, dtype=dt)),
    "depthwise_resnet50": lambda dt: (
        pm.DeepLabV3PlusDepthwise(CLASSES, "resnet50", aspp_dropout=0.0),
        jm.DeepLabV3PlusDepthwise(CLASSES, "resnet50", aspp_dropout=0.0, dtype=dt)),
}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).rand(BATCH, IMG, IMG, 3)


@pytest.mark.parametrize("name", list(MODELS))
def test_flax_tree(name):
    port, flax = MODELS[name](jnp.bfloat16)
    assert_same_tree(flax, port)


@pytest.mark.parametrize("name", [n for n in MODELS if n != "depthwise_resnet50"])
def test_forward_eval(name, images):
    port, flax = MODELS[name](jnp.float64)
    variables = perturbed_variables(port)
    port = load(port, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    want = jax_apply(flax, variables, images, train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, IMG, IMG, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name == "deeplabv3plus_resnet50":
        # the 1/4-resolution head: the same parameters, the resize left out
        port.upsample_head = False
        with torch.no_grad():
            low = port(torch.from_numpy(images))
        want = jax_apply(jm.DeepLabV3Plus(CLASSES, "resnet50", aspp_dropout=0.0,
                                          upsample_head=False, dtype=jnp.float64),
                         variables, images, train=False)
        assert tuple(low.shape) == (BATCH, IMG // 4, IMG // 4, CLASSES)
        np.testing.assert_allclose(low.numpy(), want, **TOL)


def test_unet_forward_train_and_bn_stats():
    # 64 px: at 32 px the /32 map is 1 x 1, where batch-2 statistics make
    # the train-mode forward ill-conditioned
    images = np.random.RandomState(2).rand(BATCH, 64, 64, 3)
    port, flax = MODELS["unet_resnet34"](jnp.float64)
    variables = perturbed_variables(port)
    port = load(port, variables).train()
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    want, mutated = jax_apply(flax, variables, images, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    stats = flatten_dict(pm.to_flax_variables(port.state_dict())["batch_stats"])
    want_stats = flatten_dict(mutated["batch_stats"])
    assert set(stats) == set(want_stats)
    for k, a in want_stats.items():
        np.testing.assert_allclose(stats[k], a, rtol=1e-6, atol=1e-6, err_msg="/".join(k))


def _torchvision_resnet50(seed: int) -> dict:
    """A seeded torchvision ``resnet50`` state dict: the port's encoder
    names turned into torchvision's (``layer1.0.conv3``,
    ``layer1.0.downsample.{0,1}``), with ``num_batches_tracked`` and the
    ``fc`` head the importer ignores."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, t in resnet50().state_dict().items():
        name = name.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                        "downsample.1")
        for layer in range(1, 5):
            name = name.replace(f"layer{layer}_block", f"layer{layer}.")
        if name.endswith("running_var"):
            sd[name] = torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32))
            sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
        else:
            sd[name] = torch.from_numpy((0.05 * rs.normal(size=t.shape)).astype(np.float32))
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    return sd


def test_resnet50_import_equals_jax():
    sd = _torchvision_resnet50(0)
    assert "layer1.0.conv3.weight" in sd and "layer4.2.bn3.running_var" in sd
    got = pimp.resnet_encoder_from_torch(sd)
    want = jimp.resnet_encoder_from_torch(sd)
    for g, w in zip(got, want):
        g, w = flatten_dict(g), flatten_dict(w)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg="/".join(k))
    params = flatten_dict(got[0])
    assert ("layer3_block5", "conv3", "kernel") in params
    assert params[("layer3_block5", "bn3", "scale")].shape == (1024,)
    # every leaf of the port's resnet50 encoder, and nothing else
    encoder = resnet50()
    encoder.load_state_dict(pm.from_flax_variables({"params": got[0], "batch_stats": got[1]}))
    assert torch.equal(encoder.layer4_block2.conv3.weight,
                       sd["layer4.2.conv3.weight"])


def test_depthwise_pt_layout_equals_jax(tmp_path):
    inner = fake_smp_state_dict(np.random.RandomState(4), classes=CLASSES * 5,
                                prefix="smp_deeplab_model.")
    rs = np.random.RandomState(5)
    wrapper = {**inner,
               "last_layers.weight": torch.from_numpy(
                   (0.1 * rs.normal(size=(CLASSES, CLASSES * 5, 3, 3))).astype(np.float32)),
               "last_layers.bias": torch.from_numpy(
                   (0.1 * rs.normal(size=CLASSES)).astype(np.float32))}
    got = pimp.smp_checkpoint_to_variables(wrapper)
    want = jimp.smp_checkpoint_to_variables(wrapper)
    for col in ("params", "batch_stats"):
        g, w = flatten_dict(got[col]), flatten_dict(want[col])
        assert set(g) == set(w) and len(w) > 80, col
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg="/".join(k))
    path = str(tmp_path / "depthwise_epoch1.pt")
    torch.save(wrapper, path)
    model = pm.build_model("deeplabv3plus", CLASSES, depthwise=True, device="cpu")
    state = load_checkpoint_file(path, create_train_state(
        model, torch.Generator().manual_seed(0), make_optimizer()))
    assert state is not None
    assert torch.equal(state.model.last_layers.bias, wrapper["last_layers.bias"])
    assert torch.equal(state.model.smp_deeplab_model.head.weight,
                       wrapper["smp_deeplab_model.segmentation_head.0.weight"])
    # the wrapper's file does not load into the plain DeepLabV3+ it wraps
    plain = pm.build_model("deeplabv3plus", CLASSES * 5, device="cpu")
    assert load_checkpoint_file(path, create_train_state(
        plain, torch.Generator().manual_seed(0), make_optimizer())) is None
