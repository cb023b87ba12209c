"""The port's VGG19-BN U-Net held against the JAX package's, from the same
weights, on the CPU at 32 px, batch 2, C = 3:

* at ``max_channels`` 256 and 512 (both decoder plans, both truncations),
  with and without deep supervision: the flax tree, from
  ``jax.eval_shape(model.init, ...)``, equals the port's key for key and
  shape for shape, both ways; the eval forward (logits and side heads,
  float64 models) matches at ``_torch_models.TOL``;
* a seeded synthetic torchvision ``vgg19_bn`` features state dict maps as
  the JAX importer maps it, at both truncations;
* one train step with deep supervision and dropout 0 (unaugmented,
  full-resolution losses) against JAX ``make_train_step(deepsupervision=
  True)``, both in float64 (the losses in float32 in both packages), from
  the same weights and batch: the loss and metrics at rtol 1e-5 and the
  gradients before Adam at 1e-5 of each tensor's scale, the tolerances
  ``tests/test_torch_train_step.py`` holds the flagship step to (a conv
  bias that feeds a BatchNorm has a zero gradient but for rounding: its
  scale is taken as 1e-9 of the largest gradient), the BatchNorm
  statistics at rtol / atol 1e-6.  The JAX step is this module's one compile (XLA's
  CPU optimization level 1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ecologysemanticsegmentation_tpu.models import VGGUNet as FlaxVGG
from ecologysemanticsegmentation_tpu.models import import_torch as jimp
from ecologysemanticsegmentation_tpu.train import trainer as jt
from ecologysemanticsegmentation_torch.losses import LOSS_NAMES
from ecologysemanticsegmentation_torch.models import VGGUNet, to_flax_variables
from ecologysemanticsegmentation_torch.models import import_torch as pimp
from ecologysemanticsegmentation_torch.models.vgg import VGG19_CFG
from ecologysemanticsegmentation_torch.train import (
    TrainState,
    init_weights,
    make_forward,
    make_optimizer,
    make_train_step,
)
from _torch_models import TOL, assert_same_tree, jax_apply, load, perturbed_variables
from _torch_parallel_ranks import bound_threads

bound_threads()

CLASSES, IMG, BATCH = 3, 32, 2
LR, B1 = 1e-3, 0.9
GATES = [1.0, 0.5, 0.7]


@pytest.mark.parametrize("max_channels", [256, 512])
@pytest.mark.parametrize("ds", [True, False], ids=["ds", "plain"])
def test_flax_tree(max_channels, ds):
    assert_same_tree(FlaxVGG(CLASSES, max_channels, deepsupervision=ds),
                     VGGUNet(CLASSES, max_channels, deepsupervision=ds))


@pytest.mark.parametrize("max_channels", [256, 512])
def test_forward_eval(max_channels):
    images = np.random.RandomState(1).rand(BATCH, IMG, IMG, 3)
    port = VGGUNet(CLASSES, max_channels, deepsupervision=True)
    variables = perturbed_variables(port)
    port = load(port, variables).eval()
    with torch.no_grad():
        logits, heads = port(torch.from_numpy(images))
    want, want_heads = jax_apply(
        FlaxVGG(CLASSES, max_channels, deepsupervision=True, dtype=jnp.float64), variables,
        images, train=False)
    assert len(heads) == len(want_heads) == (3 if max_channels == 256 else 5)
    for got, w in zip([logits] + heads, [want] + list(want_heads)):
        assert got.dtype == torch.float32 and got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL)
    # shallowest head first: at half the input's resolution
    assert heads[0].shape[1] == IMG // 2
    # the inference forward (images rounded to bf16, as in JAX) reads the main head
    with torch.no_grad():
        main = port(torch.from_numpy(images).to(torch.bfloat16).double())[0]
    assert torch.equal(make_forward(port)(None, images), torch.sigmoid(main))
    # without deep supervision the logits alone, the same
    port.deepsupervision = False
    with torch.no_grad():
        assert torch.equal(port(torch.from_numpy(images)), logits)


def _vgg19_bn_features(seed: int) -> dict:
    """A seeded torchvision ``vgg19_bn`` ``features.*`` state dict: per conv
    a conv (weight, bias) and a BatchNorm, then a ReLU, a max pool per stage."""
    rs = np.random.RandomState(seed)
    sd, idx, cin = {}, 0, 3
    for spec in VGG19_CFG:
        if spec == "M":
            idx += 1
            continue
        w = int(spec)
        sd[f"features.{idx}.weight"] = rs.normal(size=(w, cin, 3, 3)).astype(np.float32)
        sd[f"features.{idx}.bias"] = rs.normal(size=w).astype(np.float32)
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"features.{idx + 1}.{leaf}"] = rs.normal(size=w).astype(np.float32)
        sd[f"features.{idx + 1}.running_var"] = rs.uniform(0.5, 1.5, w).astype(np.float32)
        sd[f"features.{idx + 1}.num_batches_tracked"] = np.array(2)
        idx, cin = idx + 3, w
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("max_channels", [256, 512])
def test_vgg19_bn_import_equals_jax(max_channels):
    sd = _vgg19_bn_features(0)
    got = pimp.vgg19_bn_encoder_from_torch(sd, max_channels)
    want = jimp.vgg19_bn_encoder_from_torch(sd, max_channels)
    for g, w in zip(got, want):
        g, w = flatten_dict(g), flatten_dict(w)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg="/".join(k))
    # the tree is the port's encoder's, at its truncation
    encoder = VGGUNet(CLASSES, max_channels).encoder
    params = to_flax_variables(encoder.state_dict())["params"]
    assert set(flatten_dict(params)) == set(flatten_dict(got[0]))
    assert len(got[0]) == 2 * (8 if max_channels == 256 else 16)


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def step_runs():
    rs = np.random.RandomState(0)
    images = (rs.rand(BATCH, IMG, IMG, 3) * 0.5
              + np.linspace(0.0, 0.5, BATCH)[:, None, None, None]).astype(np.float32)
    labels = rs.choice(np.array([0.0, 1.0, 2.0], np.float32), size=(BATCH, IMG, IMG, CLASSES))
    labels[rs.rand(*labels.shape) < 0.05] = -1.0

    model = VGGUNet(CLASSES, 256, dropout_p=0.0, deepsupervision=True).to(
        torch.float64, memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    variables = to_flax_variables(model.state_dict())

    with jax.enable_x64(True):
        fmodel = FlaxVGG(CLASSES, 256, dropout_p=0.0, deepsupervision=True, dtype=jnp.float64)
        tx = jt.make_optimizer(LR)
        f64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        params = f64(variables["params"])
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=f64(variables["batch_stats"]),
                              opt_state=jax.jit(tx.init)(params))
        jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
        args = (jnp.asarray(GATES, jnp.float32), LR, jnp.ones((2,), jnp.float32))
        jstep = jt.make_train_step(fmodel, tx, augment=False, deepsupervision=True).lower(
            state, jbatch, jax.random.PRNGKey(0), 0.0, *args,
        ).compile(compiler_options={"xla_backend_optimization_level": 1})
        state, met = jstep(state, jbatch, jax.random.PRNGKey(0), 0.0, *args)
        want = {"metrics": {k: float(v) for k, v in met.items()},
                "mu": _flat(state.opt_state.inner_state[0].mu),
                "stats": _flat(state.batch_stats)}

    tx = make_optimizer(LR)
    pstate = TrainState(step=0, model=model, optimizer=tx(model.parameters()))
    step = make_train_step(model, tx, augment=False, deepsupervision=True)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    pstate, met = step(pstate, batch, torch.Generator().manual_seed(1), 0.0, GATES, LR, None)
    named = dict(model.named_parameters())
    got = {"metrics": {k: float(v) for k, v in met.items()},
           "grads": _flat(to_flax_variables({n: p.grad for n, p in named.items()})["params"]),
           "stats": _flat(to_flax_variables(model.state_dict())["batch_stats"])}
    return want, got


def test_step_loss_and_metrics(step_runs):
    want, got = step_runs
    assert set(got["metrics"]) == set(want["metrics"]) == set(LOSS_NAMES) | {"loss", "lr"}
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    # the side heads' BCE pyramid is in the loss: the gated sum alone is less
    m = got["metrics"]
    gated = GATES[0] * m["focal_dice"] + GATES[1] * m["bce"] + GATES[2] * (
        m["generalized_dice"] + m["twersky"])
    assert m["loss"] - gated > 0.1


def test_step_gradients_before_adam(step_runs):
    want, got = step_runs
    grads = {k: v / (1.0 - B1) for k, v in want["mu"].items()}  # mu_1 = (1 - b1) g
    assert set(got["grads"]) == set(grads)
    assert any(k.startswith("ds_head") for k in grads)
    # A conv bias that feeds a train-mode BatchNorm has a zero gradient:
    # both sides hold rounding noise there, so no tensor's scale is taken
    # below 1e-9 of the step's largest gradient.
    floor = 1e-9 * max(float(np.abs(w).max()) for w in grads.values())
    for k, w in grads.items():
        scale = max(float(np.abs(w).max()), floor)
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=1e-5 * scale, err_msg=k)


def test_step_bn_stats(step_runs):
    want, got = step_runs
    assert set(got["stats"]) == set(want["stats"])
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, rtol=1e-6, atol=1e-6, err_msg=k)
