"""The port's flagship train step held against the JAX package's
``make_train_step(augment=False, lowres_head=True)``, from the same weights
and the same batch, for one step and for three.

Both sides run on the CPU at 32 px, batch 2, C = 3, decoder features 32 and
``aspp_dropout=0``; the labels carry ``-1`` ignore pixels and a value 2 that
label prep binarizes.  The JAX step is compiled once, at XLA's CPU backend
optimization level 1 (its LLVM passes take most of the compile, and the
f64 results are the same at either level), and both trajectories are
computed once per module.

Both models run in float64 (the head loss stays float32 in both packages,
which cast the logits to f32).  In float32 the gradients are not a usable
reference: at batch 2 the train-mode BatchNorm backward cancels so much
that the JAX step's own f32 gradients differ from its f64 ones by far more
than the 1e-5 of scale held below, most at the ASPP pool branch's 1x1 conv
(flax takes the variance as E[x^2] - E[x]^2), and the loss's gradient
amplifies even the f32 head loss's rounding.  In f64 the algorithm is what
is compared.

Gradients before Adam come from the JAX step's first Adam moment
(``mu_1 = (1 - b1) * g``) and from the port's ``.grad`` after the step.
Tolerances, with reasons:

* step 1, loss and metrics: rtol 1e-5 (the f32 head loss in another order);
* step 1, gradients and Adam moments: atol 1e-5 of each tensor's largest entry;
* step 1, BN statistics: rtol / atol 1e-6;
* parameters: Adam's step is lr * m / (sqrt(v) + eps), about lr * sign(g),
  so where |g| is as small as the head loss's rounding an entry may move by
  up to 2 * lr per step the other way: atol 2 * lr * steps, and the mean
  difference must stay below 1e-2 * lr (nearly every entry agrees);
* step 3: those sign flips have moved both trajectories apart, so the loss
  and metrics are held at rtol 1e-4 and the BN statistics at atol 1e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from ecologysemanticsegmentation_tpu.models.deeplabv3plus import DeepLabV3Plus as FlaxDeepLab
from ecologysemanticsegmentation_tpu.train import trainer as jt
from ecologysemanticsegmentation_torch.losses import LOSS_NAMES
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus, to_flax_variables
from ecologysemanticsegmentation_torch.train import (
    TrainState,
    init_weights,
    make_optimizer,
    make_train_step,
)
from _torch_parallel_ranks import bound_threads

bound_threads()

NUM_CLASSES, FEATURES, IMG, BATCH = 3, 32, 32, 2
LR, B1 = 1e-3, 0.9
GATES = [1.0, 0.5, 0.7]
STEPS = 3


def _flat(tree):
    # np.array copies: the JAX step donates its state, and a zero-copy view
    # of a donated CPU buffer would change under the next step
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _port_flat(model, values):
    """Port parameter-shaped tensors (name -> tensor) in flax layout."""
    sd = {name: values[name] for name in model.state_dict() if name in values}
    return _flat(to_flax_variables(sd)["params"])


@pytest.fixture(scope="module")
def runs():
    rs = np.random.RandomState(0)
    # Images of unlike brightness: the ASPP pool branch normalizes a 1x1 map
    # over the batch (n = 2), and two noise images of equal mean would put
    # that BatchNorm at var ~ 0, where its gradient is rounding noise.
    images = (rs.rand(BATCH, IMG, IMG, 3) * 0.5
              + np.linspace(0.0, 0.5, BATCH)[:, None, None, None]).astype(np.float32)
    labels = rs.choice(np.array([0.0, 1.0, 2.0], np.float32), size=(BATCH, IMG, IMG, NUM_CLASSES))
    labels[rs.rand(*labels.shape) < 0.05] = -1.0

    model = DeepLabV3Plus(num_classes=NUM_CLASSES, decoder_features=FEATURES, aspp_dropout=0.0,
                          upsample_head=False).to(torch.float64, memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    variables = to_flax_variables(model.state_dict())

    # JAX: the package's own step, compiled once, in float64 (see module doc).
    with jax.enable_x64(True):
        fmodel = FlaxDeepLab(num_classes=NUM_CLASSES, decoder_features=FEATURES,
                             aspp_dropout=0.0, upsample_head=False, dtype=jnp.float64)
        tx = jt.make_optimizer(LR)
        # the conversion runs in numpy and tx.init under one jit, so that
        # setting up costs no per-leaf eager compiles
        f64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        params = f64(variables["params"])
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=f64(variables["batch_stats"]),
                              opt_state=jax.jit(tx.init)(params))
        jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
        args = (jnp.asarray(GATES, jnp.float32), LR, jnp.ones((2,), jnp.float32))
        jstep = jt.make_train_step(fmodel, tx, augment=False, lowres_head=True).lower(
            state, jbatch, jax.random.PRNGKey(0), 0.0, *args,
        ).compile(compiler_options={"xla_backend_optimization_level": 1})
        jax_run = []
        for i in range(STEPS):
            state, met = jstep(state, jbatch, jax.random.PRNGKey(i), 0.0, *args)
            adam = state.opt_state.inner_state[0]
            assert isinstance(adam, optax.ScaleByAdamState)
            jax_run.append({
                "metrics": {k: float(v) for k, v in met.items()},
                "params": _flat(state.params), "stats": _flat(state.batch_stats),
                "mu": _flat(adam.mu), "nu": _flat(adam.nu),
            })

    # Port.
    pstate = TrainState(step=0, model=model, optimizer=make_optimizer(LR)(model.parameters()))
    pstep = make_train_step(model, make_optimizer(LR), augment=False, lowres_head=True)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    gen = torch.Generator().manual_seed(1)
    port_run = []
    named = dict(model.named_parameters())
    for _ in range(STEPS):
        pstate, met = pstep(pstate, batch, gen, 0.0, GATES, LR, None)
        opt = pstate.optimizer.state
        port_run.append({
            "metrics": {k: float(v) for k, v in met.items()},
            "params": _port_flat(model, {n: p.detach() for n, p in named.items()}),
            "grads": _port_flat(model, {n: p.grad for n, p in named.items()}),
            "mu": _port_flat(model, {n: opt[p]["exp_avg"] for n, p in named.items()}),
            "nu": _port_flat(model, {n: opt[p]["exp_avg_sq"] for n, p in named.items()}),
            "stats": _flat(to_flax_variables(model.state_dict())["batch_stats"]),
        })
    assert pstate.step == STEPS
    return jax_run, port_run


def _close_to_scale(got, want, frac):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=frac * scale, err_msg=k)


@pytest.mark.parametrize("step,rtol", [(1, 1e-5), (STEPS, 1e-4)])
def test_loss_and_metrics(runs, step, rtol):
    jax_run, port_run = runs
    want, got = jax_run[step - 1]["metrics"], port_run[step - 1]["metrics"]
    assert set(got) == set(want) == set(LOSS_NAMES) | {"loss", "lr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)
    # the gated loss of the seven terms
    np.testing.assert_allclose(
        got["loss"], GATES[0] * got["focal_dice"] + GATES[1] * got["bce"]
        + GATES[2] * (got["generalized_dice"] + got["twersky"]), rtol=1e-6)


def test_gradients_before_adam(runs):
    jax_run, port_run = runs
    want = {k: v / (1.0 - B1) for k, v in jax_run[0]["mu"].items()}  # mu_1 = (1 - b1) g
    _close_to_scale(port_run[0]["grads"], want, 1e-5)


def test_adam_moments(runs):
    jax_run, port_run = runs
    _close_to_scale(port_run[0]["mu"], jax_run[0]["mu"], 1e-5)
    _close_to_scale(port_run[0]["nu"], jax_run[0]["nu"], 1e-5)


@pytest.mark.parametrize("step,tol", [(1, 1e-6), (STEPS, 1e-2)])
def test_bn_stats(runs, step, tol):
    jax_run, port_run = runs
    want, got = jax_run[step - 1]["stats"], port_run[step - 1]["stats"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("step", [1, STEPS])
def test_updated_params(runs, step):
    jax_run, port_run = runs
    want, got = jax_run[step - 1]["params"], port_run[step - 1]["params"]
    assert set(got) == set(want)
    diffs = []
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * step, err_msg=k)
        diffs.append(np.abs(got[k] - want[k]).ravel())
    assert np.concatenate(diffs).mean() < 1e-2 * LR
