"""The port's full-resolution train step and eval step held against the JAX
package's, from the same weights and the same batch.

* ``make_train_step(lowres_head=False, augment=False)`` for
  ``composite_mode="sequential"`` at C = 3 (the sequential trainer's step:
  two loss-sums calls, the C = 3 tuple and the C = 1 cross term) and
  ``"none"`` at C = 1 (single-organ training, where the sums take the labels
  in the prediction slot and the gradient flows through the label slot),
  one step each;
* ``make_eval_step`` with and without ``apply_union_reverse``, on a batch
  in which one organ is ignored everywhere.

Both sides run on the CPU at 32 px, batch 2, decoder features 32,
``aspp_dropout=0`` and ``upsample_head=True``, with both models in float64
(the losses stay float32 in both packages, which cast the logits to f32;
tests/test_torch_train_step.py says why f32 models are no usable reference
for gradients at batch 2).  Each JAX step is compiled once, at XLA's CPU
optimization level 1.  The sequential batch's labels carry ``-1`` ignores
and a value 2 that label prep binarizes; the single-organ batch's labels are
clean (with ``-1`` in the prediction slot rows 4 and 5 of the sums are NaN
in both packages: tests/test_torch_loss_sums.py).

Tolerances, with reasons:

* loss and metrics: rtol 1e-5 (f32 sums in another order).  One metric is
  first corrected: under ``jax.jit``, XLA's CPU compiler folds
  ``log(1 - p + eps)`` at p = 1 into ``log(f32(1 + eps) - 1)`` =
  log(1.19e-7) instead of log(1e-7), which eager JAX, the Pallas kernel's
  formula and the port evaluate.  With the labels in the prediction slot
  (single organ) every label-1 pixel takes that term into row 5, so the
  JAX step's ``focal`` (which weighs row 5 by the background weight) is
  off by ``bg * n1 / n * (log(1.19e-7) - log(1e-7))``; the test adds that
  back.  No other metric, nor the loss or its gradient, reads row 5;
* gradients before Adam: atol 1e-5 of each tensor's largest entry;
* parameters after one Adam step: atol 2 * lr (where |g| is as small as the
  loss's rounding, Adam's lr * m / (sqrt(v) + eps) may move an entry by lr
  the other way), and the mean difference below 1e-2 * lr;
* eval: probabilities rtol 1e-6 / atol 1e-7 (an f64 model cast to f32),
  Dice and BCE rtol 1e-5, ``valid`` exactly.
"""

import functools
import inspect

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
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from _torch_parallel_ranks import bound_threads

bound_threads()

FEATURES, IMG, BATCH = 32, 32, 2
LR, B1 = 1e-3, 0.9
GATES = [1.0, 0.5, 0.7]
# mode -> (composite_mode, organs, background weight, -1 ignores in the labels)
MODES = {"sequential": ("sequential", 3, 0.0, True), "single_organ": ("none", 1, 0.3, False)}


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _port_flat(model, values):
    sd = {name: values[name] for name in model.state_dict() if name in values}
    return _flat(to_flax_variables(sd)["params"])


def _batch(rs, organs, ignores):
    # Images of unlike brightness (see tests/test_torch_train_step.py).
    images = (rs.rand(BATCH, IMG, IMG, 3) * 0.5
              + np.linspace(0.0, 0.5, BATCH)[:, None, None, None]).astype(np.float32)
    labels = rs.choice(np.array([0.0, 1.0, 2.0], np.float32), size=(BATCH, IMG, IMG, organs))
    if ignores:
        labels[rs.rand(*labels.shape) < 0.05] = -1.0
    return images, labels


def _models(organs):
    model = DeepLabV3Plus(num_classes=organs, decoder_features=FEATURES, aspp_dropout=0.0,
                          upsample_head=True).to(torch.float64, memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    fmodel = FlaxDeepLab(num_classes=organs, decoder_features=FEATURES, aspp_dropout=0.0,
                         upsample_head=True, dtype=jnp.float64)
    return model, fmodel


_f64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    composite_mode, organs, bg, ignores = MODES[request.param]
    images, labels = _batch(np.random.RandomState(0), organs, ignores)
    model, fmodel = _models(organs)
    variables = to_flax_variables(model.state_dict())

    with jax.enable_x64(True):
        tx = jt.make_optimizer(LR)
        params = _f64(variables["params"])
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=_f64(variables["batch_stats"]),
                              opt_state=jax.jit(tx.init)(params))
        jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
        args = (jnp.float32(bg), jnp.asarray(GATES, jnp.float32), LR,
                jnp.ones((3, 3), jnp.float32))
        jstep = jt.make_train_step(fmodel, tx, composite_mode=composite_mode, augment=False,
                                   lowres_head=False).lower(
            state, jbatch, jax.random.PRNGKey(0), *args,
        ).compile(compiler_options={"xla_backend_optimization_level": 1})
        state, met = jstep(state, jbatch, jax.random.PRNGKey(0), *args)
        adam = state.opt_state.inner_state[0]
        assert isinstance(adam, optax.ScaleByAdamState)
        want = {"metrics": {k: float(v) for k, v in met.items()},
                "params": _flat(state.params), "mu": _flat(adam.mu)}
    if organs == 1:  # XLA's log(1 - p + eps) at p = 1 (module doc)
        n1 = float((labels > 0).mean())
        xla_log = np.log(np.float32(1.0) + np.float32(1e-7) - np.float32(1.0))
        ieee_log = np.log(np.float32(1e-7))
        want["metrics"]["focal"] += bg * n1 * float(xla_log - ieee_log)

    pstate = TrainState(step=0, model=model, optimizer=make_optimizer(LR)(model.parameters()))
    pstep = make_train_step(model, make_optimizer(LR), composite_mode=composite_mode,
                            augment=False, lowres_head=False)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    pstate, met = pstep(pstate, batch, torch.Generator().manual_seed(1), bg, GATES, LR, None)
    named = dict(model.named_parameters())
    got = {"metrics": {k: float(v) for k, v in met.items()},
           "params": _port_flat(model, {n: p.detach() for n, p in named.items()}),
           "grads": _port_flat(model, {n: p.grad for n, p in named.items()})}
    assert pstate.step == 1
    return want, got


def test_loss_and_metrics(runs):
    want, got = runs[0]["metrics"], runs[1]["metrics"]
    assert set(got) == set(want) == set(LOSS_NAMES) | {"loss", "lr"}
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_gradients_before_adam(runs):
    want = {k: v / (1.0 - B1) for k, v in runs[0]["mu"].items()}  # mu_1 = (1 - b1) g
    got = runs[1]["grads"]
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale, err_msg=k)


def test_updated_params(runs):
    want, got = runs[0]["params"], runs[1]["params"]
    assert set(got) == set(want)
    diffs = []
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR, err_msg=k)
        diffs.append(np.abs(got[k] - want[k]).ravel())
    assert np.concatenate(diffs).mean() < 1e-2 * LR


@pytest.fixture(scope="module")
def eval_case():
    organs = 3
    images, labels = _batch(np.random.RandomState(1), organs, ignores=True)
    labels[..., 2] = -1.0  # organ 2 ignored across the whole batch
    model, fmodel = _models(organs)
    variables = to_flax_variables(model.state_dict())
    with jax.enable_x64(True):
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=_f64(variables["params"]),
                              batch_stats=_f64(variables["batch_stats"]), opt_state=None)
        jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
        want = {rev: {k: np.array(v) for k, v in jt.make_eval_step(fmodel, rev)(state, jbatch)
                      .items()}
                for rev in (False, True)}
    return model, images, labels, want


@pytest.mark.parametrize("union_reverse", [False, True])
def test_eval_step(eval_case, union_reverse):
    model, images, labels, want = eval_case
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    got = make_eval_step(model, apply_union_reverse=union_reverse)(None, batch)
    want = want[union_reverse]
    assert set(got) == set(want) == {"probs", "dice", "bce", "valid"}
    assert got["probs"].dtype == torch.float32 and got["dice"].shape == (3,)
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["dice"].numpy(), want["dice"], rtol=1e-5)
    np.testing.assert_allclose(got["bce"].item(), want["bce"], rtol=1e-5)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), [1.0, 1.0, 0.0])


def test_train_step_defaults_are_the_jax_packages():
    want = {k: v.default for k, v in inspect.signature(jt.make_train_step).parameters.items()}
    got = {k: v.default for k, v in inspect.signature(make_train_step).parameters.items()}
    assert got == want
    assert got["augment"] is True and got["lowres_head"] is False
