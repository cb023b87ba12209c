"""Gradient accumulation in the port (``make_optimizer(grad_accum=K)``, the
``--grad_accum`` path) held against the JAX package's
``make_optimizer(grad_accum=K)`` (``optax.MultiSteps`` over Adam), and the
three cases of tests/test_grad_accum.py on the port's train step.

* The optimizers alone, on the same parameters and the same sequence of
  gradients: after every call the parameters agree at rtol 1e-6 / atol
  1e-9 (float32 Adam in another order of operations), do not move between
  the K-th calls, and Adam's step count advances only on the K-th call.
* The train step (DeepLabV3+, decoder 16, 32 px, batch 2, float32 on the
  CPU, dropout on): no parameter moves before the K-th micro-step; K
  micro-steps on one batch land exactly where one step without
  accumulation does (the mean of identical gradients is that gradient,
  and the same seed draws the same dropout masks); a 10x learning rate
  moves the parameters 5-20x as far (Adam's first step is about lr in
  size).  BatchNorm statistics update on every micro-step.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.train import trainer as jt
from ecologysemanticsegmentation_torch import make_optimizer, make_train_step
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus
from ecologysemanticsegmentation_torch.train import MultiSteps, TrainState, init_weights
from _torch_parallel_ranks import bound_threads

bound_threads()

LR = 1e-3


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(k):
    rs = np.random.RandomState(k)
    init = [rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in init] for _ in range(3 * k)]
    lrs = [LR] * (2 * k) + [3 * LR] * k  # the step sets the rate on every call

    tx = jt.make_optimizer(LR, grad_accum=k)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = make_optimizer(LR, grad_accum=k)(params)
    assert isinstance(opt, MultiSteps)

    update = jax.jit(tx.update)
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        jstate.inner_opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, jstate = update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        before = [p.detach().clone() for p in params]
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        emitted = (i + 1) % k == 0
        for p, b, want in zip(params, before, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
            assert torch.equal(p.detach(), b) != emitted
        steps = {int(s["step"]) for s in opt.state.values()}
        assert steps == ({(i + 1) // k} if i + 1 >= k else set())
        assert int(jstate.gradient_step) == (i + 1) // k


@functools.lru_cache(maxsize=None)
def _initial_model() -> DeepLabV3Plus:
    model = DeepLabV3Plus(num_classes=3, decoder_features=16, upsample_head=False)
    model = model.to(memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _setup(grad_accum: int):
    # A copy of one initialization from seed 0 (drawing 21 M weights takes
    # seconds; every test starts from the same ones).
    model = copy.deepcopy(_initial_model())
    tx = make_optimizer(LR, grad_accum=grad_accum)
    state = TrainState(step=0, model=model, optimizer=tx(model.parameters()))
    step = make_train_step(model, tx, augment=False, lowres_head=True)
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.rand(2, 32, 32, 3).astype(np.float32)),
             "label": torch.from_numpy((rs.rand(2, 32, 32, 3) > 0.5).astype(np.float32))}
    return state, step, batch


def _run(step, state, batch, lr=LR):
    # a generator seeded the same on every call draws the same dropout masks
    return step(state, batch, torch.Generator().manual_seed(1), 0.3, [1.0, 1.0, 1.0], lr, None)


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _max_delta(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in a)


def test_no_update_mid_accumulation():
    state, step, batch = _setup(grad_accum=2)
    init = _params(state)
    stats = state.model.aspp.project.bn.running_mean.clone()
    state, metrics = _run(step, state, batch)
    assert _max_delta(_params(state), init) == 0.0  # zero update emitted
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.model.aspp.project.bn.running_mean, stats)  # BN stats move
    state, _ = _run(step, state, batch)
    assert _max_delta(_params(state), init) > 0.0  # the K-th step applies


def test_identical_microbatches_equal_single_step():
    state1, step1, batch = _setup(grad_accum=1)
    state_k, step_k, _ = _setup(grad_accum=2)
    state1, m1 = _run(step1, state1, batch)
    state_k, _ = _run(step_k, state_k, batch)
    state_k, m_k = _run(step_k, state_k, batch)
    assert _max_delta(_params(state1), _params(state_k)) < 1e-6
    assert abs(float(m1["loss"]) - float(m_k["loss"])) < 1e-6
    assert float(m_k["lr"]) == float(np.float32(LR))


def test_lr_injection_reaches_inner_optimizer():
    def run(lr):
        state, step, batch = _setup(grad_accum=2)
        init = _params(state)
        state, _ = _run(step, state, batch, lr)
        state, _ = _run(step, state, batch, lr)
        return _max_delta(_params(state), init)

    d_small, d_big = run(1e-4), run(1e-3)
    assert 5.0 < d_big / d_small < 20.0
