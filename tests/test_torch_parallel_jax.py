"""One spatially partitioned flagship step of the port, on a gloo CPU group
of 4 processes (a 2 x 2 (data, model) grid, ``tests/_torch_parallel_ranks.py``),
held against the JAX package's ``make_train_step(spatial_mesh=create_mesh(4,
model_parallel=2))`` on its virtual devices, from the same weights and batch.

Both sides run float64 models (the head loss stays float32 in both) at
64 px, batch 4, C = 3, decoder 32, ASPP dropout 0, ``augment=False``.  At
32 px the JAX package's partitioned step gives encoder gradients up to ~120x
off its own one-device step (its 1/16 map then has one row per block, less
than the dilation-2 convolutions' halo; ROADMAP section 3); at 64 px the two
agree to 6e-7.  The JAX step is compiled once at XLA's CPU optimization
level 1 (level 0 compiles faster but runs the partitioned step several
times slower; the float64 results do not depend on the level).

Bounds: the loss within 1e-5 relative and every parameter within the Adam
step-1 bound of 2 lr (2e-3), tests/test_head_loss_spatial.py's (:69).  That
parameter bound passes any gradient (Adam's first step moves by about
lr * sign(g)), so the gradients are held directly: Adam's first moment
(``mu_1 = (1 - b1) g``, the world's gradient on every rank of the port)
within 1e-5 of each tensor's largest entry, tests/test_torch_train_step.py's
bound for the one-rank step (the f32 head loss summed in another order;
a wrong sign or a factor of the world size shows here).  The BN running
statistics, float64 on both sides, within 1e-12, but for the decoder's
fuse BatchNorm, which sees the JAX package's float32-rounded resize: there
rtol / atol 1e-6, tests/test_torch_train_step.py's bound.  The port's
parameters and BN buffers are bitwise equal on every rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import _torch_parallel_ranks as R
from ecologysemanticsegmentation_tpu.models.deeplabv3plus import DeepLabV3Plus as FlaxDeepLab
from ecologysemanticsegmentation_tpu.parallel import (
    batch_sharding,
    create_mesh,
    replicated_sharding,
)
from ecologysemanticsegmentation_tpu.train import trainer as jt
from ecologysemanticsegmentation_torch.models import to_flax_variables

R.bound_threads()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("flagship_2x2", tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's spatial flagship step: loss, and the parameters,
    Adam's first moment and the BN statistics after it (flat, flax paths)."""
    model = R.build_model(upsample_head=False)
    variables = to_flax_variables(model.state_dict())
    batch = R.batch()
    with jax.enable_x64(True):
        fmodel = FlaxDeepLab(num_classes=R.ORGANS, decoder_features=R.FEATURES,
                             aspp_dropout=0.0, upsample_head=False, dtype=jnp.float64)
        tx = jt.make_optimizer(R.LR)
        f64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        params = f64(variables["params"])
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=f64(variables["batch_stats"]),
                              opt_state=jax.jit(tx.init)(params))
        mesh = create_mesh(4, model_parallel=2)
        state = jax.device_put(state, replicated_sharding(mesh))
        bsh = batch_sharding(mesh, spatial=True)
        jbatch = {k: jax.device_put(jnp.asarray(v.numpy()), bsh) for k, v in batch.items()}
        args = (jax.random.PRNGKey(0), 0.0, jnp.asarray(R.GATES, jnp.float32), R.LR,
                jnp.ones((2,), jnp.float32))
        step = jt.make_train_step(fmodel, tx, augment=False, lowres_head=True, spatial_mesh=mesh)
        with mesh:
            compiled = step.lower(state, jbatch, *args).compile(
                compiler_options={"xla_backend_optimization_level": 1})
            state, metrics = compiled(state, jbatch, *args)
        adam = state.opt_state.inner_state[0]
        assert isinstance(adam, optax.ScaleByAdamState)
        loss = float(metrics["loss"])
        flat = {name: _flat(tree) for name, tree in (
            ("params", state.params), ("mu", adam.mu), ("stats", state.batch_stats))}
    return loss, flat


# The decoder's fuse BatchNorm normalizes the x4 resize of the ASPP output,
# which the JAX package accumulates in float32 even for a float64 model
# (ops/resize.py: preferred_element_type=float32); the port's resize keeps
# float64.  Its statistics agree to float32 rounding (~2e-7 relative).
F32_RESIZED_BN = "fuse/bn/"


def _flat(tree) -> dict:
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _port_params(values: dict) -> dict:
    """Port parameter-shaped arrays (name -> array) at their flax paths."""
    return _flat(to_flax_variables({n: torch.from_numpy(a) for n, a in values.items()})
                 ["params"])


def _port_stats(buffers: dict) -> dict:
    """Port BN buffers at their flax paths, keeping float64."""
    return {name.replace(".running_", ".").replace(".", "/"): a for name, a in buffers.items()}


def test_spatial_step_matches_jax_spatial_step(ranks, jax_step):
    loss, want = jax_step
    assert np.isfinite(loss)
    for res in ranks:
        assert abs(res["metrics"]["loss"] - loss) < 1e-5 * max(abs(loss), 1.0)
    got = _port_params(ranks[0]["params"])
    assert set(got) == set(want["params"])
    deltas = [float(np.max(np.abs(got[k] - want["params"][k]))) for k in want["params"]]
    assert max(deltas) <= 2 * R.LR + 1e-6
    for key in ("params_digest", "buffers_digest"):
        assert len({res[key] for res in ranks}) == 1, key


def test_spatial_gradients_match_jax_spatial_step(ranks, jax_step):
    """Adam's first moment after step 1 is (1 - b1) times the gradient."""
    _, want = jax_step
    got = _port_params(ranks[0]["mu"])
    assert set(got) == set(want["mu"])
    for k, w in want["mu"].items():
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * scale, err_msg=k)


def test_spatial_bn_stats_match_jax_spatial_step(ranks, jax_step):
    _, want = jax_step
    got = _port_stats(ranks[0]["buffers"])
    assert set(got) == set(want["stats"])
    for k, w in want["stats"].items():
        if k.startswith(F32_RESIZED_BN):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-12, err_msg=k)
