"""Shared by the ``test_torch_models_*`` files: weights and JAX trees for
holding the port's models against the JAX package's.

Not a test module (no ``test_`` prefix)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ecologysemanticsegmentation_torch.models import from_flax_variables, to_flax_variables
from ecologysemanticsegmentation_torch.train import init_weights

# Forward parity in float64: the logits, float32 in both packages, round
# alike but for float64 sums taken in another order.
TOL = dict(rtol=1e-6, atol=1e-6)


def perturbed_variables(model: torch.nn.Module, seed: int = 0) -> dict:
    """float64 flax variables of ``model``: its kernels from ``init_weights``
    (flax's own init traces for seconds), then BatchNorm scales, biases and
    statistics and the conv biases moved away from their init, so that a
    wrong leaf mapping shows."""
    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    out = {}
    for col, tree in to_flax_variables(model.state_dict()).items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            if path[-1] == "scale":
                a = 1.0 + 0.1 * rs.randn(*a.shape)
            elif path[-1] in ("bias", "mean"):
                a = 0.1 * rs.randn(*a.shape)
            elif path[-1] == "var":
                a = rs.uniform(0.5, 1.5, a.shape)
            # f32 values: the weight bridge carries float32
            flat[path] = a.astype(np.float32).astype(np.float64)
        out[col] = unflatten_dict(flat)
    return out


def load(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """``model`` in float64 with ``variables`` loaded (every leaf, strictly)."""
    model = model.to(torch.float64, memory_format=torch.channels_last)
    model.load_state_dict(from_flax_variables(variables))
    return model


def jax_apply(flax_model, variables: dict, *inputs: np.ndarray, **kw):
    """The flax module's forward in float64 (eval mode unless ``kw`` says
    otherwise), unjitted (cheaper than a compile at these sizes); numpy out."""
    with jax.enable_x64(True):
        args = [None if x is None else jnp.asarray(x, jnp.float64) for x in inputs]
        out = flax_model.apply(variables, *args, **kw)
        return jax.tree_util.tree_map(np.asarray, out)


def flax_shapes(flax_model, img: int = 32) -> dict:
    """``{"params", "batch_stats"}`` path -> shape of the flax module's
    ``init``, from ``jax.eval_shape`` (nothing is computed)."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    tree = jax.eval_shape(lambda: flax_model.init(rngs, jnp.zeros((1, img, img, 3)),
                                                  train=False))
    return {col: {k: tuple(v.shape) for k, v in flatten_dict(tree[col]).items()}
            for col in ("params", "batch_stats")}


def assert_same_tree(flax_model, model: torch.nn.Module, img: int = 32) -> None:
    """The flax module's tree equals the port's, key for key and shape for
    shape, both ways: the port's ``state_dict`` through
    :func:`to_flax_variables`, and the flax tree (zeros) through
    :func:`from_flax_variables` loaded strictly into the port."""
    want = flax_shapes(flax_model, img)
    got = to_flax_variables(model.state_dict())
    for col in ("params", "batch_stats"):
        shapes = {k: tuple(v.shape) for k, v in flatten_dict(got[col]).items()}
        assert shapes == want[col], (col, sorted(set(shapes) ^ set(want[col]))[:5])
    zeros = {col: unflatten_dict({k: np.zeros(s, np.float32) for k, s in want[col].items()})
             for col in ("params", "batch_stats")}
    model.load_state_dict(from_flax_variables(zeros), strict=True)
