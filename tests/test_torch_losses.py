"""The port's loss subset (ecologysemanticsegmentation_torch/losses.py) and
label prep held against the JAX package's, on the same numpy inputs.

The formulas are the same elementwise float32 algebra in both packages, so
the tolerance is rtol 1e-5 / atol 1e-6 (reductions in another order); label
transforms take values in {-1, 0, 1, 2} and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu import losses as jl
from ecologysemanticsegmentation_tpu.train.trainer import _prepare_labels as jax_prepare_labels
from ecologysemanticsegmentation_torch import losses as tl
from ecologysemanticsegmentation_torch.train.trainer import _prepare_labels

TOL = dict(rtol=1e-5, atol=1e-6)


def _labels(rng, shape, ignore=0.1):
    g = (rng.rand(*shape) > 0.5).astype(np.float32)
    g[rng.rand(*shape) < ignore] = -1.0
    return g


def _sums(rng, c):
    """(8, C) sums of random probabilities against random labels; the last
    channel is ignored everywhere (every row 0, count n = 0)."""
    from ecologysemanticsegmentation_tpu.ops.pallas.loss_sums import _sums_reference

    p = rng.rand(c, 4096).astype(np.float32)
    g = _labels(rng, (c, 4096))
    g[-1] = -1.0
    return np.array(_sums_reference(jnp.asarray(p), jnp.asarray(g)))


@pytest.mark.parametrize("bg", [0.0, 0.3])
def test_seven_from_sums(rng, bg):
    sums = _sums(rng, 4)
    got = tl.seven_from_sums(torch.from_numpy(sums), bg).numpy()
    want = np.asarray(jl.seven_from_sums(jnp.asarray(sums), bg))
    assert np.all(np.isfinite(got))  # the max(n, 1) guard on the ignored channel
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclude", [(0,), ()])
def test_union_sets(rng, reverse, exclude):
    ann = _labels(rng, (2, 8, 8, 4), ignore=0.2)
    # the documented corner cases: an ignored subset under an annotated
    # superset, and an ignored channel of its own
    ann[0, 0, 0] = [1, -1, 0, 1]
    ann[0, 0, 1] = [-1, -1, 1, 0]
    ann[0, 0, 2] = [0, 1, -1, -1]
    if reverse:
        ann = np.clip(ann, 0, None)  # reverse runs on probabilities / unions
        ann[1] = rng.rand(8, 8, 4).astype(np.float32)
    got = tl.return_union_sets_descending_order(torch.from_numpy(ann), exclude, reverse)
    want = jl.return_union_sets_descending_order(jnp.asarray(ann), exclude, reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepare_labels(rng):
    raw = rng.choice(np.array([-1.0, 0.0, 0.4, 1.0, 2.0], np.float32), size=(2, 8, 8, 3))
    got = _prepare_labels(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_prepare_labels(jnp.asarray(raw))))


def test_binary_cross_entropy(rng):
    x = (rng.randn(2, 8, 8, 3) * 3).astype(np.float32)
    y = _labels(rng, x.shape)
    got = tl.binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(y)).item()
    want = float(jl.binary_cross_entropy(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, **TOL)


def test_dice_score(rng):
    p = rng.rand(2, 8, 8, 3).astype(np.float32)
    g = _labels(rng, p.shape)
    got = tl.dice_score(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    want = np.asarray(jl.dice_score(jnp.asarray(p), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("c", [3, 11])
def test_seven_losses_lowres(rng, c):
    x = (rng.randn(2, 8, 8, c) * 3).astype(np.float32)
    g = _labels(rng, (2, 32, 32, c), ignore=0.05)
    got = tl.seven_losses_lowres(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want = np.asarray(jl.seven_losses_lowres(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_seven_losses_lowres_rejects_single_organ(rng):
    x = torch.zeros(1, 4, 4, 1)
    g = torch.zeros(1, 16, 16, 1)
    with pytest.raises(ValueError, match="multi-organ"):
        tl.seven_losses_lowres(x, g)
