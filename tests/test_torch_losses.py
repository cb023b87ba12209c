"""The port's loss subset (ecologysemanticsegmentation_torch/losses.py) and
label prep held against the JAX package's, on the same numpy inputs.

The formulas are the same elementwise float32 algebra in both packages, so
the tolerance is rtol 1e-5 / atol 1e-6 (reductions in another order); label
transforms take values in {-1, 0, 1, 2} and must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu import losses as jl
from ecologysemanticsegmentation_tpu.train.trainer import _prepare_labels as jax_prepare_labels
from ecologysemanticsegmentation_torch import losses as tl
from ecologysemanticsegmentation_torch.train.trainer import _prepare_labels
from _torch_parallel_ranks import bound_threads

bound_threads()

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


# ------------------------------------------------- full-resolution losses
#
# The port's full-resolution losses reduce through ops/loss_sums.py (its
# plain version on the CPU); the JAX package's, on the CPU, through the jnp
# reference of the same sums.  Tolerance FULL_TOL: rtol 2e-5 / atol 2e-5,
# f32 sums of 2*16*16 = 512 terms per channel in another order, fed through
# seven_from_sums' ratios.  Gradients with respect to the probabilities
# against jax.grad at GRAD_TOL, rtol 1e-4 / atol 1e-6 of the largest entry
# (the same f32 formulas, but the analytic backward against autodiff of the
# jnp reference, and ratios of sums amplify the sums' rounding).

FULL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _probs(rng, shape):
    return rng.rand(*shape).astype(np.float32)


def _nested(rng, shape, ignore=0.1):
    """Union-transformed labels (the trainers' input class) with ignores."""
    raw = _labels(rng, shape, ignore=ignore)
    return np.array(jl.return_union_sets_descending_order(jnp.asarray(raw)))


@pytest.mark.parametrize("c,bg,ignore", [(1, 0.0, 0.0), (1, 0.5, 0.0), (3, 0.0, 0.1),
                                         (3, 0.5, 0.1)])
def test_seven_losses(rng, c, bg, ignore):
    """C = 1 keeps the gt/pred swap and uses bg; C = 3 drops bg.  C = 1 runs
    on clean labels (test_torch_loss_sums.py shows what -1 labels give)."""
    x = _probs(rng, (2, 16, 16, c))
    g = _labels(rng, x.shape, ignore=ignore)
    got = tl.seven_losses(torch.from_numpy(x), torch.from_numpy(g), bg).numpy()
    want = np.asarray(jl.seven_losses(jnp.asarray(x), jnp.asarray(g), bg))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **FULL_TOL)
    if c > 1:  # multi-organ drops the background weight
        np.testing.assert_array_equal(
            got, tl.seven_losses(torch.from_numpy(x), torch.from_numpy(g), 0.0).numpy())


def test_prob_cross_entropy(rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    t = _probs(rng, x.shape)
    got = tl.prob_cross_entropy(torch.from_numpy(x), torch.from_numpy(t)).item()
    want = float(jl.prob_cross_entropy(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, **TOL)
    assert tl.prob_cross_entropy(torch.from_numpy(x[..., :1]),
                                 torch.from_numpy(t[..., :1])).item() == 0.0


def test_sequential_cross_organ_losses(rng):
    """Nested labels with ignores: g1 - g2 takes -2, -1 (masked) and 2
    (counted with g = 2) as well as 0 and 1."""
    x = _probs(rng, (2, 16, 16, 3))
    g = _nested(rng, x.shape, ignore=0.15)
    diff = g[..., 1] - g[..., 2]
    assert {-2.0, -1.0, 0.0, 1.0, 2.0} <= set(np.unique(diff))
    got = tl.sequential_cross_organ_losses(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want = np.asarray(jl.sequential_cross_organ_losses(jnp.asarray(x), jnp.asarray(g)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **FULL_TOL)
    with pytest.raises(ValueError, match="3 organs"):
        tl.sequential_cross_organ_losses(torch.from_numpy(x[..., :2]),
                                         torch.from_numpy(g[..., :2]))


@pytest.mark.parametrize("c,jitter", [(3, False), (3, True), (4, True)])
def test_composite_general(rng, c, jitter):
    x = _probs(rng, (2, 16, 16, c))
    g = _nested(rng, x.shape, ignore=0.0)
    pairs = c * (c - 1) // 2
    jit = (jl.composite_jitters(np.random.RandomState(3), pairs, True) if jitter else None)
    got = tl.seven_losses_composite_general(
        torch.from_numpy(x), torch.from_numpy(g), 0.3,
        relative_set_ratios=(1.0, 0.43197708, 0.22319692, 0.1)[:c],
        early_stop_weights=jit).numpy()
    want = np.asarray(jl.seven_losses_composite_general(
        jnp.asarray(x), jnp.asarray(g), 0.3,
        relative_set_ratios=(1.0, 0.43197708, 0.22319692, 0.1)[:c], early_stop_weights=jit))
    np.testing.assert_allclose(got, want, **FULL_TOL)


def test_composite_jitters():
    for stopped in (False, True):
        got = tl.composite_jitters(np.random.RandomState(5), 3, stopped)
        want = jl.composite_jitters(np.random.RandomState(5), 3, stopped)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jitter", [False, True])
def test_sequential_deadbranch(rng, jitter):
    x = _probs(rng, (2, 16, 16, 3))
    g = _nested(rng, x.shape, ignore=0.0)
    jit = np.array([0.7, 0.4]) if jitter else None
    got = tl.sequential_densenet_composite(torch.from_numpy(x), torch.from_numpy(g), 0.2,
                                           early_stop_jitters=jit).numpy()
    want = np.asarray(jl.sequential_densenet_composite_deadbranch(
        jnp.asarray(x), jnp.asarray(g), 0.2, early_stop_jitters=jit))
    np.testing.assert_allclose(got, want, **FULL_TOL)
    assert tl.sequential_densenet_composite is tl.sequential_densenet_composite_deadbranch


@pytest.mark.parametrize("fn", ["intersection_loss", "union_loss"])
def test_intersection_and_union(rng, fn):
    a, b = _probs(rng, (2, 16, 16, 1)), _probs(rng, (2, 16, 16, 1))
    g = _labels(rng, a.shape, ignore=0.0)
    got = getattr(tl, fn)(*map(torch.from_numpy, (a, b, g))).numpy()
    want = np.asarray(getattr(jl, fn)(*map(jnp.asarray, (a, b, g))))
    np.testing.assert_allclose(got, want, **FULL_TOL)


def _pyramid(rng):
    gts = [_labels(rng, (2, s, s, 1), ignore=0.0) for s in (16, 8, 4)]
    preds = [_probs(rng, y.shape) for y in gts]
    return gts, preds


@pytest.mark.parametrize("fn", ["binary_cross_entropy_list", "cross_entropy_list",
                                "focal_list", "classification_dice_list"])
def test_list_variants(rng, fn):
    gts, preds = _pyramid(rng)
    got = getattr(tl, fn)([torch.from_numpy(y) for y in gts],
                          [torch.from_numpy(p) for p in preds]).numpy()
    want = np.asarray(getattr(jl, fn)([jnp.asarray(y) for y in gts],
                                      [jnp.asarray(p) for p in preds]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FULL_TOL)


def test_bce_list_rejects_more_than_six_levels():
    ys = [torch.zeros(1, 2, 2, 1)] * 7
    with pytest.raises(ValueError, match="6 levels"):
        tl.binary_cross_entropy_list(ys, ys)


def test_relative_ratios(rng):
    seg = (rng.rand(2, 8, 8, 3) > np.array([0.2, 0.5, 0.8])).astype(np.float32)
    got = tl.relative_ratios(torch.from_numpy(seg), 3).numpy()
    want = np.asarray(jl.relative_ratios(jnp.asarray(seg), num_classes=3))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() == 1.0


def _grad_pair(port_fn, jax_fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    port_fn(xt, torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_fn(a, jnp.asarray(g))))(jnp.asarray(x))
    return xt.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["single_organ_swap", "multi_organ", "sequential",
                                  "general", "deadbranch"])
def test_gradient_in_probabilities(rng, case):
    """The gradient of the summed 7-tuple in the probabilities, against
    jax.grad.  The single-organ swap and the composites reach the
    probabilities through the label slot of the sums (dg)."""
    c = 1 if case == "single_organ_swap" else 3
    x = np.clip(_probs(rng, (2, 16, 16, c)), 0.02, 0.98)
    ignore = 0.1 if case in ("multi_organ", "sequential") else 0.0
    g = _nested(rng, x.shape, ignore=ignore)
    fns = {
        "single_organ_swap": (tl.seven_losses, jl.seven_losses),
        "multi_organ": (tl.seven_losses, jl.seven_losses),
        "sequential": (tl.sequential_cross_organ_losses, jl.sequential_cross_organ_losses),
        "general": (tl.seven_losses_composite_general, jl.seven_losses_composite_general),
        "deadbranch": (tl.sequential_densenet_composite_deadbranch,
                       jl.sequential_densenet_composite_deadbranch),
    }
    got, want = _grad_pair(*fns[case], x, g)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["atol"] * np.abs(want).max())
