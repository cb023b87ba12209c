"""The port's parallel layer on a gloo CPU group of 4 processes
(``tests/_torch_parallel_ranks.py``), on the (data, model) grids 2 x 2,
4 x 1 (data parallel) and 1 x 4:

* the collectives with gradients (sum all-reduce with both backward rules,
  row all-gather, halo exchange with halos longer than a block, gradient
  all-reduce), forward and backward, against the whole tensors;
* the row-partitioned DeepLabV3+ in train mode: each rank's output is its
  block of the one-rank output, the gradients of a fixed functional of the
  output (summed over ranks) are the one-rank gradients, and the BN running
  statistics are equal on every rank and to one rank's;
* the spatial flagship step (low-resolution head loss) and the spatial
  sequential step (full resolution) on 2 x 2, and the data-parallel
  flagship step on 4 x 1, against the one-rank step from the same weights
  and batch (the counterparts of tests/test_head_loss_spatial.py:69, :179);
* ``loss_sums_nhwc_spatial`` against the JAX package's on its virtual
  2 x 2 mesh (:123), and ``spatial_mesh_context``'s rerouting (:157).

Tolerances, with reasons (float64 models; the head loss and loss sums stay
float32, as in the JAX package):

* collectives: 1e-14 (sums of four float64 terms in another order; the
  gathers and halos are exact, the bf16 halo bitwise);
* model output: 1e-6 absolute (float32 logits of float64 activations
  reduced in another order: halo'd convolutions, fast-variance BatchNorm);
  gradients 1e-6 of each tensor's scale; BN statistics 1e-12;
* steps: loss within 1e-5 relative (the JAX test's bound), metrics at rtol
  1e-5; the gradients Adam receives within 1e-5 of each tensor's scale
  (a factor of the world size in them would show here, not in the loss);
  parameters within the Adam step-1 bound 2 lr (the JAX test's 2e-3) with a
  mean error below 1e-2 lr; BN statistics 1e-12; parameters and buffers
  bitwise equal on every rank;
* loss sums: the JAX spatial test's rtol 2e-5 / atol 2e-4, gradients rtol
  1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_ranks as R
from ecologysemanticsegmentation_tpu.ops.pallas import loss_sums as jls
from ecologysemanticsegmentation_tpu.parallel import create_mesh

GRIDS = [(2, 2), (4, 1), (1, 4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("parallel", tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("grid", GRIDS)
def test_collectives_forward_and_backward(ranks, grid):
    for rank, res in enumerate(ranks):
        errs = res[grid]["collectives"]
        assert len(errs) == 2 + 2 + 4 * 2 * 2 + 1
        bad = {k: v for k, v in errs.items() if not v <= 1e-14}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("grid", GRIDS)
def test_row_partitioned_model_matches_one_rank(ranks, grid):
    for rank, res in enumerate(ranks):
        m = res[grid]["model"]
        assert m["out"] <= 1e-6 and m["out_scale"] > 0.1, (rank, m)
        assert m["grads"] <= 1e-6, (rank, m)
        assert m["buffers"] <= 1e-12, (rank, m)
    assert len({res[grid]["model"]["buffers_digest"] for res in ranks}) == 1


def _check_step(ranks, grid, kind):
    for rank, res in enumerate(ranks):
        r = res[grid][kind]
        got, want = r["metrics"], r["want_metrics"]
        assert np.isfinite(want["loss"])
        assert abs(got["loss"] - want["loss"]) < 1e-5 * max(abs(want["loss"]), 1.0), (rank, r)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert r["grads"] <= 1e-5, (rank, r["grads"])
        assert r["params"] <= 2 * R.LR + 1e-6 and r["params_mean"] < 1e-2 * R.LR, (rank, r)
        assert r["buffers"] <= 1e-12, (rank, r["buffers"])
    for key in ("params_digest", "buffers_digest"):
        assert len({res[grid][kind][key] for res in ranks}) == 1, key
    assert len({res[grid][kind]["metrics"]["loss"] for res in ranks}) == 1


@pytest.mark.parametrize("kind", ["flagship", "sequential"])
def test_spatial_step_matches_one_rank(ranks, kind):
    _check_step(ranks, (2, 2), kind)


def test_data_parallel_step_matches_one_rank(ranks):
    _check_step(ranks, (4, 1), "flagship")


@pytest.fixture(scope="module")
def jax_loss_sums():
    """The JAX package's loss_sums_nhwc_spatial on a (2, 2) mesh of its
    virtual devices (jnp shard body), its gradient in the probabilities,
    and the unpartitioned sums."""
    probs, labels, cot = R.loss_sums_inputs()
    mesh = create_mesh(4, model_parallel=2)
    p, g = jnp.asarray(probs), jnp.asarray(labels)
    sums = jls.loss_sums_nhwc_spatial(p, g, mesh, use_pallas=False)
    grad = jax.grad(lambda v: jnp.sum(
        jls.loss_sums_nhwc_spatial(v, g, mesh, use_pallas=False)[:7] * cot[:7]))(p)
    plain = jls.loss_sums_nhwc(p, g, use_pallas=False)
    return np.asarray(sums), np.asarray(grad), np.asarray(plain)


def test_loss_sums_spatial_matches_jax(ranks, jax_loss_sums):
    sums, grad, _ = jax_loss_sums
    for res in ranks:
        np.testing.assert_allclose(res[(2, 2)]["loss_sums"]["sums"], sums, rtol=2e-5, atol=2e-4)
    # the ranks' blocks of dp, reassembled in (data, model) order
    dp = np.concatenate([np.concatenate([ranks[2 * d + m][(2, 2)]["loss_sums"]["dp"]
                                         for m in range(2)], axis=1) for d in range(2)])
    np.testing.assert_allclose(dp, grad, rtol=1e-4, atol=1e-5)


def test_spatial_context_reroutes_and_restores(ranks, jax_loss_sums):
    """Inside spatial_mesh_context loss_sums_nhwc gives the global sums;
    after it, this rank's own, and the context stack is empty again."""
    sums, _, _ = jax_loss_sums
    local_total = np.zeros_like(sums)
    for res in ranks:
        ls = res[(2, 2)]["loss_sums"]
        np.testing.assert_allclose(ls["inside"], sums, rtol=2e-5, atol=2e-4)
        assert ls["stack_after"] == []
        local_total += ls["outside"]
    np.testing.assert_allclose(local_total, sums, rtol=2e-5, atol=2e-4)
    assert not np.allclose(ranks[0][(2, 2)]["loss_sums"]["outside"], sums)
