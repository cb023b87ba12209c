"""The port's fused head loss (ecologysemanticsegmentation_torch/ops/head_loss.py)
held against the JAX package's (ops/pallas/head_loss.py).

On the CPU the port's wrapper runs its plain versions, so these tests reach
the formulas the CUDA kernels implement: the forward against the Pallas
kernel in interpret mode and against the jnp reference, the plain analytic
backward and autograd of the plain forward against ``jax.grad``.  The
kernels themselves are held against the plain versions on the card
(tests/test_torch_package.py, ``-m gpu``, and chip_smoke.py).

Tolerances are those of tests/test_head_loss.py: sums at rtol 2e-5 /
atol 1e-4 (f32 sums of up to ~10^5 terms in another order), gradients at
rtol 5e-4 / atol 5e-5 (transcendentals and two projections in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.ops.pallas import head_loss as jhl
from ecologysemanticsegmentation_tpu.ops.resize import _interp_matrix as jax_interp_matrix
from ecologysemanticsegmentation_torch.ops import head_loss as thl
from ecologysemanticsegmentation_torch.ops.resize import _interp_matrix, _interp_taps


def _case(rng, b, h, w, c, scale=4):
    logits = (rng.randn(b, h, w, c) * 3.0).astype(np.float32)
    labels = (rng.rand(b, h * scale, w * scale, c) > 0.5).astype(np.float32)
    labels[rng.rand(*labels.shape) < 0.05] = -1.0  # the pipeline's ignore value
    return logits, labels


def _port_inputs(logits, labels):
    return torch.from_numpy(logits), torch.from_numpy(labels).to(torch.bfloat16)


@pytest.mark.parametrize("out_size,in_size,align_corners", [
    (256, 64, True), (256, 64, False), (64, 16, True), (7, 3, False),
    (16, 16, True), (5, 9, False), (5, 9, True),
])
def test_interp_tables_match_jax_bitwise(out_size, in_size, align_corners):
    want = jax_interp_matrix(out_size, in_size, align_corners)
    got = _interp_matrix(out_size, in_size, align_corners)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    lo, hi, w_lo, w_hi = _interp_taps(out_size, in_size, align_corners)
    rows = np.arange(out_size)
    dense = np.zeros_like(want)
    np.add.at(dense, (rows, lo), w_lo)
    np.add.at(dense, (rows, hi), w_hi)
    assert np.array_equal(dense, want)
    two = lo != hi
    assert np.array_equal(want[rows[two], lo[two]], w_lo[two])
    assert np.array_equal(want[rows[two], hi[two]], w_hi[two])
    assert np.all(w_hi[~two] == 0)  # a clamped border tap carries all the weight on lo
    assert np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)  # runs are contiguous


@pytest.mark.parametrize("b,c,align_corners", [
    (1, 1, True), (3, 3, True), (1, 11, False), (3, 3, False),
])
def test_forward_matches_pallas_interpret(rng, b, c, align_corners):
    logits, labels = _case(rng, b, 16, 16, c)
    got = thl.fused_head_loss_sums(*_port_inputs(logits, labels), align_corners).numpy()
    kernel = jhl.fused_head_loss_sums(jnp.asarray(logits), jnp.asarray(labels, jnp.bfloat16),
                                      align_corners, use_pallas=True, interpret=True)
    ref = jhl.head_sums_reference(jnp.asarray(logits), jnp.asarray(labels), align_corners)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=1e-4)
    # -1 pixels leave the count row: it counts exactly the non-ignored labels
    np.testing.assert_array_equal(got[7], (labels >= 0).sum(axis=(0, 1, 2)))


def test_forward_large_image_matches_reference(rng):
    """128 -> 512 px: the size at which the JAX package switches to its
    row-blocked kernel; the port's one kernel (and its plain version) covers
    it.  atol 1e-3 as in tests/test_head_loss.py for 10^6-term sums."""
    logits, labels = _case(rng, 1, 128, 128, 3)
    got = thl.fused_head_loss_sums(*_port_inputs(logits, labels)).numpy()
    want = jhl.head_sums_reference(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("b,c,align_corners", [(2, 3, True), (1, 1, True), (1, 11, False)])
def test_backward_matches_jax_grad(rng, b, c, align_corners):
    logits, labels = _case(rng, b, 8, 8, c)
    wts = rng.randn(8, c).astype(np.float32)  # every backward term weighted

    def scal(lg):
        return jnp.sum(jnp.asarray(wts) * jhl.head_sums_reference(lg, jnp.asarray(labels),
                                                                  align_corners))

    want = np.asarray(jax.grad(scal)(jnp.asarray(logits)))
    x, g = _port_inputs(logits, labels)
    analytic = thl.head_sums_bwd_reference(x, g, torch.from_numpy(wts), align_corners)
    np.testing.assert_allclose(analytic.numpy(), want, rtol=5e-4, atol=5e-5)

    xr = x.clone().requires_grad_()
    (torch.from_numpy(wts) * thl.head_sums_reference(xr, g, align_corners)).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), want, rtol=5e-4, atol=5e-5)

    # The wrapper's autograd Function routes a CPU tensor to the plain backward.
    xf = x.clone().requires_grad_()
    (torch.from_numpy(wts) * thl.fused_head_loss_sums(xf, g, align_corners)).sum().backward()
    np.testing.assert_array_equal(xf.grad.numpy(), analytic.numpy())
