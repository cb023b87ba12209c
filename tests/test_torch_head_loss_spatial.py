"""The port's per-shard head loss (``fused_head_loss_sums_shard``, one rank's
row block of the ``--spatial_partition`` head loss) held against the JAX
package's per-shard forms: ``_spatial_sums_reference`` (jnp) and
``_make_fused_spatial`` (the Pallas kernels, in interpret mode), with
``mh_local`` the block's rows of the global ``Mh``.

Shapes are tests/test_head_loss_spatial.py's (B 8, h = w = 16, H = W = 64),
at C in {1, 3, 11}, for every row block of n = 2 and n = 4.  On the CPU the
port's wrapper runs its plain versions (the CUDA kernel is held against
them on the card by chip_smoke.py).

Tolerances, with reasons: sums at rtol 2e-5 / atol 2e-4 (the JAX spatial
test's; f32 sums of up to 2.5e4 terms in another order), the count row
exactly; gradients at rtol 1e-4 / atol 1e-5 of the largest |dlogits| (the
JAX spatial test's; transcendentals and two projections in another order).
The blocks' sums and gradients added together equal the unsharded ones at
the same bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.ops.pallas import head_loss as jhl
from ecologysemanticsegmentation_torch.ops import head_loss as thl
from _torch_parallel_ranks import bound_threads

bound_threads()

B, h, w = 8, 16, 16
H = W = 64


@pytest.fixture(scope="module", params=[1, 3, 11])
def case(request):
    c = request.param
    rng = np.random.RandomState(c)
    logits = rng.randn(B, h, w, c).astype(np.float32)  # the JAX spatial test's logits
    labels = (rng.rand(B, H, W, c) > 0.5).astype(np.float32)
    labels[rng.rand(*labels.shape) < 0.05] = -1.0
    cot = rng.randn(8, c).astype(np.float32)
    return logits, labels, cot


def _blocks(labels, n):
    rows = H // n
    return [(k * rows, np.ascontiguousarray(labels[:, k * rows:(k + 1) * rows]))
            for k in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_fn(c, rows, body):
    """The JAX package's per-shard sums of a ``rows``-row block and their
    gradient in the logits for a cotangent, jitted once per shape (the row
    block of ``Mh`` is an argument, as the spatial wrapper passes it)."""
    if body == "reference":
        def sums(x, g, mh_local, mwc):
            return jhl._spatial_sums_reference(x, g, mh_local, mwc)
    else:
        sums = jhl._make_fused_spatial((B, h, w, c), (B, rows, W, c), True)

    def run(x, g, mh_local, mwc, cot):
        out, vjp = jax.vjp(lambda v: sums(v, g, mh_local, mwc), x)
        return out, vjp(cot.at[7].set(0.0))[0]

    return jax.jit(run)


def _jax_block(logits, block, row0, cot, body):
    """JAX's (sums, dlogits) for one row block."""
    c, rows = logits.shape[-1], block.shape[1]
    mh, mwc = jhl._upsample_mats(h, w, H, W, c, True)
    mh_local = jnp.asarray(np.asarray(mh)[row0:row0 + rows])
    out, grad = _jax_fn(c, rows, body)(jnp.asarray(logits), jnp.asarray(block, jnp.bfloat16),
                                      mh_local, jnp.asarray(mwc), jnp.asarray(cot))
    return np.asarray(out), np.asarray(grad)


def _port_block(logits, block, row0):
    x = torch.from_numpy(logits).requires_grad_()
    g = torch.from_numpy(block).to(torch.bfloat16)
    return x, thl.fused_head_loss_sums_shard(x, g, H, row0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("body", ["reference", "pallas_interpret"])
def test_shard_sums_match_jax(case, n, body):
    logits, labels, cot = case
    for row0, block in _blocks(labels, n):
        _, got = _port_block(logits, block, row0)
        want, _ = _jax_block(logits, block, row0, cot, body)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-4,
                                   err_msg=f"block at row {row0}")
        np.testing.assert_array_equal(got[7].detach().numpy(),
                                      (block >= 0).sum(axis=(0, 1, 2)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("body", ["reference", "pallas_interpret"])
def test_shard_gradients_match_jax(case, n, body):
    """autograd of the port's block (its plain analytic backward) against
    the JAX package's per-shard form's VJP (rows 0-6 of the cotangent);
    low-resolution rows that no output row of the block reaches get exactly
    0 in both."""
    logits, labels, cot = case
    for row0, block in _blocks(labels, n):
        x, sums = _port_block(logits, block, row0)
        (sums[:7] * torch.from_numpy(cot[:7])).sum().backward()
        _, want = _jax_block(logits, block, row0, cot, body)
        got = x.grad.numpy()
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"block at row {row0}")
        unreached = np.abs(want).sum(axis=(0, 2, 3)) == 0
        assert unreached.any() and np.all(got[:, unreached] == 0)


@pytest.mark.parametrize("n", [2, 4])
def test_blocks_add_up_to_unsharded(case, n):
    logits, labels, cot = case
    x_full = torch.from_numpy(logits).requires_grad_()
    full = thl.fused_head_loss_sums(x_full, torch.from_numpy(labels).to(torch.bfloat16))
    (full[:7] * torch.from_numpy(cot[:7])).sum().backward()
    total, grad = torch.zeros_like(full), torch.zeros_like(x_full)
    for row0, block in _blocks(labels, n):
        x, sums = _port_block(logits, block, row0)
        (sums[:7] * torch.from_numpy(cot[:7])).sum().backward()
        total += sums.detach()
        grad += x.grad
    np.testing.assert_allclose(total.numpy(), full.detach().numpy(), rtol=2e-5, atol=2e-4)
    np.testing.assert_array_equal(total[7].numpy(), full[7].detach().numpy())
    scale = max(x_full.grad.abs().max().item(), 1.0)
    np.testing.assert_allclose(grad.numpy(), x_full.grad.numpy(), rtol=1e-4, atol=1e-5 * scale)


def test_shard_rejects_a_block_outside_the_image():
    x = torch.zeros(1, 4, 4, 3)
    g = torch.zeros(1, 8, 16, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row block"):
        thl.fused_head_loss_sums_shard(x, g, 16, 12)
