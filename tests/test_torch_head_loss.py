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
from _torch_parallel_ranks import bound_threads

bound_threads()


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
    # the float64 form the card's checks hold the kernel against
    analytic64 = thl.head_sums_bwd_reference(x.double(), g, torch.from_numpy(wts).double(),
                                             align_corners)
    assert analytic64.dtype == torch.float64
    np.testing.assert_allclose(analytic64.numpy(), want, rtol=5e-4, atol=5e-5)

    xr = x.clone().requires_grad_()
    (torch.from_numpy(wts) * thl.head_sums_reference(xr, g, align_corners)).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), want, rtol=5e-4, atol=5e-5)

    # The wrapper's autograd Function routes a CPU tensor to the plain backward.
    xf = x.clone().requires_grad_()
    (torch.from_numpy(wts) * thl.fused_head_loss_sums(xf, g, align_corners)).sum().backward()
    np.testing.assert_array_equal(xf.grad.numpy(), analytic.numpy())


def _banded_projection(du, taps, rng, bands, band, rs, gather):
    """The backward kernel's contraction along one axis, in plain torch:
    for each band of ``band`` source indices, the tiles of ``rs`` output
    indices of its range ``bands[:, k]``.  ``gather`` (the columns): each
    source index of the band sums its run of outputs whose lo tap it is,
    then its run whose hi tap it is (``rng``), tile by tile; else (the
    rows): each output of the tile adds into its lo and hi taps that lie
    in the band, as csrc/head_loss.cu::head_bwd_kernel walks them."""
    lo, hi, w_lo, w_hi = taps
    in_size = rng.shape[1]
    dx = torch.zeros((in_size,) + du.shape[1:], dtype=du.dtype)
    for k in range(bands.shape[1]):
        i0, i1 = k * band, min(in_size, (k + 1) * band)
        ya, yb = int(bands[0, k]), int(bands[1, k])
        for ys in range(ya, yb, rs):
            ye = min(yb, ys + rs)
            if gather:
                for i in range(i0, i1):
                    for y in range(max(int(rng[0, i]), ys), min(int(rng[1, i]), ye)):
                        dx[i] += float(w_lo[y]) * du[y]
                    for y in range(max(int(rng[2, i]), ys), min(int(rng[3, i]), ye)):
                        dx[i] += float(w_hi[y]) * du[y]
                continue
            for y in range(ys, ye):
                if i0 <= lo[y] < i1:
                    dx[lo[y]] += float(w_lo[y]) * du[y]
                if i0 <= hi[y] < i1:
                    dx[hi[y]] += float(w_hi[y]) * du[y]
    return dx


@pytest.mark.parametrize("out_size,in_size,align_corners,n", [
    (256, 64, True, 1), (256, 64, True, 2), (256, 64, True, 4),
    (256, 64, False, 1), (256, 64, False, 2), (256, 64, False, 4),
    (7, 3, False, 1), (1024, 256, True, 1), (1024, 256, True, 2), (1024, 256, True, 4),
])
def test_band_tables_give_the_dense_projection(out_size, in_size, align_corners, n):
    """The backward's band tables (row bands of every band height the plan
    takes, on each row block of an n-way split; a column band is the n = 1
    case on the other axis): every (output index, tap) pair lands in exactly
    one band, and the banded, tiled contraction built from them, as the
    kernel takes it along the rows and along the columns, equals the dense
    ``interp_matrix`` projection to 1e-6."""
    rows = out_size // n
    gen = torch.Generator().manual_seed(out_size + n)
    for k in range(n):
        row0 = k * rows
        taps = thl._block_taps(out_size, in_size, align_corners, row0, rows)
        lo, hi = taps[0], taps[1]
        rng = thl._tables(out_size, in_size, align_corners, torch.device("cpu"), row0, rows)[2]
        du = torch.randn((rows, 3), generator=gen, dtype=torch.float64)
        mh = thl.interp_matrix(out_size, in_size, align_corners, torch.device("cpu"))
        want = mh[row0:row0 + rows].double().T @ du
        for band in thl._BAND_ROWS:
            bands = thl._bands(out_size, in_size, align_corners, band, torch.device("cpu"),
                               row0, rows).numpy()
            i0 = np.arange(bands.shape[1]) * band
            i1 = np.minimum(i0 + band, in_size)
            for tap in (lo, hi):
                hits = ((bands[0][None] <= np.arange(rows)[:, None])
                        & (np.arange(rows)[:, None] < bands[1][None])
                        & (i0[None] <= tap[:, None]) & (tap[:, None] < i1[None]))
                assert np.array_equal(hits.sum(1), np.ones(rows)), (band, row0)
            for rs, gather in ((3, False), (8, False), (8, True)):
                got = _banded_projection(du, taps, rng, bands, band, rs, gather)
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [
    (128, 64, 64, 256, 256, 3, True), (32, 64, 64, 256, 256, 11, True),
    (32, 128, 128, 512, 512, 3, True), (8, 256, 256, 1024, 1024, 3, True),
    (2, 25, 26, 97, 101, 3, False), (1, 4096, 4096, 14000, 14000, 4, True),
    (1, 64, 128, 16, 32, 16, False),
])
def test_kernel_plans_fit_shared_memory(shape):
    """The launch plans fit a block's shared memory, stream labels by bulk
    copy only as one contiguous run of 16-byte rows, and cover the image."""
    B, h, w, H, W, C, ac = shape
    rs, tpb, tw, nj, nl, tma, nblk = thl._fwd_plan(B, h, w, H, H, 0, W, C, ac, 132, True)
    assert thl._smem(C, rs, tw, nj, nl) <= thl._MAX_DYN_SMEM
    assert nblk == B * -(-W // tw) * -(-H // (rs * tpb))
    assert not tma or (tw == W and nj == w and (W * C) % 8 == 0 and (w * C) % 4 == 0)
    rs, tw, nj, nl, nb, jw, tma = thl._bwd_plan(B, h, w, H, H, 0, W, C, ac, 132, True)
    assert thl._smem(C, rs, tw, nj, nl, nb, jw, True) <= thl._MAX_DYN_SMEM
    assert not tma or (jw >= w and (W * C) % 8 == 0 and (w * C) % 4 == 0)
    cols = thl._bands(W, w, ac, jw, torch.device("cpu")).numpy()
    assert (cols[1] - cols[0]).max() == tw and cols[0, 0] == 0 and cols[1, -1] == W
    lo, hi, _, _ = thl._interp_taps(H, h, ac)
    assert all(hi[min(y + rs, H) - 1] - lo[y] < nl for y in range(H))
