"""The port's tiled-CLAHE apply (``ecologysemanticsegmentation_torch/ops/clahe_tiled.py``)
held against the JAX package's (``ops/pallas/clahe_tiled.py``).

On the CPU the port's wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and against the JAX package's jnp reference
at rtol 1e-5 (f32 sums of at most K + 2 terms in another order), at K = 32
and K = 64 on a square and a non-square size.  ``tile_weights`` must agree
bitwise.  The card's test of the CUDA kernel against the plain version is
in ``test_torch_package.py``, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.ops.pallas import clahe_tiled as jc
from ecologysemanticsegmentation_torch.ops import clahe_tiled as pc

RTOL = 1e-5


def _inputs(b, h, w, bins, tiles=8, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    luma = np.clip((yy / h * 0.6 + xx / w * 0.3)[None] + rs.rand(b, h, w) * 0.25, 0.0, 1.0)
    hist = rs.rand(b, tiles, tiles, bins) + 0.1
    cdf = np.cumsum(hist, axis=-1)
    cdf /= cdf[..., -1:]
    deltas = np.diff(cdf, axis=-1, prepend=np.zeros((b, tiles, tiles, 1)))
    return luma.astype(np.float32), deltas.astype(np.float32)


@pytest.mark.parametrize("n,tiles", [(64, 8), (48, 8), (80, 8), (32, 4), (256, 8), (17, 3)])
def test_tile_weights_bitwise(n, tiles):
    want = jc.tile_weights(n, tiles)
    got = pc.tile_weights(n, tiles)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bins", [32, 64])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_plain_matches_pallas_interpret_and_reference(bins, h, w):
    luma, deltas = _inputs(2, h, w, bins)
    got = pc.tiled_clahe_new_luma(torch.from_numpy(luma), torch.from_numpy(deltas), 8)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, h, w)
    kern = np.asarray(jc.tiled_clahe_new_luma(jnp.asarray(luma), jnp.asarray(deltas), 8,
                                              interpret=True))
    ref = np.asarray(jc.tiled_clahe_new_luma(jnp.asarray(luma), jnp.asarray(deltas), 8,
                                             use_pallas=False))
    np.testing.assert_allclose(got.numpy(), kern, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n,tiles", [(256, 8), (48, 8), (80, 8), (32, 4), (512, 8), (17, 3)])
def test_two_tap_table_is_tile_weights(n, tiles):
    """The kernel's (lo, hi, w_lo, w_hi) rows rebuild the weight matrix
    exactly, the taps never decrease, and every block of rows touches at
    most ``span`` tiles with its prefix table inside 48 KB."""
    tap, wt, tap_np = pc._row_taps(n, tiles, torch.device("cpu"))
    dense = np.zeros((n, tiles), np.float32)
    rows = np.arange(n)
    np.add.at(dense, (rows, tap.numpy()[0]), wt.numpy()[0])
    np.add.at(dense, (rows, tap.numpy()[1]), wt.numpy()[1])
    np.testing.assert_array_equal(dense, pc.tile_weights(n, tiles))
    assert (np.diff(tap_np, axis=1) >= 0).all() and (tap_np[1] >= tap_np[0]).all()
    for bins in (32, 64):
        per_block, span = pc._block_rows(tap_np, bins)
        starts = np.arange(0, n, per_block)
        ends = np.minimum(starts + per_block, n) - 1
        assert (tap_np[1, ends] - tap_np[0, starts] + 1 <= span).all()
        assert bins * span * pc.COLS_PER_BLOCK * 4 <= 48 * 1024


def test_wrapper_rejects_other_devices():
    luma, deltas = _inputs(1, 32, 32, 32)
    with pytest.raises(RuntimeError, match="no tiled-CLAHE implementation"):
        pc.tiled_clahe_new_luma(torch.from_numpy(luma).to("meta"),
                                torch.from_numpy(deltas).to("meta"), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.apply_cuda(torch.from_numpy(luma), torch.zeros(1, 32, 8, 32), 8)
