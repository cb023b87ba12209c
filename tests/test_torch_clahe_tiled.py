"""The port's tiled-CLAHE apply (``ecologysemanticsegmentation_torch/ops/clahe_tiled.py``)
held against the JAX package's (``ops/pallas/clahe_tiled.py``).

On the CPU the port's wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and against the JAX package's jnp reference
at rtol 1e-5 (f32 sums of at most K + 4 positive terms in another order), at
K = 32 and K = 64 on a square and a non-square size.  An f32 emulation of the
CUDA kernel's arithmetic (each tile's prefix over K, then four taps from the
two axes' two-tap tables) is held against the jnp reference at edge
luminances, on a width that is not a multiple of 4 too.  ``tile_weights``
must agree bitwise, and the kernel's launch plan keep each band's LUT in its
shared memory.  The card's test of the CUDA kernel against the plain version
is in ``test_torch_package.py``, which imports no JAX.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.ops.pallas import clahe_tiled as jc
from ecologysemanticsegmentation_torch.ops import clahe_tiled as pc
from _torch_parallel_ranks import bound_threads

bound_threads()

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


def _edge_luma(luma: np.ndarray, bins: int) -> np.ndarray:
    """``luma`` with every 7th pixel set, in turn, to 0, exactly 1, the bin
    edges k / (K - 1), just above 1, above the last bin by more than a bin,
    just below 0 and NaN."""
    edges = [0.0, 1.0, 1 + 1e-3, 1.1, -1e-3, np.nan] + [k / (bins - 1) for k in range(bins)]
    out = luma.copy().reshape(-1)
    picks = out[::7]
    out[::7] = np.resize(np.asarray(edges, np.float32), picks.shape)
    return out.reshape(luma.shape)


def _kernel_emulation(luma: torch.Tensor, deltas: torch.Tensor, tiles: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in f32: each tile's LUT P = the prefix
    over K of its deltas; j = floor(l (K - 1)) clamped to [0, K - 1] (NaN ->
    0); the two x taps of each tile row, then the two y taps; 0 where
    floor(l (K - 1)) < 0 or l is NaN."""
    b, h, w = luma.shape
    bins = deltas.shape[-1]
    lut = torch.cumsum(deltas, dim=-1)
    ytap, ywt, _ = pc._row_taps(h, tiles, torch.device("cpu"))
    xtap, xwt, _ = pc._row_taps(w, tiles, torch.device("cpu"))
    idx = torch.floor(luma * (bins - 1))
    j = torch.nan_to_num(idx, nan=0.0).clamp(0, bins - 1).long()
    bi = torch.arange(b)[:, None, None]

    def row(t):
        ty = ytap[t].long()[None, :, None]
        return (xwt[0][None, None, :] * lut[bi, ty, xtap[0].long()[None, None, :], j]
                + xwt[1][None, None, :] * lut[bi, ty, xtap[1].long()[None, None, :], j])

    v = ywt[0][None, :, None] * row(0) + ywt[1][None, :, None] * row(1)
    return torch.where(idx >= 0, v, torch.zeros_like(v))


@pytest.mark.parametrize("bins", [32, 64])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 80), (37, 54)])
def test_kernel_emulation_matches_reference_at_edges(bins, h, w):
    luma, deltas = _inputs(2, h, w, bins, seed=bins + h)
    luma = _edge_luma(luma, bins)
    got = _kernel_emulation(torch.from_numpy(luma), torch.from_numpy(deltas), 8)
    ref = np.asarray(jc.tiled_clahe_new_luma(jnp.asarray(luma), jnp.asarray(deltas), 8,
                                             use_pallas=False))
    gated = np.isnan(luma) | (np.floor(luma * np.float32(bins - 1)) < 0)
    assert gated.any() and (np.floor(luma * np.float32(bins - 1)) >= bins).any()
    assert (got.numpy()[gated] == 0).all() and (ref[gated] == 0).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
    plain = pc.tiled_clahe_new_luma(torch.from_numpy(luma), torch.from_numpy(deltas), 8)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n,tiles", [(256, 8), (48, 8), (80, 8), (32, 4), (512, 8), (17, 3)])
def test_two_tap_table_is_tile_weights(n, tiles):
    """The kernel's (lo, hi, w_lo, w_hi) rows, the y table ``_row_taps(H)``
    and the x table ``_row_taps(W)`` alike, rebuild the weight matrix
    exactly and never decrease; so does the x table as the kernel reads it:
    the lo tap, w_lo = 1 - w_hi in f32 and the pair's second tile min(lo +
    1, T - 1).  The launch plan, at K = 32 and 64 and batch 1 and 128:
    every band touches at most ``span`` tile rows, the block's LUT and
    staged deltas fit in 48 KB, and the bands shrink only while the grid is
    short of ``FILL_BLOCKS``."""
    tap, wt, tap_np = pc._row_taps(n, tiles, torch.device("cpu"))
    rows = np.arange(n)
    w_lo = np.float32(1) - wt.numpy()[1]
    assert w_lo.dtype == np.float32
    for second, first_w in ((tap.numpy()[1], wt.numpy()[0]),
                            (np.minimum(tap_np[0] + 1, tiles - 1), w_lo)):
        dense = np.zeros((n, tiles), np.float32)
        np.add.at(dense, (rows, tap_np[0]), first_w)
        np.add.at(dense, (rows, second), wt.numpy()[1])
        np.testing.assert_array_equal(dense, pc.tile_weights(n, tiles))
    assert (np.diff(tap_np, axis=1) >= 0).all() and (tap_np[1] >= tap_np[0]).all()
    for bins in (32, 64):
        for batch in (1, 128):
            per_band, span = pc._plan(batch, n, tiles, bins)
            starts, counts = pc._bands(tap_np, per_band)
            assert counts.max() == span <= tiles
            assert pc._smem_bytes(tiles, bins, span) <= 48 * 1024
            assert pc.MIN_ROWS <= per_band <= pc.ROWS_PER_BLOCK
            assert per_band == pc.MIN_ROWS or batch * len(starts) >= pc.FILL_BLOCKS
            if per_band < pc.ROWS_PER_BLOCK:
                assert batch * -(-n // (2 * per_band)) < pc.FILL_BLOCKS


def test_plan_refuses_a_lut_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        pc._plan(1, 64, 8, 2048)


def test_wrapper_rejects_other_devices():
    luma, deltas = _inputs(1, 32, 32, 32)
    with pytest.raises(RuntimeError, match="no tiled-CLAHE implementation"):
        pc.tiled_clahe_new_luma(torch.from_numpy(luma).to("meta"),
                                torch.from_numpy(deltas).to("meta"), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.apply_cuda(torch.from_numpy(luma), torch.from_numpy(deltas), 8)
