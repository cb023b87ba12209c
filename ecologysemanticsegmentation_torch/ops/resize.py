"""Bilinear resize as two f32 matrix products, and the nearest resizes
(PyTorch port of ``ecologysemanticsegmentation_tpu/ops/resize.py``).

The interpolation matrices are built on the host exactly as the JAX package
builds them (float64 source coordinates rounded to float32 weights), so the
weights agree bitwise with the reference.  The two-tap tables that the CUDA
head-loss kernel reads (:func:`_interp_taps`) come from the same
construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _interp_taps(out_size: int, in_size: int, align_corners: bool):
    """Two-tap form of :func:`_interp_matrix`: for each output index the
    source indices ``lo``/``hi`` (int32) and their float32 weights
    ``w_lo``/``w_hi``.  Where ``lo == hi`` (the clamped border) ``w_hi`` is 0,
    so ``w_lo * v + w_hi * v`` equals the matrix's ``w_lo + w_hi`` entry."""
    if out_size == in_size:
        idx = np.arange(out_size, dtype=np.int32)
        w = np.zeros(out_size, np.float32)
        return idx, idx.copy(), (1.0 - w), w
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        # Half-pixel centers (torch align_corners=False / jax.image default).
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), 1.0 - w, w


@functools.lru_cache(maxsize=256)
def _interp_matrix(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, float32."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    lo, hi, w_lo, w_hi = _interp_taps(out_size, in_size, align_corners)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), w_lo)
    np.add.at(m, (rows, hi), w_hi)
    return m


@functools.lru_cache(maxsize=64)
def interp_matrix(out_size: int, in_size: int, align_corners: bool,
                  device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix` as a float32 tensor on ``device`` (cached)."""
    return torch.from_numpy(_interp_matrix(out_size, in_size, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False, rows: tuple[int, int] | None = None
                    ) -> torch.Tensor:
    """Bilinear-resize NHWC ``x`` to spatial size ``out_hw``.

    ``Mh @ x @ Mw`` in float32, or float64 for a float64 ``x`` (rows first,
    then columns, as the JAX einsum form), cast back to the input dtype.
    Autocast is off inside, so a bf16 activation is resampled in f32 as the
    JAX path's f32 accumulation is.  ``rows = (row0, n)`` computes only
    output rows ``[row0, row0 + n)`` (a row block of ``Mh``), from all of
    ``x``'s rows: a rank's block of a row-partitioned resize."""
    n, h, w, c = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    row0, nrows = (0, oh) if rows is None else (int(rows[0]), int(rows[1]))
    if (oh, ow) == (h, w):
        return x[:, row0:row0 + nrows]
    dt = torch.promote_types(x.dtype, torch.float32)
    mh = interp_matrix(oh, h, align_corners, x.device)[row0:row0 + nrows].to(dt)
    oh = nrows
    mw = interp_matrix(ow, w, align_corners, x.device).to(dt)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.matmul(mh, x.contiguous().to(dt).reshape(n, h, w * c))  # (n, oh, w*c)
        y = torch.matmul(mw, y.reshape(n * oh, w, c))                     # (n*oh, ow, c)
    return y.reshape(n, oh, ow, c).to(x.dtype)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour integer upsampling of NHWC ``x``: each pixel
    repeated ``scale`` times along both axes (torch
    ``F.interpolate(scale_factor=k)``'s default mode), in one copy."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return y.reshape(n, h * scale, w * scale, c)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC ``x`` to ``out_hw`` with the JAX package's
    rule: output row ``i`` reads input row ``i * h // oh`` (and columns
    alike), which is not ``F.interpolate``'s rule at every ratio."""
    _, h, w, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x[:, rows][:, :, cols]
