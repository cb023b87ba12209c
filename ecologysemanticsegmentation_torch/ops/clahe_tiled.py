"""Tile-adaptive CLAHE apply (port of
``ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py``).

Per-tile clipped histograms give per-tile CDF steps ``d[b,ty,tx,k]``; the
equalized luminance is the cv2-style bilinear interpolation between the four
nearest tile LUTs:

  new_l[b,y,x] = sum_k 1{floor(l[b,y,x]*(K-1)) >= k} * (Wy[y,:] @ d[b,:,:,k] @ Wx[x,:]^T)

with Wy / Wx the (H, T) / (W, T) tile-centre weights (two taps a row,
clamped at the borders).  The x axis is contracted first, as in the JAX
package: ``Gx = einsum("btsk,xs->bktx", d, Wx)`` in f32.

On CUDA tensors :func:`tiled_clahe_new_luma` launches the hand-written
kernel of ``csrc/clahe_tiled.cu``; on CPU tensors it runs the plain version
kept here, :func:`_apply_reference`.  Any other device raises.  Forward
only: augmentation is outside the differentiated path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

COLS_PER_BLOCK = 32  # columns per kernel block (csrc/clahe_tiled.cu kCols)
ROWS_PER_BLOCK = 32  # rows per kernel block, halved until the staged tiles fit
_SMEM = 48 * 1024    # shared memory a block takes without opting in

# Kernel launches on the main path, one per call on a CUDA tensor.
launches = {"clahe_tiled": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"clahe_tiled_apply": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from ``csrc/clahe_tiled.cu`` at first use."""
    return _build.load("clahe_tiled", _SIGNATURES)


@functools.lru_cache(maxsize=32)
def tile_weights(n: int, tiles: int) -> np.ndarray:
    """(n, tiles) bilinear tile-centre interpolation weights (cv2 CLAHE
    semantics: pixels interpolate between the two nearest tile centres;
    pixels outside the outermost centres clamp to the edge tile).  A copy
    of the JAX package's construction, so the weights agree bitwise."""
    ts = n / tiles
    pos = np.arange(n) + 0.5
    t = pos / ts - 0.5  # fractional tile-centre coordinate
    lo = np.floor(t).astype(np.int64)
    frac = (t - lo).astype(np.float32)
    w = np.zeros((n, tiles), np.float32)
    for i in range(n):
        l, f = lo[i], frac[i]
        if l < 0:
            w[i, 0] = 1.0
        elif l >= tiles - 1:
            w[i, tiles - 1] = 1.0
        else:
            w[i, l] = 1.0 - f
            w[i, l + 1] = f
    return w


@functools.lru_cache(maxsize=32)
def _weights(n: int, tiles: int, device: torch.device) -> torch.Tensor:
    """``tile_weights`` on ``device``, copied once."""
    return torch.from_numpy(tile_weights(n, tiles)).to(device)


def _apply_reference(luma: torch.Tensor, gx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (same operands): accumulates the gated
    per-bin plane ``Wy @ Gx[:, k]`` bin by bin, as the Pallas kernel's loop
    does, so at most one (B, H, W) plane exists at a time."""
    bins = gx.shape[1]
    idx = torch.floor(luma * (bins - 1))
    acc = torch.zeros_like(luma)
    for k in range(bins):
        plane = torch.einsum("yt,btx->byx", wy, gx[:, k])
        acc = acc + plane * (idx >= k)
    return acc


@functools.lru_cache(maxsize=32)
def _row_taps(n: int, tiles: int, device: torch.device):
    """Two-tap form of ``tile_weights(n, tiles)`` on ``device``: tap (2, n)
    int32 [lo; hi] and wt (2, n) f32 [w_lo; w_hi].  A clamped row has one
    tap of weight 1, stored as lo == hi with w_hi = 0."""
    w = tile_weights(n, tiles)
    lo = np.argmax(w != 0, axis=1)
    hi = np.where(w[np.arange(n), np.minimum(lo + 1, tiles - 1)] != 0,
                  np.minimum(lo + 1, tiles - 1), lo)
    w_lo = w[np.arange(n), lo]
    w_hi = np.where(hi != lo, w[np.arange(n), hi], 0.0).astype(np.float32)
    tap = np.stack([lo, hi]).astype(np.int32)
    return (torch.from_numpy(tap).to(device),
            torch.from_numpy(np.stack([w_lo, w_hi])).to(device), tap)


def _block_rows(tap: np.ndarray, bins: int) -> tuple[int, int]:
    """Rows per block and the most tiles a block touches, so that the
    block's (bins, span, 32) f32 prefix table fits in 48 KB."""
    n = tap.shape[1]
    rows = ROWS_PER_BLOCK
    while True:
        starts = np.arange(0, n, rows)
        ends = np.minimum(starts + rows, n) - 1
        span = int((tap[1, ends] - tap[0, starts]).max()) + 1
        if bins * span * COLS_PER_BLOCK * 4 <= _SMEM or rows == 1:
            return rows, span
        rows //= 2


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def apply_cuda(luma: torch.Tensor, gx: torch.Tensor, tiles: int) -> torch.Tensor:
    """The kernel: (B, H, W) f32 luma + (B, K, T, W) f32 Gx -> (B, H, W) f32."""
    if not (luma.is_cuda and gx.is_cuda and luma.device == gx.device):
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {luma.device}, {gx.device}")
    if luma.dtype != torch.float32 or gx.dtype != torch.float32:
        raise TypeError(f"luma and Gx must be float32, got {luma.dtype}, {gx.dtype}")
    if luma.dim() != 3 or gx.dim() != 4:
        raise ValueError(f"expected (B, H, W) luma and (B, K, T, W) Gx, got "
                         f"{tuple(luma.shape)} and {tuple(gx.shape)}")
    b, h, w = luma.shape
    bins = gx.shape[1]
    if tuple(gx.shape) != (b, bins, tiles, w):
        raise ValueError(f"Gx {tuple(gx.shape)} does not match luma {tuple(luma.shape)} "
                         f"and {tiles} tiles")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b}: the kernel's grid takes 1..65535 images")
    luma, gx = luma.contiguous(), gx.contiguous()
    dev = luma.device
    tap, wt, tap_np = _row_taps(h, tiles, dev)
    rows, span = _block_rows(tap_np, bins)
    out = torch.empty_like(luma)
    rc = library().clahe_tiled_apply(
        _ptr(luma), _ptr(gx), _ptr(tap), _ptr(wt), _ptr(out), b, h, w, tiles, bins, rows,
        span, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"clahe_tiled_apply: launch failed with cudaError_t {rc}")
    launches["clahe_tiled"] += 1
    return out


def tiled_clahe_new_luma(luma: torch.Tensor, deltas: torch.Tensor, tiles: int) -> torch.Tensor:
    """(B, H, W) luminance in [0, 1] + (B, T, T, K) per-tile CDF deltas
    -> (B, H, W) f32 equalized luminance (bilinear between tile LUTs)."""
    _, h, w = luma.shape
    dev = luma.device
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no tiled-CLAHE implementation for {dev}")
    wx = _weights(w, tiles, dev)
    # pre-contract the x axis: (B, T, T, K) x (W, T) -> (B, K, T, W)
    gx = torch.einsum("btsk,xs->bktx", deltas.float(), wx)
    if dev.type == "cuda":
        return apply_cuda(luma.float(), gx, tiles)
    return _apply_reference(luma.float(), gx, _weights(h, tiles, dev))
