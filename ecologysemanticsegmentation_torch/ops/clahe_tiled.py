"""Tile-adaptive CLAHE apply (port of
``ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py``).

Per-tile clipped histograms give per-tile CDF steps ``d[b,ty,tx,k]``; the
equalized luminance is the cv2-style bilinear interpolation between the four
nearest tile LUTs:

  new_l[b,y,x] = sum_k 1{floor(l[b,y,x]*(K-1)) >= k} * (Wy[y,:] @ d[b,:,:,k] @ Wx[x,:]^T)

with Wy / Wx the (H, T) / (W, T) tile-centre weights (two taps a row,
clamped at the borders).

On CUDA tensors :func:`tiled_clahe_new_luma` launches the hand-written
kernel of ``csrc/clahe_tiled.cu`` once, on the luminance, the deltas and
the two-tap tables of both axes: each block turns its band's tile rows of
deltas into LUTs (prefix sums over k) in shared memory and looks up four
of them a pixel, so nothing the size of an image but the luminance and the
output crosses device memory, and the function's bytes bound it.  The JAX
package contracts the x axis first, ``Gx = einsum("btsk,xs->bktx", d,
Wx)``, because the TPU's matrix unit wants dense (H, T) @ (T, W) dots; the
kernel builds no Gx.  On CPU tensors the wrapper runs the plain version
kept here, :func:`reference` (that einsum, then :func:`_apply_reference`).
Any other device raises.  Forward only: augmentation is outside the
differentiated path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

ROWS_PER_BLOCK = 64  # rows of a band at most (csrc/clahe_tiled.cu: 8 warps, a row each at a time)
MIN_ROWS = 4         # bands shrink to this many rows to fill the card ...
FILL_BLOCKS = 2 * 132  # ... until the grid has two blocks for each of an H100's 132 SMs
_SMEM = 48 * 1024    # shared memory a block takes (the kernel does not opt in to more)

# Kernel launches on the main path, one per call on a CUDA tensor.
launches = {"clahe_tiled": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"clahe_tiled_apply": [_P] * 7 + [_I] * 7 + [_P]}


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
    """Plain version of the JAX package's kernel (same operands): accumulates
    the gated per-bin plane ``Wy @ Gx[:, k]`` bin by bin, as the Pallas
    kernel's loop does, so at most one (B, H, W) plane exists at a time."""
    bins = gx.shape[1]
    idx = torch.floor(luma * (bins - 1))
    acc = torch.zeros_like(luma)
    for k in range(bins):
        plane = torch.einsum("yt,btx->byx", wy, gx[:, k])
        acc = acc + plane * (idx >= k)
    return acc


def reference(luma: torch.Tensor, deltas: torch.Tensor, tiles: int) -> torch.Tensor:
    """Plain version of the function, on any device: the x axis contracted
    first, as in the JAX package, then :func:`_apply_reference`."""
    _, h, w = luma.shape
    # (B, T, T, K) x (W, T) -> (B, K, T, W)
    gx = torch.einsum("btsk,xs->bktx", deltas.float(), _weights(w, tiles, luma.device))
    return _apply_reference(luma.float(), gx, _weights(h, tiles, luma.device))


@functools.lru_cache(maxsize=32)
def _row_taps(n: int, tiles: int, device: torch.device):
    """Two-tap form of ``tile_weights(n, tiles)`` on ``device``, for either
    axis: tap (2, n) int32 [lo; hi] and wt (2, n) f32 [w_lo; w_hi].  A
    clamped row has one tap of weight 1, stored as lo == hi with w_hi = 0."""
    w = tile_weights(n, tiles)
    lo = np.argmax(w != 0, axis=1)
    hi = np.where(w[np.arange(n), np.minimum(lo + 1, tiles - 1)] != 0,
                  np.minimum(lo + 1, tiles - 1), lo)
    w_lo = w[np.arange(n), lo]
    w_hi = np.where(hi != lo, w[np.arange(n), hi], 0.0).astype(np.float32)
    tap = np.stack([lo, hi]).astype(np.int32)
    return (torch.from_numpy(tap).to(device),
            torch.from_numpy(np.stack([w_lo, w_hi])).to(device), tap)


def _smem_bytes(tiles: int, bins: int, span: int) -> int:
    """Shared memory of a block (``csrc/clahe_tiled.cu::smem_bytes``): the
    (bins, sj) LUT of float2 pairs with sj = span * tiles rounded up to odd,
    padded to 16 bytes, and the band's (span * tiles, bins) staged deltas."""
    sj = (span * tiles) | 1
    return ((bins * sj + 1) & ~1) * 8 + span * tiles * bins * 4


def _bands(tap: np.ndarray, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """First row and tile-row count of each band of ``rows`` rows."""
    n = tap.shape[1]
    starts = np.arange(0, n, rows)
    ends = np.minimum(starts + rows, n) - 1
    return starts, tap[1, ends] - tap[0, starts] + 1


@functools.lru_cache(maxsize=64)
def _plan(batch: int, h: int, tiles: int, bins: int) -> tuple[int, int]:
    """(rows per band, most tile rows a band touches): bands of up to
    ``ROWS_PER_BLOCK`` rows, halved (not below ``MIN_ROWS``) while the grid
    has fewer than ``FILL_BLOCKS`` blocks and (down to one row) while the
    band's LUT and staged deltas would not fit in ``_SMEM``."""
    tap = _row_taps(h, tiles, torch.device("cpu"))[2]
    rows = ROWS_PER_BLOCK
    while rows > MIN_ROWS and batch * -(-h // rows) < FILL_BLOCKS:
        rows //= 2
    while True:
        span = int(_bands(tap, rows)[1].max())
        if _smem_bytes(tiles, bins, span) <= _SMEM:
            return rows, span
        if rows == 1:
            raise ValueError(f"{tiles} tiles of {bins} bins: a band's LUT takes "
                             f"{_smem_bytes(tiles, bins, span)} bytes of shared memory, more "
                             f"than the kernel's {_SMEM}")
        rows //= 2


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def apply_cuda(luma: torch.Tensor, deltas: torch.Tensor, tiles: int) -> torch.Tensor:
    """The kernel: (B, H, W) f32 luma + (B, T, T, K) f32 deltas -> (B, H, W) f32."""
    if not (luma.is_cuda and deltas.is_cuda and luma.device == deltas.device):
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {luma.device}, "
                         f"{deltas.device}")
    if luma.dtype != torch.float32 or deltas.dtype != torch.float32:
        raise TypeError(f"luma and deltas must be float32, got {luma.dtype}, {deltas.dtype}")
    if luma.dim() != 3 or deltas.dim() != 4:
        raise ValueError(f"expected (B, H, W) luma and (B, T, T, K) deltas, got "
                         f"{tuple(luma.shape)} and {tuple(deltas.shape)}")
    b, h, w = luma.shape
    bins = deltas.shape[3]
    if tuple(deltas.shape) != (b, tiles, tiles, bins) or bins < 1:
        raise ValueError(f"deltas {tuple(deltas.shape)} do not match luma "
                         f"{tuple(luma.shape)} and {tiles} tiles")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b}: the kernel's grid takes 1..65535 images")
    rows, span = _plan(b, h, tiles, bins)
    luma, deltas = luma.contiguous(), deltas.contiguous()
    dev = luma.device
    ytap, ywt, _ = _row_taps(h, tiles, dev)
    xtap, xwt, _ = _row_taps(w, tiles, dev)
    out = torch.empty_like(luma)
    rc = library().clahe_tiled_apply(
        _ptr(luma), _ptr(deltas), _ptr(ytap), _ptr(ywt), _ptr(xtap), _ptr(xwt), _ptr(out), b, h,
        w, tiles, bins, rows, span, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"clahe_tiled_apply: launch failed with cudaError_t {rc}")
    launches["clahe_tiled"] += 1
    return out


def tiled_clahe_new_luma(luma: torch.Tensor, deltas: torch.Tensor, tiles: int) -> torch.Tensor:
    """(B, H, W) luminance in [0, 1] + (B, T, T, K) per-tile CDF deltas
    -> (B, H, W) f32 equalized luminance (bilinear between tile LUTs)."""
    dev = luma.device
    if dev.type == "cuda":
        return apply_cuda(luma.float(), deltas.float(), tiles)
    if dev.type != "cpu":
        raise RuntimeError(f"no tiled-CLAHE implementation for {dev}")
    return reference(luma, deltas, tiles)
