"""Fused head loss: x4 bilinear upsample + sigmoid + the eight masked loss
sums, differentiable in the low-resolution logits (port of
``ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py``).

On CUDA tensors :func:`fused_head_loss_sums` launches the hand-written
kernels of ``csrc/head_loss.cu`` (forward sums; backward recomputes the
upsample and projects the cotangent back to 1/4 resolution), so the
full-resolution logits and probabilities never exist in device memory.  On
CPU tensors it runs the plain versions kept here, :func:`head_sums_reference`
and :func:`head_sums_bwd_reference`, which compute the same functions with
dense f32 interpolation matrices.  Any other device raises.

:func:`fused_head_loss_sums_shard` is one rank's part of the spatially
partitioned loss (the JAX package's ``_make_fused_spatial``): all ``h``
rows of the logits against the labels of output rows ``[row0, row0 + H_l)``
of an ``H``-row image.  It launches the same kernels with the tap tables of
that row block, which is all the kernels need: the forward reads the taps
of its own output rows, and the backward's row-run table, built for the
block, leaves every low-resolution row that no output row of the block
reaches at exactly 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .loss_sums import EPS, GAMMA, NUM_SUMS, _sums_reference
from .resize import _interp_taps, interp_matrix, resize_bilinear

MAX_CHANNELS = 16
PIX_PER_BLOCK = 2048  # output pixels per forward block (8 per thread)
_MAX_SMEM = 232448    # bytes of shared memory a block may opt into on sm_90

# Kernel launches on the main path, one per forward and one per backward
# (the backward's two-stage launch counts once); a row block's launches
# count under their own keys.
launches = {"head_loss_fwd": 0, "head_loss_bwd": 0,
            "head_loss_shard_fwd": 0, "head_loss_shard_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "head_loss_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "head_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/head_loss.cu`` at first use."""
    return _build.load("head_loss", _SIGNATURES)


def _upsample_block(logits_lr: torch.Tensor, H: int, W: int, row0: int, rows: int,
                    align_corners: bool) -> torch.Tensor:
    """f32 upsampled logits of output rows ``[row0, row0 + rows)``."""
    return resize_bilinear(logits_lr.float(), (H, W), align_corners, rows=(row0, rows))


def head_sums_shard_reference(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int,
                              align_corners: bool = True) -> torch.Tensor:
    """Plain version of one row block: the (8, C) sums of output rows
    ``[row0, row0 + H_l)`` of the ``H``-row upsample (JAX
    ``_spatial_sums_reference`` with ``mh_local`` = those rows of ``Mh``)."""
    _, Hl, W, c = labels.shape
    p = torch.sigmoid(_upsample_block(logits_lr, H, W, row0, Hl, align_corners))
    return _sums_reference(p.reshape(-1, c).T, labels.reshape(-1, c).T)


def head_sums_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                        align_corners: bool = True) -> torch.Tensor:
    """Plain version: f32 matrix upsample + sigmoid + the (8, C) sums."""
    return head_sums_shard_reference(logits_lr, labels, labels.shape[1], 0, align_corners)


def head_sums_shard_bwd_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                                  cot: torch.Tensor, H: int, row0: int,
                                  align_corners: bool = True) -> torch.Tensor:
    """Plain analytic backward of :func:`head_sums_shard_reference`: the
    formula of the Pallas ``_bwd_kernel`` with dense ``Mh^T``/``Mw^T``
    projections, ``Mh`` restricted to the block's rows."""
    _, h, w, _ = logits_lr.shape
    _, Hl, W, _ = labels.shape
    p = torch.sigmoid(_upsample_block(logits_lr, H, W, row0, Hl, align_corners))
    g = labels.float()
    msk = (g >= 0).float()
    g = g * msk
    k = cot.float()  # (8, C), broadcast over the trailing channel axis
    omp = 1.0 - p
    dp = (
        k[1]
        + k[2] * 2.0 * p
        + k[3] * g
        + k[4] * (omp * torch.sqrt(omp) / (p + EPS)
                  - GAMMA * torch.sqrt(omp) * torch.log(p + EPS))
        + k[5] * (GAMMA * torch.sqrt(p) * torch.log(omp + EPS)
                  - p * torch.sqrt(p) / (omp + EPS))
        + k[6] * ((p > 0).float() - torch.sign(p) / (1.0 + torch.exp(p.abs())))
    )
    du = msk * dp * p * omp                                                 # (B, Hl, W, C)
    mh = interp_matrix(H, h, align_corners, du.device)[row0:row0 + Hl]      # (Hl, h)
    mw = interp_matrix(W, w, align_corners, du.device)                      # (W, w)
    dx = torch.einsum("Hh,bHWc->bhWc", mh, du)
    dx = torch.einsum("Ww,bhWc->bhwc", mw, dx)
    return dx.to(logits_lr.dtype)


def head_sums_bwd_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                            cot: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Plain analytic backward of :func:`head_sums_reference`."""
    return head_sums_shard_bwd_reference(logits_lr, labels, cot, labels.shape[1], 0,
                                         align_corners)


@functools.lru_cache(maxsize=64)
def _tables(out_size: int, in_size: int, align_corners: bool, device: torch.device,
            row0: int = 0, rows: int | None = None):
    """Device tap tables for one axis, for output indices ``[row0, row0 +
    rows)`` (all by default): idx (2, n) [lo; hi] int32, wt (2, n) [w_lo;
    w_hi] f32, and rng (4, in) int32 — for each source index i, the
    contiguous runs of block-local output indices [rng[0,i], rng[1,i]) whose
    lo tap is i and [rng[2,i], rng[3,i]) whose hi tap is i (the taps are
    non-decreasing; a source index no output of the block reaches has empty
    runs)."""
    lo, hi, w_lo, w_hi = _interp_taps(out_size, in_size, align_corners)
    sl = slice(row0, out_size if rows is None else row0 + rows)
    lo, hi, w_lo, w_hi = lo[sl], hi[sl], w_lo[sl], w_hi[sl]
    src = np.arange(in_size)
    rng = np.stack([np.searchsorted(lo, src, "left"), np.searchsorted(lo, src, "right"),
                    np.searchsorted(hi, src, "left"), np.searchsorted(hi, src, "right")])
    return (torch.from_numpy(np.ascontiguousarray(np.stack([lo, hi]))).to(device),
            torch.from_numpy(np.ascontiguousarray(np.stack([w_lo, w_hi]))).to(device),
            torch.from_numpy(rng.astype(np.int32)).to(device))


def _check(logits_lr: torch.Tensor, labels: torch.Tensor) -> None:
    if logits_lr.dim() != 4 or labels.dim() != 4:
        raise ValueError(f"expected NHWC logits and labels, got {tuple(logits_lr.shape)} "
                         f"and {tuple(labels.shape)}")
    B, h, w, C = logits_lr.shape
    B2, H, W, C2 = labels.shape
    if B != B2 or C != C2:
        raise ValueError(f"batch/channels differ: logits {tuple(logits_lr.shape)}, "
                         f"labels {tuple(labels.shape)}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels: the head-loss kernel takes 1..{MAX_CHANNELS}")
    if logits_lr.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits_lr.dtype}")
    if labels.dtype != torch.bfloat16:
        raise TypeError(f"labels must be bfloat16, got {labels.dtype}")
    if not (logits_lr.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous NHWC tensors")
    if logits_lr.device != labels.device:
        raise ValueError(f"logits on {logits_lr.device}, labels on {labels.device}")
    if logits_lr.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no head-loss implementation for {logits_lr.device}")
    if W * C * 4 + NUM_SUMS * C * 4 > _MAX_SMEM:
        raise ValueError(f"W*C = {W * C} is too wide for the backward's shared-memory row")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")


def _check_block(labels: torch.Tensor, H: int, row0: int) -> None:
    Hl = labels.shape[1]
    if not (0 <= row0 and row0 + Hl <= H):
        raise ValueError(f"row block [{row0}, {row0 + Hl}) is not inside the image's {H} rows")


def _check_cuda(logits_lr: torch.Tensor, labels: torch.Tensor) -> None:
    _check(logits_lr, labels)
    if not logits_lr.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {logits_lr.device}")


def _fwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int,
              align_corners: bool, key: str) -> torch.Tensor:
    """The forward kernel on output rows ``[row0, row0 + H_l)`` of ``H``;
    per-block partials are summed here in a fixed order (deterministic; no
    float atomics).  Counts one launch under ``key``."""
    _check_cuda(logits_lr, labels)
    _check_block(labels, H, row0)
    B, h, w, C = logits_lr.shape
    _, Hl, W, _ = labels.shape
    dev = logits_lr.device
    y_idx, y_wt, _ = _tables(H, h, bool(align_corners), dev, row0, Hl)
    x_idx, x_wt, _ = _tables(W, w, bool(align_corners), dev)
    nblk = -(-Hl * W // PIX_PER_BLOCK)
    partials = torch.empty((B * nblk, NUM_SUMS, C), dtype=torch.float32, device=dev)
    rc = library().head_loss_fwd(_ptr(logits_lr), _ptr(labels), _ptr(y_idx), _ptr(y_wt),
                                 _ptr(x_idx), _ptr(x_wt), _ptr(partials),
                                 B, h, w, Hl, W, C, PIX_PER_BLOCK, _stream(dev))
    _raise_on(rc, key)
    launches[key] += 1
    return partials.sum(0)


def _bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor, H: int,
              row0: int, align_corners: bool, key: str) -> torch.Tensor:
    """The backward kernels on output rows ``[row0, row0 + H_l)`` of ``H``:
    dlogits (B, h, w, C) f32 for all h rows.  Counts one launch under ``key``."""
    _check_cuda(logits_lr, labels)
    _check_block(labels, H, row0)
    B, h, w, C = logits_lr.shape
    _, Hl, W, _ = labels.shape
    dev = logits_lr.device
    k = cot.to(device=dev, dtype=torch.float32).contiguous()
    y_idx, y_wt, y_rng = _tables(H, h, bool(align_corners), dev, row0, Hl)
    x_idx, x_wt, x_rng = _tables(W, w, bool(align_corners), dev)
    z = torch.empty((B, Hl, w, C), dtype=torch.float32, device=dev)
    dx = torch.empty((B, h, w, C), dtype=torch.float32, device=dev)
    rc = library().head_loss_bwd(_ptr(logits_lr), _ptr(labels), _ptr(k), _ptr(y_idx),
                                 _ptr(y_wt), _ptr(y_rng), _ptr(x_idx), _ptr(x_wt), _ptr(x_rng),
                                 _ptr(z), _ptr(dx), B, h, w, Hl, W, C, _stream(dev))
    _raise_on(rc, key)
    launches[key] += 1
    return dx


def head_sums_cuda(logits_lr: torch.Tensor, labels: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Forward kernel: (8, C) f32 sums."""
    return _fwd_cuda(logits_lr, labels, labels.shape[1], 0, align_corners, "head_loss_fwd")


def head_sums_bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor,
                       align_corners: bool = True) -> torch.Tensor:
    """Backward kernels: dlogits (B, h, w, C) f32."""
    return _bwd_cuda(logits_lr, labels, cot, labels.shape[1], 0, align_corners,
                     "head_loss_bwd")


def head_sums_shard_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Forward kernel on one row block: the block's (8, C) f32 sums."""
    return _fwd_cuda(logits_lr, labels, H, row0, align_corners, "head_loss_shard_fwd")


def head_sums_shard_bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor,
                             H: int, row0: int, align_corners: bool = True) -> torch.Tensor:
    """Backward kernels on one row block: dlogits (B, h, w, C) f32."""
    return _bwd_cuda(logits_lr, labels, cot, H, row0, align_corners, "head_loss_shard_bwd")


class _FusedHeadLoss(torch.autograd.Function):
    """Sums of output rows ``[row0, row0 + H_l)`` of an ``H``-row upsample;
    ``shard`` selects the row block's launch counters."""

    @staticmethod
    def forward(ctx, logits_lr, labels, H, row0, align_corners, shard):
        ctx.save_for_backward(logits_lr, labels)
        ctx.args = (H, row0, align_corners)
        ctx.shard = shard
        if not logits_lr.is_cuda:
            return head_sums_shard_reference(logits_lr, labels, H, row0, align_corners)
        if shard:
            return head_sums_shard_cuda(logits_lr, labels, H, row0, align_corners)
        return head_sums_cuda(logits_lr, labels, align_corners)

    @staticmethod
    def backward(ctx, cot):
        logits_lr, labels = ctx.saved_tensors
        H, row0, align_corners = ctx.args
        if not logits_lr.is_cuda:
            dx = head_sums_shard_bwd_reference(logits_lr, labels, cot, H, row0, align_corners)
        elif ctx.shard:
            dx = head_sums_shard_bwd_cuda(logits_lr, labels, cot, H, row0, align_corners)
        else:
            dx = head_sums_bwd_cuda(logits_lr, labels, cot, align_corners)
        return dx, None, None, None, None, None  # labels carry no gradient


def fused_head_loss_sums(logits_lr: torch.Tensor, labels: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """(B, h, w, C) f32 low-res logits + (B, H, W, C) bf16 labels in
    {-1, 0, 1} -> (8, C) f32 sums of ``sigmoid(bilinear_upsample(logits))``
    against ``labels``.  Differentiable in ``logits_lr``."""
    _check(logits_lr, labels)
    return _FusedHeadLoss.apply(logits_lr, labels, labels.shape[1], 0, bool(align_corners),
                                False)


def fused_head_loss_sums_shard(logits_lr: torch.Tensor, labels: torch.Tensor, H: int,
                               row0: int, align_corners: bool = True) -> torch.Tensor:
    """One rank's part of the row-partitioned head loss: (B, h, w, C) f32
    logits, all ``h`` rows, and the (B, H_l, W, C) bf16 labels of output
    rows ``[row0, row0 + H_l)`` of the ``H``-row upsample -> that block's
    (8, C) f32 partial sums, whose sum over the blocks is
    :func:`fused_head_loss_sums`.  Differentiable in ``logits_lr``: the
    gradient reaches all ``h`` rows, exactly 0 on the rows the block's taps
    do not read."""
    _check(logits_lr, labels)
    _check_block(labels, int(H), int(row0))
    return _FusedHeadLoss.apply(logits_lr, labels, int(H), int(row0), bool(align_corners), True)
