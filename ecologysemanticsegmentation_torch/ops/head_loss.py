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
# (the backward's two-stage launch counts once).
launches = {"head_loss_fwd": 0, "head_loss_bwd": 0}

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


def head_sums_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                        align_corners: bool = True) -> torch.Tensor:
    """Plain version: f32 matrix upsample + sigmoid + the (8, C) sums."""
    up = resize_bilinear(logits_lr.float(), labels.shape[1:3], align_corners)
    p = torch.sigmoid(up)
    c = p.shape[-1]
    return _sums_reference(p.reshape(-1, c).T, labels.reshape(-1, c).T)


def head_sums_bwd_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                            cot: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Plain analytic backward of :func:`head_sums_reference`: the formula of
    the Pallas ``_bwd_kernel`` with dense ``Mh^T``/``Mw^T`` projections."""
    _, h, w, _ = logits_lr.shape
    _, H, W, _ = labels.shape
    p = torch.sigmoid(resize_bilinear(logits_lr.float(), (H, W), align_corners))
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
    du = msk * dp * p * omp                                      # (B, H, W, C)
    mh = interp_matrix(H, h, align_corners, du.device)           # (H, h)
    mw = interp_matrix(W, w, align_corners, du.device)           # (W, w)
    dx = torch.einsum("Hh,bHWc->bhWc", mh, du)
    dx = torch.einsum("Ww,bhWc->bhwc", mw, dx)
    return dx.to(logits_lr.dtype)


@functools.lru_cache(maxsize=32)
def _tables(out_size: int, in_size: int, align_corners: bool, device: torch.device):
    """Device tap tables for one axis: idx (2, out) [lo; hi] int32, wt
    (2, out) [w_lo; w_hi] f32, and rng (4, in) int32 — for each source index
    i, the contiguous output runs [rng[0,i], rng[1,i]) whose lo tap is i and
    [rng[2,i], rng[3,i]) whose hi tap is i (the taps are non-decreasing)."""
    lo, hi, w_lo, w_hi = _interp_taps(out_size, in_size, align_corners)
    src = np.arange(in_size)
    rng = np.stack([np.searchsorted(lo, src, "left"), np.searchsorted(lo, src, "right"),
                    np.searchsorted(hi, src, "left"), np.searchsorted(hi, src, "right")])
    return (torch.from_numpy(np.stack([lo, hi])).to(device),
            torch.from_numpy(np.stack([w_lo, w_hi])).to(device),
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


def _check_cuda(logits_lr: torch.Tensor, labels: torch.Tensor) -> None:
    _check(logits_lr, labels)
    if not logits_lr.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {logits_lr.device}")


def head_sums_cuda(logits_lr: torch.Tensor, labels: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Forward kernel: (8, C) f32 sums.  Per-block partials are summed here
    in a fixed order (deterministic; no float atomics)."""
    _check_cuda(logits_lr, labels)
    B, h, w, C = logits_lr.shape
    _, H, W, _ = labels.shape
    dev = logits_lr.device
    y_idx, y_wt, _ = _tables(H, h, bool(align_corners), dev)
    x_idx, x_wt, _ = _tables(W, w, bool(align_corners), dev)
    nblk = -(-H * W // PIX_PER_BLOCK)
    partials = torch.empty((B * nblk, NUM_SUMS, C), dtype=torch.float32, device=dev)
    lib = library()
    rc = lib.head_loss_fwd(_ptr(logits_lr), _ptr(labels), _ptr(y_idx), _ptr(y_wt),
                           _ptr(x_idx), _ptr(x_wt), _ptr(partials),
                           B, h, w, H, W, C, PIX_PER_BLOCK, _stream(dev))
    _raise_on(rc, "head_loss_fwd")
    launches["head_loss_fwd"] += 1
    return partials.sum(0)


def head_sums_bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor,
                       align_corners: bool = True) -> torch.Tensor:
    """Backward kernels: dlogits (B, h, w, C) in the logits' dtype."""
    _check_cuda(logits_lr, labels)
    B, h, w, C = logits_lr.shape
    _, H, W, _ = labels.shape
    dev = logits_lr.device
    k = cot.to(device=dev, dtype=torch.float32).contiguous()
    y_idx, y_wt, y_rng = _tables(H, h, bool(align_corners), dev)
    x_idx, x_wt, x_rng = _tables(W, w, bool(align_corners), dev)
    z = torch.empty((B, H, w, C), dtype=torch.float32, device=dev)
    dx = torch.empty((B, h, w, C), dtype=torch.float32, device=dev)
    lib = library()
    rc = lib.head_loss_bwd(_ptr(logits_lr), _ptr(labels), _ptr(k), _ptr(y_idx), _ptr(y_wt),
                           _ptr(y_rng), _ptr(x_idx), _ptr(x_wt), _ptr(x_rng), _ptr(z), _ptr(dx),
                           B, h, w, H, W, C, _stream(dev))
    _raise_on(rc, "head_loss_bwd")
    launches["head_loss_bwd"] += 1
    return dx


class _FusedHeadLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits_lr, labels, align_corners):
        ctx.save_for_backward(logits_lr, labels)
        ctx.align_corners = align_corners
        if logits_lr.is_cuda:
            return head_sums_cuda(logits_lr, labels, align_corners)
        return head_sums_reference(logits_lr, labels, align_corners)

    @staticmethod
    def backward(ctx, cot):
        logits_lr, labels = ctx.saved_tensors
        if logits_lr.is_cuda:
            dx = head_sums_bwd_cuda(logits_lr, labels, cot, ctx.align_corners)
        else:
            dx = head_sums_bwd_reference(logits_lr, labels, cot, ctx.align_corners)
        return dx, None, None  # labels carry no gradient


def fused_head_loss_sums(logits_lr: torch.Tensor, labels: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """(B, h, w, C) f32 low-res logits + (B, H, W, C) bf16 labels in
    {-1, 0, 1} -> (8, C) f32 sums of ``sigmoid(bilinear_upsample(logits))``
    against ``labels``.  Differentiable in ``logits_lr``."""
    _check(logits_lr, labels)
    return _FusedHeadLoss.apply(logits_lr, labels, bool(align_corners))
