"""The eight masked per-channel loss sums of the full-resolution losses,
differentiable in both inputs (port of
``ecologysemanticsegmentation_tpu/ops/pallas/loss_sums.py``).

Rows: Σg, Σp, Σp², Σgp, Σ(1−p)^1.5·log(p+ε), Σp^1.5·log(1−p+ε),
Σ max(p,0)+log1p(e^−|p|), and the count of non-ignored pixels.

On CUDA tensors :func:`loss_sums_nhwc` and :func:`fused_loss_sums` launch
the hand-written kernels of ``csrc/loss_sums.cu`` (forward sums, one launch
with its final sum; backward one elementwise pass writing dp and dg), which
read NHWC in place: contiguous inputs as one flat stream of 16-byte loads,
any other (a channel slice, an odd storage offset) through the pixel
stride; :func:`_vector_path` decides.  On CPU tensors they run the plain
versions kept here, :func:`_sums_reference` and
:func:`loss_sums_bwd_reference`.  Any other device raises.

:func:`loss_sums_nhwc_spatial` is the row- and batch-partitioned form (the
JAX package's ``shard_map`` over ``loss_sums_nhwc``): each rank reduces its
own block with the same kernel, and one all-reduce over the world gives
every rank the global sums.  Inside :func:`spatial_mesh_context` every
:func:`loss_sums_nhwc` call takes that form, so the full-resolution losses
partition without a mesh argument of their own.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build
from ..parallel.collectives import all_reduce_sum

EPS = 1e-7
GAMMA = 1.5
NUM_SUMS = 8  # 7 sums + element count
MAX_CHANNELS = 16

# Kernel launches on the main path, one per forward and one per backward.
launches = {"loss_sums_fwd": 0, "loss_sums_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "loss_sums_wave": [_I, _I],
    "loss_sums_fwd": [_P, _P, _L, _L, _L, _I, _I, _P, _L, _P, _P, _P],
    "loss_sums_bwd": [_P, _P, _L, _L, _L, _I, _I, _P, _P, _P, _P],
}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/loss_sums.cu`` at first use."""
    return _build.load("loss_sums", _SIGNATURES)


def _sums_reference(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``p``, ``g`` are (C, N); returns (8, C) float32.  Pixels with
    ``g < 0`` (the ``-1`` ignore sentinel) drop out of every row, the count
    row included."""
    p = p.float()
    g = g.float()
    w = (g >= 0).float()
    gw = g * w
    pw = p * w
    return torch.stack([
        gw.sum(1),
        pw.sum(1),
        (pw * p).sum(1),
        (gw * p).sum(1),
        (w * torch.pow(1.0 - p, GAMMA) * torch.log(p + EPS)).sum(1),
        (w * torch.pow(p, GAMMA) * torch.log(1.0 - p + EPS)).sum(1),
        (w * (torch.clamp(p, min=0.0) + torch.log1p(torch.exp(-p.abs())))).sum(1),
        w.sum(1),
    ])


def loss_sums_bwd_reference(p: torch.Tensor, g: torch.Tensor, cot: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain analytic backward of :func:`_sums_reference` on (C, N) inputs
    with an (8, C) cotangent: the formula of the Pallas ``_bwd_kernel``,
    ``dp = mask * sum_k w_k ds_k/dp`` and ``dg = (w_0 + w_3 p) * mask``."""
    p = p.float()
    g = g.float()
    msk = (g >= 0).float()
    g = g * msk
    k = cot.float()

    def wc(i):  # cotangent weight of sum i, shaped (C, 1) for broadcast
        return k[i][:, None]

    omp = 1.0 - p
    dp = msk * (
        wc(1)
        + wc(2) * 2.0 * p
        + wc(3) * g
        + wc(4) * (omp * torch.sqrt(omp) / (p + EPS)
                   - GAMMA * torch.sqrt(omp) * torch.log(p + EPS))
        + wc(5) * (GAMMA * torch.sqrt(p) * torch.log(omp + EPS)
                   - p * torch.sqrt(p) / (omp + EPS))
        # d/dp [max(p,0) + log1p(e^-|p|)] = 1{p>0} - sign(p)/(1 + e^|p|)
        + wc(6) * ((p > 0).float() - torch.sign(p) / (1.0 + torch.exp(p.abs())))
    )
    dg = (wc(0) + wc(3) * p) * msk
    return dp, dg


def _check(p: torch.Tensor, g: torch.Tensor) -> None:
    """``p``, ``g``: (N, C) pixel-major, float32, on one device."""
    if p.dim() != 2 or p.shape != g.shape:
        raise ValueError(f"p and g must have one (N, C) shape, got {tuple(p.shape)} "
                         f"and {tuple(g.shape)}")
    n, c = p.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{c} channels: the loss-sums kernel takes 1..{MAX_CHANNELS}")
    if n == 0:
        raise ValueError("no pixels to reduce")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"p and g must be float32, got {p.dtype} and {g.dtype}")
    if p.device != g.device:
        raise ValueError(f"p on {p.device}, g on {g.device}")
    if p.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no loss-sums implementation for {p.device}")


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(N, C) ``t`` and the pixel stride at which the kernel reads it: in
    place when its channels are adjacent (a contiguous NHWC tensor, or a
    channel slice of one), else a contiguous copy."""
    if t.shape[1] == 1 or t.stride(1) == 1:
        return t, t.stride(0)
    return t.contiguous(), t.shape[1]


def _vector_path(p: torch.Tensor, g: torch.Tensor, sp: int, sg: int) -> bool:
    """Whether the kernels read (N, C) ``p`` and ``g`` (pixel strides ``sp``,
    ``sg``) as one flat stream of float4: both hold their pixels contiguous
    and start on a 16-byte boundary.  Otherwise they take the pixel-stride
    path (a channel slice of a wider tensor, an odd storage offset)."""
    c = p.shape[1]
    return sp == c and sg == c and p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=8)
def _ticket(device: torch.device) -> torch.Tensor:
    """The forward's finished-block counter on ``device``: 0 between launches."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _partials(device: torch.device, c: int) -> torch.Tensor:
    """Room for one (8, C) partial per block of one wave of the forward."""
    with torch.cuda.device(device):
        blocks = library().loss_sums_wave(c, 0)
    if blocks <= 0:
        raise RuntimeError(f"loss_sums_wave: no occupancy for C = {c} on {device}")
    return torch.empty((blocks, NUM_SUMS, c), dtype=torch.float32, device=device)


def _check_cuda(p: torch.Tensor, g: torch.Tensor) -> None:
    _check(p, g)
    if not p.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {p.device}")


def loss_sums_cuda(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Forward kernel on (N, C) inputs: (8, C) f32 sums, in one launch (its
    last block adds the per-block partials in a fixed order: deterministic,
    no float atomics)."""
    _check_cuda(p, g)
    n, c = p.shape
    p, sp = _rows(p)
    g, sg = _rows(g)
    partials = _partials(p.device, c)
    sums = torch.empty((NUM_SUMS, c), dtype=torch.float32, device=p.device)
    rc = library().loss_sums_fwd(_ptr(p), _ptr(g), sp, sg, n, c, int(_vector_path(p, g, sp, sg)),
                                 _ptr(partials), partials.shape[0], _ptr(_ticket(p.device)),
                                 _ptr(sums), _stream(p.device))
    if rc != 0:
        raise RuntimeError(f"loss_sums_fwd: launch failed with cudaError_t {rc}")
    launches["loss_sums_fwd"] += 1
    return sums


def loss_sums_bwd_cuda(p: torch.Tensor, g: torch.Tensor, cot: torch.Tensor,
                       need_dp: bool = True, need_dg: bool = True
                       ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Backward kernel on (N, C) inputs: ``(dp, dg)``, each (N, C) f32
    contiguous, or None where not asked for."""
    _check_cuda(p, g)
    if not (need_dp or need_dg):
        raise ValueError("the backward needs dp or dg")
    n, c = p.shape
    p, sp = _rows(p)
    g, sg = _rows(g)
    k = cot.to(device=p.device, dtype=torch.float32).contiguous()
    if k.shape != (NUM_SUMS, c):
        raise ValueError(f"cotangent must be ({NUM_SUMS}, {c}), got {tuple(k.shape)}")
    dp = torch.empty((n, c), dtype=torch.float32, device=p.device) if need_dp else None
    dg = torch.empty((n, c), dtype=torch.float32, device=p.device) if need_dg else None
    rc = library().loss_sums_bwd(_ptr(p), _ptr(g), sp, sg, n, c,
                                 int(_vector_path(p, g, sp, sg)), _ptr(k), _ptr(dp), _ptr(dg),
                                 _stream(p.device))
    if rc != 0:
        raise RuntimeError(f"loss_sums_bwd: launch failed with cudaError_t {rc}")
    launches["loss_sums_bwd"] += 1
    return dp, dg


class _LossSums(torch.autograd.Function):
    """(N, C) p, g -> (8, C) sums, with gradients for both inputs."""

    @staticmethod
    def forward(ctx, p, g):
        ctx.save_for_backward(p, g)
        if p.is_cuda:
            return loss_sums_cuda(p, g)
        return _sums_reference(p.T, g.T)

    @staticmethod
    def backward(ctx, cot):
        p, g = ctx.saved_tensors
        need_dp, need_dg = ctx.needs_input_grad
        if p.is_cuda:
            return loss_sums_bwd_cuda(p, g, cot, need_dp, need_dg)
        dp, dg = loss_sums_bwd_reference(p.T, g.T, cot)
        return (dp.T if need_dp else None), (dg.T if need_dg else None)


def fused_loss_sums(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(C, N) f32 probabilities and labels -> (8, C) f32 sums,
    differentiable in both.  Labels below 0 are ignored.  The JAX
    package's layout; for C > 1 the kernel reads a pixel-major copy, so the
    port's losses call :func:`loss_sums_nhwc`."""
    _check(p.T, g.T)
    return _LossSums.apply(p.T, g.T)


#: stack for :func:`spatial_mesh_context`; a ``None`` entry suppresses the
#: redirection inside a shard's own reduction (reentrancy guard)
_SPATIAL_STACK: list = []


@contextlib.contextmanager
def spatial_mesh_context(mesh):
    """Every :func:`loss_sums_nhwc` call inside the context reduces this
    rank's block and all-reduces over ``mesh`` (:func:`loss_sums_nhwc_spatial`).
    The train step enters it around the full-resolution losses when it runs
    on a mesh."""
    _SPATIAL_STACK.append(mesh)
    try:
        yield
    finally:
        _SPATIAL_STACK.pop()


def loss_sums_nhwc_spatial(probs: torch.Tensor, labels: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`loss_sums_nhwc` of a batch split over ``mesh``'s ranks (batch
    over ``data``, rows over ``model``): ``probs``/``labels`` are this rank's
    block; its (8, C) sums (the kernel on a CUDA tensor), summed over the
    world, are the global sums on every rank, exact because each row is a
    plain sum and the count row adds.  The all-reduce passes the cotangent
    through unchanged: every rank computes the same loss from these sums."""
    _SPATIAL_STACK.append(None)  # the shard's own reduction must not re-enter
    try:
        part = loss_sums_nhwc(probs, labels)
    finally:
        _SPATIAL_STACK.pop()
    return all_reduce_sum(part, mesh.world, grad="identity")


def loss_sums_nhwc(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NHWC (any leading axes, channels last) f32 probabilities and labels ->
    (8, C) sums, differentiable in both.  The kernel reads the tensors in
    place, a channel slice of a wider tensor too.  Inside
    :func:`spatial_mesh_context`, the sums over every rank's block."""
    if _SPATIAL_STACK and _SPATIAL_STACK[-1] is not None:
        return loss_sums_nhwc_spatial(probs, labels, _SPATIAL_STACK[-1])
    if probs.shape != labels.shape or probs.dim() < 1:
        raise ValueError(f"probs and labels must have one shape, got {tuple(probs.shape)} "
                         f"and {tuple(labels.shape)}")
    c = probs.shape[-1]
    p, g = probs.reshape(-1, c), labels.reshape(-1, c)
    _check(p, g)
    return _LossSums.apply(p, g)
