"""Collectives with gradients, for the row-partitioned and data-parallel
step (the explicit form of what GSPMD inserts for the JAX package).

Every operation is written from ``all_reduce`` (and :mod:`.mesh`'s
``broadcast``) alone, so one code path serves NCCL across cards and gloo
among ranks that share one card: gloo reduces CUDA tensors through host
memory, but its ``send``/``recv`` (and in some versions ``all_gather``)
take no CUDA tensors.  An all-gather is an all-reduce of a zeroed buffer
with one slot per rank: each slot has one nonzero contributor, so the sum
is exact.

Gradients follow one convention: a rank's backward computes its share of
the global objective's gradient, and the shares are summed over ranks (the
parameter gradients by :func:`all_reduce_grads` after backward).  Each
operation's backward is its adjoint under that convention — except where
every rank turns a reduced value into the same loss (``grad="identity"``
in :func:`all_reduce_sum`): that loss *is* the objective, not one term of
a sum over ranks, so each rank's cotangent is already the global one.
Summing it there as well would make every gradient world-size times too
large.

``group``/``index``/``size`` name a process group, this rank's position in
it and its number of ranks; the tensors live on the caller's device, and
nothing here moves them off it except the backend's own staging.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(Function):
    @staticmethod
    def forward(ctx, x, group, grad):
        ctx.group, ctx.grad = group, grad
        return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "identity":
            return g, None, None
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group, grad: str = "sum") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank.

    ``grad="sum"``: the backward sums the cotangents over the ranks, the
    adjoint when each rank's copy of the result feeds that rank's share of
    the objective (BatchNorm statistics).  ``grad="identity"``: the backward
    passes the cotangent through, for sums from which every rank computes
    the same loss (the loss sums)."""
    if grad not in ("sum", "identity"):
        raise ValueError(f"grad must be 'sum' or 'identity', got {grad!r}")
    return _AllReduceSum.apply(x, group, grad)


class _GatherRows(Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.args = (dim, group, index, size)
        xs = x.detach().movedim(dim, 0)
        buf = xs.new_zeros((size,) + tuple(xs.shape))
        buf[index] = xs
        _all_reduce_(buf, group)
        return buf.flatten(0, 1).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, group, index, size = ctx.args
        gs = g.movedim(dim, 0)
        gs = gs.reshape((size, gs.shape[0] // size) + tuple(gs.shape[1:]))
        gbuf = _all_reduce_(gs.contiguous(), group)
        return gbuf[index].movedim(0, dim), None, None, None, None


def all_gather_rows(x: torch.Tensor, dim: int, group, index: int, size: int) -> torch.Tensor:
    """The ranks' blocks of axis ``dim`` concatenated in rank order (every
    rank's block the same length).  Backward: the cotangent summed over the
    ranks, this rank's block of it."""
    return _GatherRows.apply(x, dim, group, index, size)


class _Halo(Function):
    @staticmethod
    def forward(ctx, x, top, bottom, pad_value, dim, group, index, size):
        xs = x.detach().movedim(dim, 0)
        n = xs.shape[0]
        t, b = min(top, n), min(bottom, n)
        # Slot q holds rank q's last t rows (its part of the halos above
        # other blocks), then its first b rows (of the halos below).
        buf = xs.new_zeros((size, t + b) + tuple(xs.shape[1:]))
        buf[index, :t] = xs[n - t:]
        buf[index, t:] = xs[:b]
        _all_reduce_(buf, group)
        src = _halo_rows(n, t, b, top, bottom, index, size)
        flat = buf.flatten(0, 1)
        rows = torch.full((top + bottom,) + tuple(xs.shape[1:]), pad_value,
                          dtype=xs.dtype, device=xs.device)
        valid = [i for i, s in enumerate(src) if s >= 0]
        if valid:
            rows[valid] = flat[[src[i] for i in valid]]
        ctx.args = (n, t, b, top, bottom, dim, group, index, size, src, valid)
        return torch.cat([rows[:top], xs, rows[top:]], 0).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n, t, b, top, bottom, dim, group, index, size, src, valid = ctx.args
        gs = g.movedim(dim, 0)
        halo = torch.cat([gs[:top], gs[top + n:]], 0)
        gbuf = gs.new_zeros((size * (t + b),) + tuple(gs.shape[1:]))
        if valid:
            gbuf.index_add_(0, torch.tensor([src[i] for i in valid], device=gs.device),
                            halo[valid])
        gbuf = _all_reduce_(gbuf, group).view((size, t + b) + tuple(gs.shape[1:]))
        dx = gs[top:top + n].clone()
        dx[n - t:] += gbuf[index, :t]
        dx[:b] += gbuf[index, t:]
        return dx.movedim(0, dim), None, None, None, None, None, None, None


def _halo_rows(n: int, t: int, b: int, top: int, bottom: int, index: int,
               size: int) -> list[int]:
    """For each halo row (``top`` above, then ``bottom`` below this rank's
    block of ``n`` rows), its row in the flattened slot buffer, or -1 where
    it lies outside the image."""
    src = []
    for r in list(range(index * n - top, index * n)) + list(
            range((index + 1) * n, (index + 1) * n + bottom)):
        q, local = divmod(r, n)
        if r < 0 or q >= size:
            src.append(-1)
        elif r < index * n:           # from a block above: its last t rows
            src.append(q * (t + b) + local - (n - t))
        else:                          # from a block below: its first b rows
            src.append(q * (t + b) + t + local)
    return src


def halo_exchange(x: torch.Tensor, top: int, bottom: int, dim: int, group, index: int,
                  size: int, pad_value: float = 0.0) -> torch.Tensor:
    """This rank's block of axis ``dim`` with ``top`` rows of the blocks
    above and ``bottom`` rows of the blocks below it, ``pad_value`` past
    the image's edges (0 for a convolution, -inf for a max pool).  A halo
    may be longer than a block: it then reaches further ranks.  Backward:
    the halo rows' cotangents go back to the ranks that own those rows and
    are added to theirs."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, pad_value, dim, group, index, size)


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum every parameter's ``.grad`` over ``group``, in one buffer (a
    parameter without a gradient contributes zeros, so every rank reduces
    the same layout)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    _all_reduce_(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        chunk = flat[offset:offset + n].view_as(p)
        if p.grad is None:
            p.grad = chunk.clone()
        else:
            p.grad.copy_(chunk)
        offset += n


__all__ = ["all_gather_rows", "all_reduce_grads", "all_reduce_sum", "halo_exchange"]
