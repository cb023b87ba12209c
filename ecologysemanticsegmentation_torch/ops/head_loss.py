"""Fused head loss: x4 bilinear upsample + sigmoid + the eight masked loss
sums, differentiable in the low-resolution logits (port of
``ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py``).

On CUDA tensors :func:`fused_head_loss_sums` launches the hand-written
kernels of ``csrc/head_loss.cu`` (forward sums; a one-launch backward that
recomputes the upsample band by band and projects the cotangent back to 1/4
resolution), so the full-resolution logits and probabilities never exist in
device memory.  On CPU tensors it runs the plain versions kept here,
:func:`head_sums_reference` and :func:`head_sums_bwd_reference`, which
compute the same functions with dense interpolation matrices (f32, or f64
for f64 logits).  Any other device raises.

:func:`fused_head_loss_sums_shard` is one rank's part of the spatially
partitioned loss (the JAX package's ``_make_fused_spatial``): all ``h``
rows of the logits against the labels of output rows ``[row0, row0 + H_l)``
of an ``H``-row image.  It launches the same kernels with the tap tables of
that row block, which is all the kernels need: the forward reads the taps
of its own output rows, and the backward's band tables, built for the
block, give every low-resolution row that no output row of the block
reaches an empty range, so its dlogits are exactly 0.
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
_MAX_SMEM = 232448    # bytes of shared memory a block may opt into on sm_90
# ... less the forward's static reduction buffer (csrc/head_loss.cu
# kMaxDynSmem).  The plans aim first for two blocks on an SM (the SM's
# 228 KB, less 1 KB a block): on the H100, tiles of more rows paid more
# than a third or fourth block (PERF.md).
_MAX_DYN_SMEM = _MAX_SMEM - 8 * NUM_SUMS * MAX_CHANNELS * 4
_FWD_SMEM_TARGET = 80 * 1024
_SM_SMEM = 233472                  # shared memory of one SM
_BWD_SMEM_TARGET = 113 * 1024
_BLOCKS_PER_SM = 4
_TILE_ROWS = (8, 4, 2, 1)          # output rows per tile, largest that fits first
_BAND_ROWS = (32, 16, 8, 4, 2, 1)  # backward: low-resolution rows per band

# Kernel launches on the main path, one per forward and one per backward;
# a row block's launches count under their own keys.
launches = {"head_loss_fwd": 0, "head_loss_bwd": 0,
            "head_loss_shard_fwd": 0, "head_loss_shard_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "head_loss_fwd": [_P] * 9 + [_I] * 6 + [_I] * 6 + [_P],
    "head_loss_bwd": [_P] * 11 + [_I] * 6 + [_I] * 7 + [_P],
}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/head_loss.cu`` at first use."""
    return _build.load("head_loss", _SIGNATURES)


def _upsample_block(logits_lr: torch.Tensor, H: int, W: int, row0: int, rows: int,
                    align_corners: bool) -> torch.Tensor:
    """Upsampled logits of output rows ``[row0, row0 + rows)``: f32, or f64
    for f64 logits."""
    dt = torch.promote_types(logits_lr.dtype, torch.float32)
    return resize_bilinear(logits_lr.to(dt), (H, W), align_corners, rows=(row0, rows))


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
    projections, ``Mh`` restricted to the block's rows.  In f32, or in f64
    for f64 logits: there ``1 - p`` keeps its digits where ``p`` nears 1,
    which f32 rounds away (the checks of the kernels on the card use it)."""
    _, h, w, _ = logits_lr.shape
    _, Hl, W, _ = labels.shape
    p = torch.sigmoid(_upsample_block(logits_lr, H, W, row0, Hl, align_corners))
    g = labels.float()
    msk = (g >= 0).float()
    g = g * msk
    k = cot.to(p.dtype)  # (8, C), broadcast over the trailing channel axis
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
    mh = interp_matrix(H, h, align_corners, du.device)[row0:row0 + Hl].to(du.dtype)  # (Hl, h)
    mw = interp_matrix(W, w, align_corners, du.device).to(du.dtype)                  # (W, w)
    dx = torch.einsum("Hh,bHWc->bhWc", mh, du)
    dx = torch.einsum("Ww,bhWc->bhwc", mw, dx)
    return dx.to(logits_lr.dtype)


def head_sums_bwd_reference(logits_lr: torch.Tensor, labels: torch.Tensor,
                            cot: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Plain analytic backward of :func:`head_sums_reference`."""
    return head_sums_shard_bwd_reference(logits_lr, labels, cot, labels.shape[1], 0,
                                         align_corners)


def _block_taps(out_size: int, in_size: int, align_corners: bool, row0: int = 0,
                rows: int | None = None):
    """:func:`_interp_taps` of output indices ``[row0, row0 + rows)`` (all by
    default)."""
    sl = slice(row0, out_size if rows is None else row0 + rows)
    return tuple(t[sl] for t in _interp_taps(out_size, in_size, align_corners))


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
    lo, hi, w_lo, w_hi = _block_taps(out_size, in_size, align_corners, row0, rows)
    src = np.arange(in_size)
    rng = np.stack([np.searchsorted(lo, src, "left"), np.searchsorted(lo, src, "right"),
                    np.searchsorted(hi, src, "left"), np.searchsorted(hi, src, "right")])
    return (torch.from_numpy(np.ascontiguousarray(np.stack([lo, hi]))).to(device),
            torch.from_numpy(np.ascontiguousarray(np.stack([w_lo, w_hi]))).to(device),
            torch.from_numpy(rng.astype(np.int32)).to(device))


def _band_ranges(lo: np.ndarray, hi: np.ndarray, in_size: int, band: int) -> np.ndarray:
    """(2, ceil(in_size / band)) int32: for each band of source indices
    ``[i0, i0 + band)``, the output indices ``[start, end)`` whose lo or hi
    tap lies in it.  The taps never decrease and ``hi <= lo + 1``, so these
    are one contiguous run: from the first output whose hi tap reaches
    ``i0`` to the last whose lo tap is below ``i0 + band``.  An output whose
    lo tap is in one band and hi tap in the next lies in both runs (the
    backward recomputes it in both); a band no output reaches is empty."""
    i0 = np.arange(0, in_size, band)
    start = np.searchsorted(hi, i0, "left")
    end = np.maximum(np.searchsorted(lo, np.minimum(i0 + band, in_size), "left"), start)
    return np.stack([start, end]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _bands(out_size: int, in_size: int, align_corners: bool, band: int, device: torch.device,
           row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """:func:`_band_ranges` of the taps of output indices ``[row0, row0 +
    rows)`` (block-local), on ``device``: the backward kernel's row bands
    (and column bands)."""
    lo, hi, _, _ = _block_taps(out_size, in_size, align_corners, row0, rows)
    return torch.from_numpy(_band_ranges(lo, hi, in_size, band)).to(device)


def _smem(C: int, rs: int, tw: int, nj: int, nl: int, nb: int = 0, jw: int = 0,
          bwd: bool = False) -> int:
    """Dynamic shared memory of one block, as ``csrc/head_loss.cu::layout``
    lays it out: two mbarriers; two ring stages of a tile's labels and the
    logit rows it reads; the row-interpolated logits; and in the backward a
    tile's du, the band's dlogits, its column weights and runs, and two
    stages of row taps."""
    stage = -(-(rs * tw * C * 2) // 128) * 128 + -(-(nl * nj * C * 4) // 128) * 128
    n = 128 + 2 * stage + rs * nj * C * 4
    if bwd:
        n += rs * tw * C * 4 + nb * jw * C * 4 + 2 * tw * 4 + 4 * jw * 4 + 2 * 4 * _TILE_ROWS[0] * 4
    return n


def _col_split(W: int, w: int, lo: np.ndarray, hi: np.ndarray, ncol: int):
    """Output-column bands of ``ceil(W / ncol)`` columns: the width and the
    most low-resolution columns one band reads."""
    tw = -(-W // ncol)
    a = np.arange(0, W, tw)
    return tw, int((hi[np.minimum(a + tw, W) - 1] - lo[a]).max()) + 1


def _tile_rows_read(lo: np.ndarray, hi: np.ndarray, rs: int) -> int:
    """The most low-resolution rows any ``rs`` consecutive output rows read."""
    y = np.arange(len(lo))
    return int((hi[np.minimum(y + rs, len(lo)) - 1] - lo[y]).max()) + 1


def _splits(n: int):
    k = 1
    while k < n:
        yield k
        k *= 2
    yield n


def _bulk_ok(W: int, w: int, C: int, tw: int, nj: int, aligned: bool) -> bool:
    """A tile is one contiguous run of labels and one of logit rows, each of
    16-byte multiples from 16-byte aligned tensors: the bulk copy's terms."""
    return tw == W and nj == w and (W * C) % 8 == 0 and (w * C) % 4 == 0 and aligned


@functools.lru_cache(maxsize=256)
def _fwd_plan(B: int, h: int, w: int, H: int, Hl: int, row0: int, W: int, C: int,
              align_corners: bool, sms: int, aligned: bool) -> tuple:
    """Forward tiling: (rs, tpb, tw, nj, nl, tma, blocks).  Full-width
    tiles of the most rows that fit two blocks on an SM (else one block),
    split into column bands only where a row does not fit; the fewest tiles
    per block (at most 8) that let every block run in one wave of the
    blocks the SMs hold: a second, partial wave would leave most of the card
    idle at the end.  ``tma`` where the bulk copy can
    stream the tiles."""
    ylo, yhi, _, _ = _block_taps(H, h, align_corners, row0, Hl)
    lo, hi, _, _ = _interp_taps(W, w, align_corners)
    for limit in (_FWD_SMEM_TARGET, _MAX_DYN_SMEM):
        for ncol in _splits(W):
            tw, nj = _col_split(W, w, lo, hi, ncol)
            rs = next((r for r in _TILE_ROWS
                       if _smem(C, r, tw, nj, _tile_rows_read(ylo, yhi, r)) <= limit), None)
            if rs is None:
                continue
            ncol = -(-W // tw)
            nl = _tile_rows_read(ylo, yhi, rs)
            slots = sms * max(1, min(_BLOCKS_PER_SM, _SM_SMEM // (_smem(C, rs, tw, nj, nl) + 1024)))
            tiles = -(-Hl // rs)
            tpb = next((t for t in range(1, 9) if B * ncol * -(-tiles // t) <= slots), 8)
            return (rs, tpb, tw, nj, nl, _bulk_ok(W, w, C, tw, nj, aligned),
                    B * ncol * -(-tiles // tpb))
    raise ValueError(f"no forward tiling fits shared memory at W = {W}, w = {w}, C = {C}")


@functools.lru_cache(maxsize=256)
def _bwd_plan(B: int, h: int, w: int, H: int, Hl: int, row0: int, W: int, C: int,
              align_corners: bool, sms: int, aligned: bool) -> tuple:
    """Backward tiling: (rs, tw, nj, nl, nb, jw, tma).  For each band
    height in ``_BAND_ROWS``, full-width column bands if they fit (else the
    fewest that do) and the most tile rows that fit two blocks on an SM
    (else one); of these, the least estimated time: the most blocks on one
    SM times a block's recomputed rows and columns, twice that where an SM
    holds one block (too few warps to hide latency), plus a row per tile,
    and half again without the bulk copy.  Taller bands recompute fewer
    shared output rows (one run of about H/h rows per band edge); shorter
    ones fill the card."""
    ylo, yhi, _, _ = _block_taps(H, h, align_corners, row0, Hl)
    xlo, xhi, _, _ = _interp_taps(W, w, align_corners)
    for limit in (_BWD_SMEM_TARGET, _MAX_DYN_SMEM):
        best = None
        for nb in _BAND_ROWS:
            rows = np.diff(_band_ranges(ylo, yhi, h, nb), axis=0)[0]
            for ncol in _splits(w):
                jw = -(-w // ncol)
                bands = _band_ranges(xlo, xhi, w, jw)
                cols = bands[1] - bands[0]
                tw = int(cols.max())
                bands = bands[:, cols > 0]
                nj = int((xhi[bands[1] - 1] - xlo[bands[0]]).max()) + 1
                rs = next((r for r in _TILE_ROWS if _smem(
                    C, r, tw, nj, _tile_rows_read(ylo, yhi, r), nb, jw, True) <= limit), None)
                if rs is None:
                    continue
                per_sm = -(-B * int((rows > 0).sum()) * int((cols > 0).sum()) // sms)
                tma = _bulk_ok(W, w, C, tw, nj, aligned)
                # a tile's synchronisations and contractions cost about a row
                # more; tiles loaded by the block itself where a bulk copy
                # could have streamed them, about half again
                cost = (per_sm * (int(rows.max()) + -(-int(rows.max()) // rs)) * tw
                        * (2 if per_sm == 1 else 1)
                        * (1.5 if not tma and _bulk_ok(W, w, C, W, w, aligned) else 1))
                if best is None or cost < best[0]:
                    best = (cost, (rs, tw, nj, _tile_rows_read(ylo, yhi, rs), nb, jw, tma))
                break
        if best is not None:
            return best[1]
    raise ValueError(f"no backward tiling fits shared memory at W = {W}, w = {w}, C = {C}")


@functools.lru_cache(maxsize=8)
def _ticket(device: torch.device) -> torch.Tensor:
    """The forward's finished-block counter on ``device``: 0 between launches."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(logits_lr: torch.Tensor, labels: torch.Tensor) -> None:
    xs, gs = logits_lr.shape, labels.shape
    if len(xs) != 4 or len(gs) != 4:
        raise ValueError(f"expected NHWC logits and labels, got {tuple(xs)} and {tuple(gs)}")
    B, h, w, C = xs
    B2, H, W, C2 = gs
    if B != B2 or C != C2:
        raise ValueError(f"batch/channels differ: logits {tuple(xs)}, labels {tuple(gs)}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels: the head-loss kernel takes 1..{MAX_CHANNELS}")
    if logits_lr.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits_lr.dtype}")
    if labels.dtype != torch.bfloat16:
        raise TypeError(f"labels must be bfloat16, got {labels.dtype}")
    if not (logits_lr.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous NHWC tensors")
    dev = logits_lr.device
    if dev != labels.device:
        raise ValueError(f"logits on {dev}, labels on {labels.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no head-loss implementation for {dev}")
    if W * C * 4 + NUM_SUMS * C * 4 > _MAX_SMEM:
        raise ValueError(f"W*C = {W * C} is wider than the head-loss kernels take")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")


def _check_block(labels: torch.Tensor, H: int, row0: int) -> None:
    Hl = labels.shape[1]
    if not (0 <= row0 and row0 + Hl <= H):
        raise ValueError(f"row block [{row0}, {row0 + Hl}) is not inside the image's {H} rows")


def _check_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int) -> None:
    _check(logits_lr, labels)
    _check_block(labels, H, row0)
    if not logits_lr.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {logits_lr.device}")


@functools.lru_cache(maxsize=256)
def _launch_args(bwd: bool, B: int, h: int, w: int, C: int, H: int, Hl: int, row0: int, W: int,
                 align_corners: bool, device: torch.device, aligned: bool) -> tuple:
    """Everything a launch takes but its tensors, per shape: the tables
    (kept alive here), their pointers, the plan's integers, and the
    forward's partial count."""
    y_idx, y_wt, _ = _tables(H, h, align_corners, device, row0, Hl)
    x_idx, x_wt, x_rng = _tables(W, w, align_corners, device)
    if not bwd:
        rs, tpb, tw, nj, nl, tma, nblk = _fwd_plan(B, h, w, H, Hl, row0, W, C, align_corners,
                                                   _sm_count(device), aligned)
        keep = (y_idx, y_wt, x_idx, x_wt)
        return (keep, tuple(t.data_ptr() for t in keep),
                (B, h, w, Hl, W, C, rs, tpb, tw, nj, nl, int(tma)), nblk)
    rs, tw, nj, nl, nb, jw, tma = _bwd_plan(B, h, w, H, Hl, row0, W, C, align_corners,
                                            _sm_count(device), aligned)
    keep = (y_idx, y_wt, x_idx, x_wt, x_rng, _bands(H, h, align_corners, nb, device, row0, Hl),
            _bands(W, w, align_corners, jw, device))
    return (keep, tuple(t.data_ptr() for t in keep),
            (B, h, w, Hl, W, C, rs, tw, nj, nl, nb, jw, int(tma)), 0)


def _aligned(logits_lr: torch.Tensor, labels: torch.Tensor) -> bool:
    return (logits_lr.data_ptr() | labels.data_ptr()) % 16 == 0


def _fwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int,
              align_corners: bool, key: str) -> torch.Tensor:
    """The forward kernel on output rows ``[row0, row0 + H_l)`` of ``H``
    (inputs checked by the caller): its last block adds the per-block
    partials in a fixed order (deterministic; no float atomics), counted by
    the device's ticket, which it leaves at 0 again.  The ticket is one per
    device, so launches on one stream at a time (the current stream, as
    autograd runs them).  Counts one launch under ``key``."""
    B, h, w, C = logits_lr.shape
    _, Hl, W, _ = labels.shape
    dev = logits_lr.device
    _, tables, ints, nblk = _launch_args(False, B, h, w, C, H, Hl, row0, W, bool(align_corners),
                                         dev, _aligned(logits_lr, labels))
    partials = torch.empty((nblk + 1, NUM_SUMS, C), dtype=torch.float32, device=dev)
    ptr = partials.data_ptr()
    rc = library().head_loss_fwd(logits_lr.data_ptr(), labels.data_ptr(), *tables, ptr,
                                 _ticket(dev).data_ptr(), ptr + nblk * NUM_SUMS * C * 4, *ints,
                                 _stream(dev))
    _raise_on(rc, key)
    launches[key] += 1
    return partials[nblk]


def _bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor, H: int,
              row0: int, align_corners: bool, key: str) -> torch.Tensor:
    """The backward kernel on output rows ``[row0, row0 + H_l)`` of ``H``
    (inputs checked by the caller): dlogits (B, h, w, C) f32 for all h
    rows.  Counts one launch under ``key``."""
    B, h, w, C = logits_lr.shape
    _, Hl, W, _ = labels.shape
    dev = logits_lr.device
    k = cot.to(device=dev, dtype=torch.float32).contiguous()
    _, tables, ints, _ = _launch_args(True, B, h, w, C, H, Hl, row0, W, bool(align_corners),
                                      dev, _aligned(logits_lr, labels))
    dx = torch.empty((B, h, w, C), dtype=torch.float32, device=dev)
    rc = library().head_loss_bwd(logits_lr.data_ptr(), labels.data_ptr(), k.data_ptr(), *tables,
                                 dx.data_ptr(), *ints, _stream(dev))
    _raise_on(rc, key)
    launches[key] += 1
    return dx


def head_sums_cuda(logits_lr: torch.Tensor, labels: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Forward kernel: (8, C) f32 sums."""
    H = labels.shape[1]
    _check_cuda(logits_lr, labels, H, 0)
    return _fwd_cuda(logits_lr, labels, H, 0, align_corners, "head_loss_fwd")


def head_sums_bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor,
                       align_corners: bool = True) -> torch.Tensor:
    """Backward kernel: dlogits (B, h, w, C) f32."""
    H = labels.shape[1]
    _check_cuda(logits_lr, labels, H, 0)
    return _bwd_cuda(logits_lr, labels, cot, H, 0, align_corners, "head_loss_bwd")


def head_sums_shard_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, H: int, row0: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Forward kernel on one row block: the block's (8, C) f32 sums."""
    _check_cuda(logits_lr, labels, H, row0)
    return _fwd_cuda(logits_lr, labels, H, row0, align_corners, "head_loss_shard_fwd")


def head_sums_shard_bwd_cuda(logits_lr: torch.Tensor, labels: torch.Tensor, cot: torch.Tensor,
                             H: int, row0: int, align_corners: bool = True) -> torch.Tensor:
    """Backward kernel on one row block: dlogits (B, h, w, C) f32."""
    _check_cuda(logits_lr, labels, H, row0)
    return _bwd_cuda(logits_lr, labels, cot, H, row0, align_corners, "head_loss_shard_bwd")


class _FusedHeadLoss(torch.autograd.Function):
    """Sums of output rows ``[row0, row0 + H_l)`` of an ``H``-row upsample
    (inputs checked by the caller); ``shard`` selects the row block's
    launch counters."""

    @staticmethod
    def forward(ctx, logits_lr, labels, H, row0, align_corners, shard):
        ctx.save_for_backward(logits_lr, labels)
        ctx.args = (H, row0, align_corners)
        ctx.shard = shard
        if not logits_lr.is_cuda:
            return head_sums_shard_reference(logits_lr, labels, H, row0, align_corners)
        return _fwd_cuda(logits_lr, labels, H, row0, align_corners,
                         "head_loss_shard_fwd" if shard else "head_loss_fwd")

    @staticmethod
    def backward(ctx, cot):
        logits_lr, labels = ctx.saved_tensors
        H, row0, align_corners = ctx.args
        if not logits_lr.is_cuda:
            dx = head_sums_shard_bwd_reference(logits_lr, labels, cot, H, row0, align_corners)
        else:
            dx = _bwd_cuda(logits_lr, labels, cot, H, row0, align_corners,
                           "head_loss_shard_bwd" if ctx.shard else "head_loss_bwd")
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
