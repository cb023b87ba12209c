#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --mutants  # only: the gradient checks against broken kernels
    python3 chip_smoke.py --loss-sums-times [TREE]  # only: the loss-sums kernels' times
    python3 chip_smoke.py --clahe-times [TREE]      # only: the tiled-CLAHE apply's times
    python3 chip_smoke.py --zoo      # only: build the kernels, then phase 9

Phases, each fatal on failure (an exception ends the run with a non-zero
exit code before the result line is printed):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the three CUDA kernel sources from
   ``ecologysemanticsegmentation_torch/ops/csrc`` with nvcc, one process per
   source, all started together; each kernel's registers and spills (the
   head-loss kernels must not spill at C = 3, the loss-sums kernels at
   C = 1 and 3, the tiled-CLAHE kernel, which takes K at run time);
3. kernels: every kernel against its plain PyTorch version on the card at the
   main paths' shapes and at the other shapes it serves, with its time, the
   plain version's time and its bound (the head loss also at 512, 768 and
   1024 px, a ragged row, C = 16, rows split into column bands and a
   downsample, its dlogits element by element against
   the plain version in float64, each kernel launched twice and bitwise
   equal, and a cold time beside the warm one at the main shape; its
   per-shard form, the head-loss kernels launched with a row block's
   tables, at the 512 px spatial step's shard shapes for every block of a
   2- and 4-way split at C = 3, 1 and 11, dlogits element by element, and
   the blocks added together against the unsharded kernel;
   the loss sums at the sequential step's C = 3 and C = 1 calls, the
   single-organ call with ``-1`` labels in the prediction slot (NaN where
   the plain version is), a ragged tail, C = 11 and 1024 px, and at the
   spatial sequential step's per-shard call, their gradients element by
   element, each kernel launched twice and bitwise equal, each call's
   backward timed writing the gradient its path asks for, and a cold time
   beside the warm one at the main shape; the tiled-CLAHE apply, one
   launch from the tile deltas, against its plain version at five shapes
   (one whose width is not a multiple of 4), with edge luminances (0,
   exactly 1, above 1, below 0, NaN, the bin edges), a second launch bitwise
   equal, and at the main shape the function timed warm, cold, as the host
   enqueues it and in a CUDA graph, beside the device time of the
   augmentation's whole tiled and global CLAHE ops);
   device augmentation on the card against the same draws on the CPU, in
   both CLAHE forms; a small batch of the unaugmented step on the card
   against the step on the CPU (plain versions), for the flagship
   low-resolution head loss and the single-organ step (f32 models, bf16
   autocast on the card) and for the full-resolution losses (float64
   models; ``composite_mode`` "sequential" and "general" at C = 3, "none"
   at C = 1);
4. forward and eval: ``make_forward`` and ``make_eval_step`` at batch 128,
   256 px, C = 3, full width;
5. train step: DeepLabV3+ (resnet34, full width), batch 128 at 256 px,
   bf16 autocast, 13 steps each of: the flagship (C = 3,
   ``lowres_head=True``) with ``augment=False``, with ``augment=True`` and
   the global CLAHE, and with ``augment=True`` and the tiled CLAHE
   (``AUGMENT_TILED_CLAHE=1``); the sequential trainer's step (C = 3,
   ``composite_mode="sequential"``, full resolution) and the single-organ
   step (C = 1, full resolution), each augmented with the global CLAHE.
   For each run the launch counters are zeroed just before and read just
   after: every kernel of its path must have launched as often as the path
   calls it (the loss sums twice a step in the sequential step, once in the
   single-organ step; no other kernel's count may move), and the loss must
   be finite and fall;
6. parallel: four ranks on the one card (``cuda:0``) over a gloo group
   (NCCL refuses two ranks on one device), spawned with a timeout.  (a)
   Small float64 steps (64 px, batch 4, decoder 32, dropout 0), each
   against the one-rank step on the card from the same weights and batch:
   the spatial flagship and sequential steps on a (2, 2) grid and the
   data-parallel flagship step on (4, 1), each counted on every rank (the
   flagship 1 + 1 per-shard head-loss launches, the sequential step 2 + 2
   loss-sums launches, no other kernel's).  (b) The spatial flagship at full
   width: (2, 2) grid, 512 px, global batch 16, augmentation with the
   global CLAHE, bf16 autocast, 13 steps, counters zeroed just before and
   read just after on every rank (13 + 13 per-shard head-loss launches, no
   other kernel's); the loss finite, falling and equal on every rank, and
   the parameters and BN buffers bitwise equal on every rank.  Its ms/step
   and peak memory are of four ranks time-sharing one card with
   host-staged collectives, not a multi-card figure;
7. the trainer CLI (runs after phase 5, before phase 6):
   ``ecologysemanticsegmentation_torch.train_multiclass.train`` called as
   ``python -m`` would call it, ``--dataset synthetic --batch_size 128``,
   in a temporary directory removed at the end, on the imops backend the
   machine has (cv2, else PIL, else the port's own; msgpack is never
   imported: the port packs checkpoints itself): (a) the flagship
   (``ORGANS=whole_body,ventral_side,dorsal_side IMGSIZE=256``, augmented,
   global CLAHE) for 12 epochs, one step of 108 images padded to 128 each;
   (b) the same command resumed to 13 epochs, which must load the epoch-11
   file and run epoch 12 only; (c) one organ (``ORGANS=whole_body``) for 3
   epochs.  Counters zeroed just before each run and read just after: the
   head loss 1 + 1 a step in (a) and (b), the loss sums 1 + 1 a step in
   (c), no other kernel's.  Checked: the loss of (a) finite and falling; the
   checkpoints of epochs 0, 10, 11 and 12 at the JAX layout; the epoch-12 file
   restored by the port's reader into a fresh state equal to the run's,
   leaf by leaf; every val triplet a readable 256 x 256 PNG; ``metrics.csv``
   with the JAX CLI's columns.  Printed: each run's wall time, the CLI's
   images per second by epoch and peak memory, and the CLI's step beside
   phase 5's augmented step (their difference is the host pipeline's
   share);
8. per-sample augmentation, the sequential trainer and the eval CLIs (runs
   after phase 7, before phase 6): (a) the per-sample apply
   (``AUGMENT_PER_SAMPLE=1``) on the card at batch 8, 64 px, with every
   OneOf op and warp case forced, against the per-sample apply on the CPU
   from the same draws and against eight singleton batch-uniform applies on
   the card (phase 3's image tolerance; masks equal but for a few pixels
   at rounding ties), neither granularity's call synchronizing with the
   device (``torch.cuda.set_sync_debug_mode("error")``), then phase 5's
   augmented flagship run with
   per-sample draws, 13 steps in each CLAHE form (head loss 13 + 13, tiled
   CLAHE 13 in the tiled run, nothing else), beside phase 5's batch-uniform
   step; (b) ``train_multiclass_sequential_densenetloss`` in-process like
   ``python -m``, ``--dataset synthetic --batch_size 128``, three organs at
   256 px, augmented, 12 epochs in a temporary directory: the loss sums
   2 + 2 a step and no other kernel, the divergence guard holding, the loss
   falling, checkpoints at epochs 0, 5, 10 and 11, the plateau lr and the
   CLI's img/s by epoch beside phase 5's sequential step; (c)
   ``test_multiclass_sequential_densenetloss`` over (b)'s checkpoints
   (per-organ Dice finite in [0, 1], a second call skipping every epoch,
   ``--single_model`` with ``--edge_analysis`` writing readable PNGs) and
   ``test_multiclass`` over a seeded synthetic smp-layout ``.pt`` state
   dict, which must score exactly as its round trip through the port's
   ``save_checkpoint`` does; the eval's ms per batch, and no kernel launch;
9. the rest of the model zoo (runs after phase 8, before phase 6): (a) a
   small step (float64 models, 64 px, batch 4, unaugmented, dropout 0
   where the model takes it as an argument) on the card against the CPU at
   phase 3's float64 tolerance for the VGG U-Net (``max_channels`` 256,
   deep supervision), the ResNet U-Net with resnet34 and resnet50,
   DeepLabV3+ resnet50 (the low-resolution head), the depthwise wrapper
   (``composite_mode="sequential"``) and the EfficientNetV2-S U-Net at
   depth 0.2 (its stochastic-depth masks, p fixed inside, drawn on both
   sides from one seeded CPU generator); (b) each of them at full width
   (the EfficientNet at its full depth), batch 128 at 256 px, C = 3,
   augmented with the global CLAHE, bf16 autocast, 13 steps from seed 0,
   counters zeroed just before and read just after: the loss sums 13 + 13
   (26 + 26 for the depthwise sequential step), the head loss 13 + 13 for
   DeepLabV3+ resnet50, no other kernel's; the loss finite and falling;
   ms/step and peak memory; the VGG U-Net also with ``remat`` from the same
   weights, batch and seeds, whose first loss and gradients must equal the
   plain run's within phase 3's bf16 step tolerance; (c) in a temporary
   directory, ``train_multiclass --model vgg_unet --deepsupervision`` with
   phase 7's flags and data for 4 epochs (loss sums 1 + 1 a step, the
   checkpoints of epochs 0 and 3, the last restored leaf by leaf,
   ``metrics.csv``), ``test_multiclass --deepsupervision`` over them (Dice
   finite in [0, 1], no kernel launch) and
   ``train_multiclass_sequential_densenetloss --depthwiseconv`` for 3
   epochs (loss sums 2 + 2 a step).  ``--zoo`` builds the kernels and runs
   this phase alone.

The device time of the step by layer is not measured here:
``python3 -m ecologysemanticsegmentation_torch.train.profile_step`` does that.

The line before the last holds the card's name and power limit; the
``kernels`` JSON line comes before it (each kernel's ``launches`` in the
phase 5 or 6 run that exercises it, its ``cli_launches`` in phase 7, its
``per_sample_launches`` in phase 8's per-sample tiled-CLAHE run, its
``seq_cli_launches`` in phase 8's sequential CLI and its ``zoo_launches``
summed over phase 9's counted runs);
the last line is the device result.
Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero and prints no result.

``--mutants`` builds copies of ``csrc/loss_sums.cu`` with one term of the
backward, or its pixel-stride path, broken each, of ``csrc/head_loss.cu``
with a band edge or a column tap of the backward broken, and of
``csrc/clahe_tiled.cu`` with the x interpolation's hi tap dropped, an
exclusive prefix over K, the bin not clamped at K - 1, or the gate for
l < 0 and NaN gone (under the gitignored ``ops/build/mutants/``), and
shows that phase 3's element-wise checks refuse every one and pass the
kernels as written; it prints the looser max-scaled check's verdict
beside.

``--loss-sums-times [TREE]`` only times the loss-sums kernels as phase 3
does (warm at every timed call, cold at the main shape), with the package of
the checkout at TREE (this one by default), so that two trees' kernels can
be timed in turns on one card.

``--clahe-times [TREE]`` only times the tiled-CLAHE apply of the checkout
at TREE as phase 3 does (the function as the augmentation calls it, warm,
cold, host enqueue and in a CUDA graph; the augmentation's tiled and
global CLAHE ops); a tree whose apply goes through an x-contracted Gx
plane also has its einsum and its kernel timed alone, and this tree's
kernel is also timed with its LUT laid out [tile][j] instead of [j][tile]
and as its stream alone (no lookups), beside a plain copy of the same
luminance.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Floating-point operations per full-resolution label element, counted as
# instructions: the forward's two-tap upsample (6 mul + 3 add), sigmoid
# (exp, add, div), the eight row updates (2 sqrt, 2 log, exp, log1p, 3 sub,
# 5 mul, 2 add for the eps, 1 max, 1 abs, 8 accumulating adds); the backward's
# upsample and sigmoid again, dp (2 sqrt, 2 log, exp, 2 div, ~16 mul/add) and
# sigma', and the two transposed two-tap projections (8 mul-add).
FWD_OPS_PER_ELEM = 9 + 3 + 30
BWD_OPS_PER_ELEM = 9 + 3 + 26 + 2 + 8

# Operations per element of the full-resolution loss sums, counted as
# instructions.  Forward: the mask, g*w and 1-p (3), the four plain rows
# (8), the two focal rows (2 x (sqrt, 2 mul, eps add, log, mul, add)), the
# softplus row (max, abs, neg, exp, log1p, add, mul, add) and the count (1).
# Backward, dp: 1-p, 2 sqrt, the sign (4), rows 1-3 (3), row 4 (8), row 5
# (9), row 6 (7), the sum (5) and the mask (1); dg: mul, add, mul.
LS_FWD_OPS_PER_ELEM = 3 + 8 + 14 + 8 + 1
LS_DP_OPS_PER_ELEM = 4 + 3 + 8 + 9 + 7 + 5 + 1
LS_DG_OPS_PER_ELEM = 3

# (B, h, w, H, W, C, align_corners): the main path's shape first.
SHAPES = [
    (128, 64, 64, 256, 256, 3, True),
    (128, 64, 64, 256, 256, 1, True),
    (32, 64, 64, 256, 256, 11, True),
    (3, 64, 64, 256, 256, 3, False),
    (1, 128, 128, 512, 512, 3, True),
    (1, 256, 256, 1024, 1024, 3, True),
    (32, 128, 128, 512, 512, 3, True),
    (16, 192, 192, 768, 768, 3, True),
    (8, 256, 256, 1024, 1024, 3, True),
    (2, 25, 26, 97, 101, 3, False),   # a row of 303 bf16: labels loaded without the bulk copy
    (4, 64, 64, 256, 256, 16, True),
    (1, 8, 750, 32, 3000, 16, True),   # rows too wide for shared memory: column bands
    (2, 40, 48, 16, 20, 3, False),     # a downsample
]
# Shapes whose times are printed: the main path's, and the sizes at which
# the JAX package selects its row-blocked kernels (head_loss.py:272, :298),
# at the main path's pixels per batch.
TIMED = {SHAPES[0], SHAPES[6], SHAPES[7], SHAPES[8]}

# Tiled CLAHE (B, H, W, tiles, bins): the main path's shape first; the last
# has a width that is not a multiple of 4 (the kernel's scalar path).
CLAHE_SHAPES = [
    (128, 256, 256, 8, 64),
    (128, 256, 256, 8, 32),
    (1, 512, 512, 8, 64),
    (4, 192, 320, 8, 64),
    (2, 97, 101, 8, 64),
]
CLAHE_ATOL = 1e-5   # f32 sums of <= K + 4 terms of magnitude <= 1, in another order
# Operations a pixel of the tiled-CLAHE apply: the bin index (mul, floor),
# the two x taps of two tile rows (2 x (2 mul + add)) and the two y taps
# (2 mul + add).
CLAHE_OPS_PER_PIXEL = 2 + 6 + 3
# Loss sums (B, H, W, C, swapped): the sequential step's C = 3 call (the
# main call of every full-resolution path) and its C = 1 cross term, then
# the single-organ step's call as it is made (swapped: {-1, 0, 1} labels in
# the p slot, probabilities in the g slot, so a -1 label makes rows 4-5 and
# dp NaN, in the plain version as in the JAX package), C = 11, a ragged
# tail, 1024 px, and the spatial sequential step's per-shard call (512 px,
# batch 8, the first of 2 row blocks).
LOSS_SUMS_SHAPES = [
    (128, 256, 256, 3, False),
    (128, 256, 256, 1, False),
    (128, 256, 256, 1, True),
    (32, 256, 256, 11, False),
    (3, 97, 101, 3, False),
    (8, 1024, 1024, 3, False),
    (8, 256, 512, 3, False),
]
# Augmentation on the card against the CPU (bf16): every value within 2 bf16
# ulps, except on at most 1% of the pixels (a rounding difference moved the
# pixel across a CLAHE bin or a hue sector), which stay within 1/16.
AUG_ULPS, AUG_FLIP_FRAC, AUG_FLIP_MAX = 2, 0.01, 1 / 16
# The calls timed, each backward writing the gradient its path asks for:
# (index into LOSS_SUMS_SHAPES, "dp" or "dg").  The sequential step's C = 3
# call and its C = 1 cross term (the probabilities' difference in the p
# slot) ask for dp, the single-organ call (probabilities in the g slot) for
# dg, the per-shard call for dp.
LOSS_SUMS_TIMED = [(0, "dp"), (1, "dp"), (2, "dg"), (6, "dp")]
SUM_RTOL = 1e-4     # 8.4 M-term f32 sums, summed in another order
GRAD_RTOL = 1e-4    # of the largest gradient: the max-scaled check --mutants prints beside
# Loss-sums gradients, element by element: |got - want| <= atol + rtol |want|.
# Both sides take the same f32 operations on each element; the kernel
# contracts products into FMAs, a few ulps, and where the row terms cancel
# each other to near 0 their ~1e-6 absolute rounding stays under the atol.
LS_GRAD_RTOL, LS_GRAD_ATOL = 1e-4, 1e-5
STEP_RTOL = 3e-2    # bf16 autocast on the card against the f32 step on the CPU


# Kernels that must not spill registers: the main paths' channel counts.
# The tiled-CLAHE kernel takes K at run time: one entry serves K = 64.
NO_SPILL = ("head_fwd_kernel<3>", "head_bwd_kernel<3>", "loss_sums_fwd_kernel<1>",
            "loss_sums_fwd_kernel<3>", "loss_sums_bwd_kernel<1>", "loss_sums_bwd_kernel<3>",
            "clahe_apply_kernel")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "Used N registers, ... smem; S bytes spill stores, L bytes
    spill loads") pairs from nvcc's -Xptxas -v log, the kernel named by its
    function and template argument."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+(loss_sums_fwd_kernel|loss_sums_bwd_kernel|head_fwd_kernel|"
                             r"head_bwd_kernel|clahe_apply_kernel)"
                             r"(?:ILi(\d+)E)?", m.group(1))
            entry = f"{name.group(1)}<{name.group(2)}>" if name and name.group(2) else (
                name.group(1) if name else m.group(1))
            spill = ""
        elif entry and "spill stores" in line:
            spill = "; " + ", ".join(part.strip() for part in line.split(",")[1:])
        elif entry and "Used" in line:
            out.append((entry, "Used " + line.split("Used", 1)[1].strip() + spill))
            entry = None
    return out


def _spills(usage: str) -> int:
    """Bytes of spill stores and loads in a :func:`_ptxas_usage` entry."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", usage))


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_host_ms(fn, iters: int = 20) -> float:
    """Host wall time to enqueue one call of ``fn`` (the card idle and
    synchronized before and after): where it is not below :func:`_time_ms`,
    that time is the host's dispatch rate and the kernel's own is less."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def _time_graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``, free of host dispatch: ``iters``
    calls captured in one CUDA graph, its replays timed with events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and cached buffers outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (5 * iters)


def _head_inputs(shape, gen):
    import torch

    B, h, w, H, W, C, _ = shape
    logits = torch.randn((B, h, w, C), generator=gen, device="cuda") * 3.0
    labels = (torch.rand((B, H, W, C), generator=gen, device="cuda") > 0.5).float()
    labels[torch.rand((B, H, W, C), generator=gen, device="cuda") < 0.05] = -1.0
    cot = torch.randn((8, C), generator=gen, device="cuda")
    return logits, labels.to(torch.bfloat16), cot


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _time_cold_ms(fn, iters: int = 10) -> float:
    """Mean time of ``fn`` over ``iters`` launches, each after a 256 MiB
    write (more than the card's 50 MB L2) outside its timing events, so it
    reads its inputs from device memory.  The write outlasts the host's
    enqueueing of ``fn``, so the card does not wait for the host in between."""
    import torch

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    fn()
    events = []
    for _ in range(iters):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _head_grad_ok(dx, dref64) -> tuple[bool, float]:
    """dlogits element by element against the plain version in float64:
    ``|got - want| <= SHARD_GRAD_RTOL |want| + SHARD_GRAD_ATOL max |want|``."""
    return _close(dx.double(), dref64, SHARD_GRAD_RTOL,
                  SHARD_GRAD_ATOL * dref64.abs().max().item())


def check_kernels(card: str) -> dict:
    """Phase 3: the head-loss kernels against their plain versions at every
    shape: the sums against the f32 plain version, the count row exactly,
    dlogits element by element against the plain version in float64 (the
    kernel forms 1 - p without cancellation; in f32 the plain version rounds
    it away where p nears 1); each kernel launched twice on the same
    inputs, bitwise equal.
    Times at ``TIMED``, and a cold time beside the warm one at the main
    shape."""
    import torch

    from ecologysemanticsegmentation_torch.ops import head_loss as hl

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for shape in SHAPES:
        B, h, w, H, W, C, ac = shape
        logits, labels, cot = _head_inputs(shape, gen)
        sums = hl.head_sums_cuda(logits, labels, ac)
        dx = hl.head_sums_bwd_cuda(logits, labels, cot, ac)
        same = (torch.equal(hl.head_sums_cuda(logits, labels, ac), sums)
                and torch.equal(hl.head_sums_bwd_cuda(logits, labels, cot, ac), dx))
        ref = hl.head_sums_reference(logits, labels, ac)
        dref = hl.head_sums_bwd_reference(logits.double(), labels, cot.double(), ac)
        err32 = (dx - hl.head_sums_bwd_reference(logits, labels, cot, ac)).abs().max().item()
        torch.cuda.synchronize()
        fwd_ok, fwd_err = _close(sums, ref, SUM_RTOL, 1e-3)
        bwd_ok, bwd_err = _head_grad_ok(dx, dref)
        exact_count = bool((sums[7] == (labels >= 0).sum((0, 1, 2)).float()).all())
        print(f"kernel check {shape}: fwd max_abs_err {fwd_err:.6g} (max |sum| "
              f"{ref.abs().max().item():.6g}), bwd max_abs_err {bwd_err:.6g} against float64 "
              f"(elementwise rtol {SHARD_GRAD_RTOL}, atol {SHARD_GRAD_ATOL} of max |dlogits| "
              f"{dref.abs().max().item():.6g}; {err32:.6g} against the f32 plain version), "
              f"count row exact {exact_count}, repeat launches bitwise equal {same}", flush=True)
        if not (fwd_ok and bwd_ok and exact_count and same and torch.isfinite(dx).all()):
            raise AssertionError(f"head-loss kernel disagrees with its plain version at {shape}")
        del dref
        if shape not in TIMED:
            continue
        elems = B * H * W * C
        in_bytes = labels.numel() * 2 + logits.numel() * 4
        fwd_ms = _time_ms(lambda: hl.head_sums_cuda(logits, labels, ac))
        fwd_plain = _time_ms(lambda: hl.head_sums_reference(logits, labels, ac), iters=5)
        bwd_ms = _time_ms(lambda: hl.head_sums_bwd_cuda(logits, labels, cot, ac))
        bwd_plain = _time_ms(lambda: hl.head_sums_bwd_reference(logits, labels, cot, ac), iters=5)
        fb, fby = _bound(in_bytes + 8 * C * 4, elems * FWD_OPS_PER_ELEM)
        bb, bby = _bound(in_bytes + 8 * C * 4 + logits.numel() * 4, elems * BWD_OPS_PER_ELEM)
        print(f"kernel times at {shape} [{card}]: fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, "
              f"bound {fb:.4f} by {fby}), bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, "
              f"bound {bb:.4f} by {bby})", flush=True)
        if shape != SHAPES[0]:
            continue
        fwd_cold = _time_cold_ms(lambda: hl.head_sums_cuda(logits, labels, ac))
        bwd_cold = _time_cold_ms(lambda: hl.head_sums_bwd_cuda(logits, labels, cot, ac))
        print(f"kernel cold times at {shape} [{card}] (L2 flushed by a 256 MiB write before "
              f"each launch): fwd {fwd_cold:.4f} ms (warm {fwd_ms:.4f}), bwd {bwd_cold:.4f} ms "
              f"(warm {bwd_ms:.4f})", flush=True)
        src = "ecologysemanticsegmentation_torch/ops/csrc/head_loss.cu"
        tpu = "ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py"
        report["head_loss_fwd"] = dict(
            name="head_loss_fwd", route="cuda", source=src, replaces=f"{tpu}:122",
            max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
            library_ms=None)
        report["head_loss_bwd"] = dict(
            name="head_loss_bwd", route="cuda", source=src, replaces=f"{tpu}:143",
            max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
            library_ms=None)
    return report


# The per-shard head loss (B, h, w, H, W, C): the 512 px spatial step's
# shard shapes (batch 8 per data rank, 128 -> 512 rows), at C = 3 (the main
# path's), 1 and 11; every row block of n = 2 (256 rows each) and n = 4.
SHARD_SHAPES = [(8, 128, 128, 512, 512, 3), (8, 128, 128, 512, 512, 1),
                (8, 128, 128, 512, 512, 11)]
SHARD_SPLITS = (2, 4)
# dlogits element by element, unsharded and per shard, against the plain
# version in float64: |got - want| <= SHARD_GRAD_RTOL |want| +
# SHARD_GRAD_ATOL max |want|.  Each dlogit sums up to ~64 f32 terms of
# bounded size (sigma' caps every dp term), so reordering them and the
# kernel's approximate exp, log and reciprocal (~1e-7 relative) move it by
# ~1e-6 of the largest |dlogit|; the relative part covers the rest.
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 1e-4, 1e-5


def check_shard_kernels(card: str) -> dict:
    """Phase 3: the per-shard head loss (the kernels launched with a row
    block's tables) against its plain version on every row block of n = 2
    and n = 4 (dlogits against it in float64), each block's kernels
    launched twice and bitwise equal; the blocks' sums and dlogits added
    together against the unsharded kernel's.  Time, plain time and bound at the main path's
    block (C = 3, n = 2, first block)."""
    import torch

    from ecologysemanticsegmentation_torch.ops import head_loss as hl

    gen = torch.Generator(device="cuda").manual_seed(8)
    report = {}
    for B, h, w, H, W, C in SHARD_SHAPES:
        logits, labels, cot = _head_inputs((B, h, w, H, W, C, True), gen)
        full = hl.head_sums_cuda(logits, labels)
        dfull = hl.head_sums_bwd_cuda(logits, labels, cot)
        for n in SHARD_SPLITS:
            rows = H // n
            total, dtotal, worst, dworst = 0.0, 0.0, 0.0, 0.0
            for k in range(n):
                block = labels[:, k * rows:(k + 1) * rows].contiguous()
                sums = hl.head_sums_shard_cuda(logits, block, H, k * rows)
                ref = hl.head_sums_shard_reference(logits, block, H, k * rows)
                dx = hl.head_sums_shard_bwd_cuda(logits, block, cot, H, k * rows)
                dref = hl.head_sums_shard_bwd_reference(logits.double(), block, cot.double(), H,
                                                        k * rows)
                same = (torch.equal(hl.head_sums_shard_cuda(logits, block, H, k * rows), sums)
                        and torch.equal(hl.head_sums_shard_bwd_cuda(logits, block, cot, H,
                                                                    k * rows), dx))
                torch.cuda.synchronize()
                fwd_ok, fwd_err = _close(sums, ref, SUM_RTOL, 1e-3)
                bwd_ok, bwd_err = _head_grad_ok(dx, dref)
                exact = bool((sums[7] == (block >= 0).sum((0, 1, 2)).float()).all())
                if not (fwd_ok and bwd_ok and exact and same and torch.isfinite(dx).all()):
                    raise AssertionError(
                        f"per-shard head loss disagrees with its plain version at "
                        f"{(B, h, w, H, W, C)}, block {k} of {n}: sums err {fwd_err:.6g}, "
                        f"dlogits err {bwd_err:.6g}, count exact {exact}, repeat equal {same}")
                worst, dworst = max(worst, fwd_err), max(dworst, bwd_err)
                total, dtotal = total + sums, dtotal + dx
            sum_ok, sum_err = _close(total, full, SUM_RTOL, 1e-3)
            grad_ok, grad_err = _close(dtotal, dfull, SHARD_GRAD_RTOL,
                                       SHARD_GRAD_ATOL * dfull.abs().max().item())
            print(f"kernel check head_loss_shard {(B, h, w, H, W, C)} n={n}: sums max_abs_err "
                  f"{worst:.6g} (max |sum| {full.abs().max().item():.6g}), dlogits max_abs_err "
                  f"{dworst:.6g} (max |dlogits| {dfull.abs().max().item():.6g}; elementwise "
                  f"rtol {SHARD_GRAD_RTOL}, atol {SHARD_GRAD_ATOL} of max, against float64), count "
                  f"rows exact, repeat launches bitwise equal; "
                  f"blocks summed vs unsharded kernel: sums {sum_err:.6g}, dlogits "
                  f"{grad_err:.6g}", flush=True)
            if not (sum_ok and grad_ok and torch.equal(total[7], full[7])):
                raise AssertionError(f"the {n} blocks' sums or dlogits do not add up to the "
                                     f"unsharded kernel's at {(B, h, w, H, W, C)}")
            if (C, n) != (3, 2):
                continue
            rows = H // n
            block = labels[:, :rows].contiguous()
            fwd_ms = _time_ms(lambda: hl.head_sums_shard_cuda(logits, block, H, 0))
            fwd_plain = _time_ms(lambda: hl.head_sums_shard_reference(logits, block, H, 0),
                                 iters=5)
            bwd_ms = _time_ms(lambda: hl.head_sums_shard_bwd_cuda(logits, block, cot, H, 0))
            bwd_plain = _time_ms(
                lambda: hl.head_sums_shard_bwd_reference(logits, block, cot, H, 0), iters=5)
            elems = B * rows * W * C
            # bytes: the label block and the logit rows its row taps reach
            # (not all h), read once; the sums or cotangent; in the backward
            # the whole dlogits written (rows no tap reaches are zeros)
            y_idx = hl._tables(H, h, True, logits.device, 0, rows)[0]
            tap_rows = int(y_idx.max().item()) - int(y_idx.min().item()) + 1
            in_bytes = block.numel() * 2 + B * tap_rows * w * C * 4
            fb, fby = _bound(in_bytes + 8 * C * 4, elems * FWD_OPS_PER_ELEM)
            bb, bby = _bound(in_bytes + 8 * C * 4 + logits.numel() * 4, elems * BWD_OPS_PER_ELEM)
            print(f"kernel times head_loss_shard at {(B, h, w, rows, W, C)} of H={H} [{card}]: "
                  f"fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, bound {fb:.4f} by {fby}), bwd "
                  f"{bwd_ms:.4f} ms (plain {bwd_plain:.4f}, bound {bb:.4f} by {bby}); bounds "
                  f"count {tap_rows} of {h} logit rows read", flush=True)
            src = "ecologysemanticsegmentation_torch/ops/csrc/head_loss.cu"
            tpu = "ecologysemanticsegmentation_tpu/ops/pallas/head_loss.py"
            report["head_loss_shard_fwd"] = dict(
                name="head_loss_shard_fwd", route="cuda", source=src, replaces=f"{tpu}:358",
                max_abs_err=worst, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
                library_ms=None)
            report["head_loss_shard_bwd"] = dict(
                name="head_loss_shard_bwd", route="cuda", source=src, replaces=f"{tpu}:382",
                max_abs_err=dworst, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                library_ms=None)
    return report


def _clahe_inputs(shape, gen):
    """Luminance in [0, 1] with every 97th pixel set, in turn, to 0, exactly
    1, just above 1, above the last bin by more than a bin (1.1, whose
    unclamped bin stays inside the kernel's shared memory), just below 0,
    NaN and the bin edges k / (K - 1); per-tile CDF steps of random
    histograms."""
    import torch

    B, H, W, T, K = shape
    luma = torch.rand((B, H, W), generator=gen, device="cuda")
    edges = torch.tensor([0.0, 1.0, 1 + 1e-3, 1.1, -1e-3, math.nan]
                         + [k / (K - 1) for k in range(K)], device="cuda")
    flat = luma.view(-1)
    n = flat[::97].numel()
    flat[::97] = edges.repeat(-(-n // edges.numel()))[:n]
    hist = torch.rand((B, T, T, K), generator=gen, device="cuda") + 0.1
    cdf = torch.cumsum(hist, -1)
    cdf = cdf / cdf[..., -1:]
    return luma, torch.diff(cdf, dim=-1, prepend=torch.zeros_like(cdf[..., :1]))


def _clahe_ok(ct, luma, deltas, T, want) -> tuple[bool, float]:
    """Phase 3's check of the tiled-CLAHE kernel: every value within
    ``CLAHE_ATOL`` of the plain version's (NaN fails), and a second launch
    bitwise equal to the first."""
    import torch

    got = ct.tiled_clahe_new_luma(luma, deltas, T)
    again = ct.tiled_clahe_new_luma(luma, deltas, T)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    return bool(err <= CLAHE_ATOL and torch.equal(got, again)), err


def _parent_route(ct) -> bool:
    """Whether module ``ct`` (another tree's) applies the tiled CLAHE through
    an x-contracted Gx plane: ``apply_cuda(luma, gx, tiles)``."""
    import inspect

    return "gx" in inspect.signature(ct.apply_cuda).parameters


def time_clahe(ct, card: str, variants: bool = False) -> dict:
    """Times of module ``ct``'s (this tree's, or another tree's: the
    function keeps its signature) ``tiled_clahe_new_luma`` at the main
    path's shape, as the augmentation calls it: warm, cold (after a write
    larger than the L2), the host's enqueue time and the device time in a
    CUDA graph.  A tree that goes through Gx also has its einsum and its
    kernel timed alone.  With ``variants``, this tree's kernel is also built
    and timed as each of ``CLAHE_VARIANTS``, beside a plain copy of the
    same luminance (``clone``: the bytes read and written, no work).  Then the
    device time (in a CUDA graph) of the augmentation's whole tiled and
    global CLAHE ops on a bf16 batch of that shape."""
    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    B, H, W, T, K = CLAHE_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(13)
    luma, deltas = _clahe_inputs(CLAHE_SHAPES[0], gen)
    tree = Path(ct.__file__).parents[2].name

    def fn():
        return ct.tiled_clahe_new_luma(luma, deltas, T)

    t = {"ms": _time_ms(fn), "cold": _time_cold_ms(fn), "host": _time_host_ms(fn),
         "graph": _time_graph_ms(fn)}
    print(f"clahe_tiled times at {CLAHE_SHAPES[0]} [{card}] ({tree}): the function "
          f"{t['ms']:.4f} ms warm, {t['cold']:.4f} cold (L2 flushed by a 256 MiB write before "
          f"each call), host enqueue {t['host']:.4f}, in a CUDA graph {t['graph']:.4f}",
          flush=True)
    if _parent_route(ct):
        wx = ct._weights(W, T, luma.device)
        gx = torch.einsum("btsk,xs->bktx", deltas, wx)
        t["einsum"] = _time_ms(lambda: torch.einsum("btsk,xs->bktx", deltas, wx))
        t["einsum_graph"] = _time_graph_ms(lambda: torch.einsum("btsk,xs->bktx", deltas, wx))
        t["kernel"] = _time_ms(lambda: ct.apply_cuda(luma, gx, T))
        t["kernel_graph"] = _time_graph_ms(lambda: ct.apply_cuda(luma, gx, T))
        t["kernel_cold"] = _time_cold_ms(lambda: ct.apply_cuda(luma, gx, T))
        print(f"clahe_tiled times at {CLAHE_SHAPES[0]} [{card}] ({tree}): its Gx einsum "
              f"{t['einsum']:.4f} ms warm (in a CUDA graph {t['einsum_graph']:.4f}), its kernel "
              f"on Gx {t['kernel']:.4f} warm, {t['kernel_cold']:.4f} cold (in a CUDA graph "
              f"{t['kernel_graph']:.4f})", flush=True)
        del gx
    if variants:
        from ecologysemanticsegmentation_torch.ops import _build

        libs = _load_mutants(_start_mutants("clahe_tiled", CLAHE_VARIANTS), ct._SIGNATURES)
        saved = _build._loaded.get("clahe_tiled")
        try:
            for what, cdll in libs:
                _build._loaded["clahe_tiled"] = cdll
                t[what] = _time_graph_ms(fn)
                print(f"clahe_tiled kernel variant at {CLAHE_SHAPES[0]} [{card}]: {what} "
                      f"{_time_ms(fn):.4f} ms warm, in a CUDA graph {t[what]:.4f}", flush=True)
        finally:
            _build._loaded["clahe_tiled"] = saved
        t["clone"] = _time_graph_ms(lambda: luma.clone())
        print(f"a plain copy of the luminance (clone) at {CLAHE_SHAPES[0]} [{card}]: "
              f"{_time_ms(lambda: luma.clone()):.4f} ms warm, in a CUDA graph "
              f"{t['clone']:.4f}", flush=True)
    x = torch.rand((B, H, W, 3), generator=gen, device="cuda").to(torch.bfloat16)
    clip = torch.rand((B,), generator=gen, device="cuda") * 3.0 + 1.0
    t["op_tiled"] = _time_graph_ms(lambda: aug._clahe_tiled(x, clip))
    t["op_global"] = _time_graph_ms(lambda: aug._clahe(x, clip))
    print(f"clahe ops at {(B, H, W, 3)} bf16 [{card}] ({tree}), device time in a CUDA graph: "
          f"tiled (histograms, clip, CDF, apply, scale) {t['op_tiled']:.4f} ms, global "
          f"{t['op_global']:.4f} ms", flush=True)
    return t


def check_clahe(card: str) -> dict:
    """Phase 3: the tiled-CLAHE function on the card (one kernel launch from
    the deltas) against its plain version (the x contraction, then the
    gated per-bin planes) at every shape, with edge luminances, a second
    launch bitwise equal; at the main path's shape its times
    (:func:`time_clahe`), the plain version's and the function's byte
    bound."""
    import torch

    from ecologysemanticsegmentation_torch.ops import clahe_tiled as ct

    gen = torch.Generator(device="cuda").manual_seed(5)
    report = {}
    for shape in CLAHE_SHAPES:
        B, H, W, T, K = shape
        luma, deltas = _clahe_inputs(shape, gen)
        want = ct.reference(luma, deltas, T)
        ok, err = _clahe_ok(ct, luma, deltas, T, want)
        print(f"kernel check clahe_tiled {shape} (launch plan: {ct._plan(B, H, T, K)} rows per "
              f"band and tile rows): max_abs_err {err:.6g} (max |out| "
              f"{want.abs().max().item():.6g}, atol {CLAHE_ATOL}), repeat launches bitwise "
              f"equal", flush=True)
        if not ok:
            raise AssertionError(f"tiled-CLAHE kernel disagrees with its plain version at {shape}, "
                                 f"or a repeat launch differs")
        if shape != CLAHE_SHAPES[0]:
            continue
        plain_ms = _time_ms(lambda: ct.reference(luma, deltas, T), iters=5)
        del want
        t = time_clahe(ct, card)
        # bytes: luma in, the deltas in, out, and the two axes' tap tables;
        # beside it the bound of the JAX package's kernel operands (luma, Gx, out)
        nbytes = (2 * luma.numel() + deltas.numel() + 4 * (H + W)) * 4
        bound, by = _bound(nbytes, B * H * W * CLAHE_OPS_PER_PIXEL)
        gx_bound, _ = _bound((2 * luma.numel() + B * K * T * W) * 4, 0)
        report["clahe_tiled"] = dict(
            name="clahe_tiled", route="cuda",
            source="ecologysemanticsegmentation_torch/ops/csrc/clahe_tiled.cu",
            replaces="ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py:109",
            max_abs_err=err, ms=t["ms"], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None)
        print(f"kernel times clahe_tiled at {shape} [{card}]: {t['ms']:.4f} ms (plain "
              f"{plain_ms:.4f}, bound {bound:.4f} by {by}; the bound of a kernel that reads a "
              f"Gx plane instead of the deltas: {gx_bound:.4f})", flush=True)
    return report


def _close(got, want, rtol: float, atol: float, nan_ok: bool = False) -> tuple[bool, float]:
    """Element by element, ``|got - want| <= atol + rtol |want|``; with
    ``nan_ok``, NaN on both sides at one place agrees (and NaN on one side
    only never does).  Returns the verdict and the largest error among the
    other elements."""
    import torch

    both_nan = torch.isnan(got) & torch.isnan(want) if nan_ok else torch.zeros_like(
        got, dtype=torch.bool)
    err = (got - want).abs()
    ok = bool(((err <= atol + rtol * want.abs()) | both_nan).all())
    rest = err[~both_nan]
    return ok, rest.max().item() if rest.numel() else 0.0


def _loss_sums_inputs(shape, gen):
    """(N, C) p and g and an (8, C) cotangent; labels with 5% -1 ignores."""
    import torch

    B, H, W, C, swapped = shape
    probs = torch.rand((B, H, W, C), generator=gen, device="cuda")
    labels = (torch.rand((B, H, W, C), generator=gen, device="cuda") > 0.5).float()
    labels[torch.rand((B, H, W, C), generator=gen, device="cuda") < 0.05] = -1.0
    cot = torch.randn((8, C), generator=gen, device="cuda")
    p, g = (labels, probs) if swapped else (probs, labels)
    return p.reshape(-1, C), g.reshape(-1, C), cot


def _loss_sums_grads_ok(dp, dg, dp_ref, dg_ref, nan_ok: bool) -> tuple[bool, float, float]:
    """Phase 3's gradient check: dp and dg element by element at
    ``LS_GRAD_RTOL``/``LS_GRAD_ATOL``; dg always finite."""
    import torch

    dp_ok, dp_err = _close(dp, dp_ref, LS_GRAD_RTOL, LS_GRAD_ATOL, nan_ok)
    dg_ok, dg_err = _close(dg, dg_ref, LS_GRAD_RTOL, LS_GRAD_ATOL)
    return dp_ok and dg_ok and bool(torch.isfinite(dg).all()), dp_err, dg_err


def _bitwise_equal(a, b) -> bool:
    """Equal bit for bit, NaN included."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def time_loss_sums(ls, card: str) -> dict:
    """Warm times of the loss-sums kernels of module ``ls`` (this tree's, or
    another tree's: the wrappers keep their signatures) at every
    ``LOSS_SUMS_TIMED`` call, each backward writing the gradient its path
    asks for; beside them the host's enqueue time per call and the device
    time in a CUDA graph (free of host dispatch), and cold times (after a
    write larger than the L2) at the main shape.  Returns {shape: {"fwd",
    "bwd", "grad", "fwd_host", "bwd_host", "fwd_graph", "bwd_graph"[,
    "fwd_cold", "bwd_cold"]}}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    times = {}
    for idx, grad in LOSS_SUMS_TIMED:
        shape = LOSS_SUMS_SHAPES[idx]
        p2, g2, cot = _loss_sums_inputs(shape, gen)
        need_dp = grad == "dp"

        def fwd():
            return ls.loss_sums_cuda(p2, g2)

        def bwd():
            return ls.loss_sums_bwd_cuda(p2, g2, cot, need_dp, not need_dp)

        t = {"fwd": _time_ms(fwd), "bwd": _time_ms(bwd), "grad": grad}
        for k, fn in (("fwd", fwd), ("bwd", bwd)):
            t[k + "_host"], t[k + "_graph"] = _time_host_ms(fn), _time_graph_ms(fn)
        cold = ""
        if idx == 0:
            t["fwd_cold"], t["bwd_cold"] = _time_cold_ms(fwd), _time_cold_ms(bwd)
            cold = (f"; cold (L2 flushed by a 256 MiB write before each launch, whose dirty "
                    f"lines the call then writes back): fwd {t['fwd_cold']:.4f} ms, bwd "
                    f"{t['bwd_cold']:.4f} ms")
        times[shape] = t
        print(f"loss_sums times at {shape} [{card}] ({Path(ls.__file__).parents[2].name}): fwd "
              f"{t['fwd']:.4f} ms, bwd writing {grad} {t['bwd']:.4f} ms (host enqueue per call "
              f"{t['fwd_host']:.4f}, {t['bwd_host']:.4f}; in a CUDA graph {t['fwd_graph']:.4f}, "
              f"{t['bwd_graph']:.4f}){cold}", flush=True)
        del p2, g2, cot
    return times


def check_loss_sums(card: str) -> dict:
    """Phase 3: the loss-sums kernels against their plain versions at every
    shape, both gradients written and compared element by element, each
    kernel launched twice on the same inputs and bitwise equal (NaN
    included); times (:func:`time_loss_sums`), plain times and bounds at the
    ``LOSS_SUMS_TIMED`` calls.  In the swapped call rows 4-5 and dp must be
    NaN exactly where the plain version's are, and the other rows and dg
    finite and close."""
    import torch

    from ecologysemanticsegmentation_torch.ops import loss_sums as ls

    gen = torch.Generator(device="cuda").manual_seed(7)
    report, errs = {}, {}
    for shape in LOSS_SUMS_SHAPES:
        B, H, W, C, swapped = shape
        p2, g2, cot = _loss_sums_inputs(shape, gen)
        sums = ls.loss_sums_cuda(p2, g2)
        ref = ls._sums_reference(p2.T, g2.T)
        dp, dg = ls.loss_sums_bwd_cuda(p2, g2, cot)
        dp1 = ls.loss_sums_bwd_cuda(p2, g2, cot, True, False)[0]
        dg1 = ls.loss_sums_bwd_cuda(p2, g2, cot, False, True)[1]
        same = (_bitwise_equal(ls.loss_sums_cuda(p2, g2), sums)
                and _bitwise_equal(dp1, dp) and _bitwise_equal(dg1, dg))
        dp_ref, dg_ref = ls.loss_sums_bwd_reference(p2.T, g2.T, cot)
        dp_ref, dg_ref = dp_ref.T, dg_ref.T
        torch.cuda.synchronize()
        fwd_ok, fwd_err = _close(sums, ref, SUM_RTOL, 1e-3, nan_ok=swapped)
        bwd_ok, dp_err, dg_err = _loss_sums_grads_ok(dp, dg, dp_ref, dg_ref, nan_ok=swapped)
        exact_count = bool((sums[7] == (g2 >= 0).sum(0).float()).all())
        finite = torch.isfinite(sums).all(1)
        # a -1 label in the p slot is NaN in rows 4-5 and there only
        nan_rows = (bool(torch.isnan(ref[4:6]).all() and torch.isnan(dp_ref).any()
                         and finite[[0, 1, 2, 3, 6, 7]].all()) if swapped
                    else bool(finite.all() and torch.isfinite(dp).all()))
        path = ("flat stream" if ls._vector_path(p2, g2, p2.stride(0), g2.stride(0))
                else "pixel stride")
        print(f"kernel check loss_sums {shape} ({path}): fwd max_abs_err {fwd_err:.6g} (max |sum| "
              f"{ref.nan_to_num().abs().max().item():.6g}), dp max_abs_err {dp_err:.6g} (max "
              f"|dp| {dp_ref.nan_to_num().abs().max().item():.6g}), dg max_abs_err {dg_err:.6g} "
              f"(max |dg| {dg_ref.abs().max().item():.6g}), elementwise rtol {LS_GRAD_RTOL} atol "
              f"{LS_GRAD_ATOL}, count row exact {exact_count}, "
              f"{'NaN as the plain version' if swapped else 'finite'} {nan_rows}, repeat "
              f"launches bitwise equal {same}", flush=True)
        if not (fwd_ok and bwd_ok and exact_count and nan_rows and same):
            raise AssertionError(f"loss-sums kernels disagree with their plain versions at {shape}")
        errs[shape] = (fwd_err, dp_err, dg_err)
        del p2, g2, cot, dp, dg, dp1, dg1, dp_ref, dg_ref

    times = time_loss_sums(ls, card)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for idx, grad in LOSS_SUMS_TIMED:
        shape = LOSS_SUMS_SHAPES[idx]
        B, H, W, C, _ = shape
        p2, g2, cot = _loss_sums_inputs(shape, gen)
        elems = B * H * W * C
        fwd_plain = _time_ms(lambda: ls._sums_reference(p2.T, g2.T), iters=5)
        bwd_plain = _time_ms(lambda: ls.loss_sums_bwd_reference(p2.T, g2.T, cot), iters=5)
        # bytes: p and g read once, the (8, C) sums or cotangent, one gradient written
        fb, fby = _bound(8 * elems + 8 * C * 4, elems * LS_FWD_OPS_PER_ELEM)
        bb, bby = _bound(12 * elems + 8 * C * 4,
                         elems * (LS_DP_OPS_PER_ELEM if grad == "dp" else LS_DG_OPS_PER_ELEM))
        t = times[shape]
        print(f"kernel times loss_sums at {shape} [{card}]: fwd {t['fwd']:.4f} ms (plain "
              f"{fwd_plain:.4f}, bound {fb:.4f} by {fby}), bwd writing {grad} {t['bwd']:.4f} ms "
              f"(plain {bwd_plain:.4f}, both gradients; bound {bb:.4f} by {bby})", flush=True)
        del p2, g2, cot
        if idx != 0:
            continue
        src = "ecologysemanticsegmentation_torch/ops/csrc/loss_sums.cu"
        tpu = "ecologysemanticsegmentation_tpu/ops/pallas/loss_sums.py"
        report["loss_sums_fwd"] = dict(
            name="loss_sums_fwd", route="cuda", source=src, replaces=f"{tpu}:73",
            max_abs_err=errs[shape][0], ms=t["fwd"], plain_ms=fwd_plain, bound_ms=fb,
            bound_by=fby, library_ms=None)
        report["loss_sums_bwd"] = dict(
            name="loss_sums_bwd", route="cuda", source=src, replaces=f"{tpu}:102",
            max_abs_err=errs[shape][1], ms=t["bwd"], plain_ms=bwd_plain, bound_ms=bb,
            bound_by=bby, library_ms=None)
    return report


# Broken copies of the loss-sums backward, each one term wrong: (name, the
# kernel's text, its replacement).
LOSS_SUMS_MUTANTS = [
    ("dp drops row 1", "float d = fmaf(cf(2, s), p, cf(1, s));", "float d = cf(2, s) * p;"),
    ("dp drops row 6", "d = fmaf(cf(8, s), p > 0.f ? sigmoid01(p) : 0.f, d);", ""),
    ("dp flips the sign of row 6's softplus part", "p > 0.f ? sigmoid01(p) : 0.f",
     "p > 0.f ? 2.f - sigmoid01(p) : 0.f"),
    ("dp flips the sign of row 4's log part", "case 5: return -kGammaLn2 * k[4 * C + c];",
     "case 5: return kGammaLn2 * k[4 * C + c];"),
    ("dg drops row 3", "return fmaf(cf(3, s), p, cf(0, s)) * (graw", "return cf(0, s) * (graw"),
    ("the pixel-stride path writes each channel's dp to the next channel",
     "if (want_dp) dp[i * C + c] = dp_elem(pv, graw, cw, c);",
     "if (want_dp) dp[i * C + (c + 1) % C] = dp_elem(pv, graw, cw, c);"),
]


# Broken copies of the head-loss backward: (name, the kernel's text, its
# replacement).
HEAD_LOSS_MUTANTS = [
    ("a band drops the output row it shares with the band before",
     "const int ya = __ldg(rband + rb), yb", "const int ya = __ldg(rband + rb) + (rb > 0), yb"),
    ("the column contraction drops the hi tap",
     "for (int xl = b0; xl < b1; ++xl) {", "for (int xl = b0; xl < b0; ++xl) {"),
]


# Broken copies of the tiled-CLAHE kernel: (name, the kernel's text, its
# replacement).  The clamp's mutant reads bins past K - 1 only at the edge
# luminance 1.1 (:func:`_clahe_inputs`), whose bin stays inside the block's
# shared memory.
CLAHE_MUTANTS = [
    ("the x interpolation drops the hi tap",
     "return wx_lo * p.x + wx_hi * p.y;", "return wx_lo * p.x;"),
    ("the prefix over K is exclusive", "v += carry;", "v += carry - own;"),
    ("j is not clamped at K - 1", "(int)fminf(fmaxf(idx, 0.f), top)", "(int)fmaxf(idx, 0.f)"),
    ("the gate for l < 0 and NaN is gone", "return idx >= 0.f ? v : 0.f;", "return v;"),
]
# Variants of the tiled-CLAHE kernel that --clahe-times times beside it:
# the other LUT layout ([tile][j], K pairs a tile, for the kernel's [j][tile]
# with an odd stride), and the stream alone (each pixel's lookups replaced
# by its luminance: the same loads, stores and launch plan).
CLAHE_VARIANTS = [
    ("LUT layout [tile][j]", "return j * sj + ts;", "return ts * K + j;"),
    ("the stream alone, no lookups",
     "        r.x = pixel(lut, l.x, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.x, wh.x);\n"
     "        r.y = pixel(lut, l.y, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.y, wh.y);\n"
     "        r.z = pixel(lut, l.z, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.z, wh.z);\n"
     "        r.w = pixel(lut, l.w, top, K, sj, row_lo, row_hi, wy_lo, wy_hi, sl.w, wh.w);\n",
     "        r = l;\n        (void)sl, (void)wh;\n"),
]


def _start_mutants(name: str, mutants: list) -> list:
    """Write the kernel as written and every mutant of ``csrc/<name>.cu``
    under ``ops/build/mutants/`` and start one nvcc for each."""
    from ecologysemanticsegmentation_torch.ops import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    out_dir = _build.BUILD_DIR / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (what, old, new) in enumerate([("as written", "", "")] + mutants):
        if old and text.count(old) != 1:
            raise AssertionError(f"mutant {what!r}: its text is not in {name}.cu exactly once")
        src, lib = out_dir / f"{name}_{i}.cu", out_dir / f"lib{name}_{i}.so"
        src.write_text(text.replace(old, new) if old else text)
        procs.append((what, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _load_mutants(procs: list, signatures: dict) -> list:
    import ctypes

    libs = []
    for what, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"mutant {what!r} did not build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in signatures.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs.append((what, cdll))
    return libs


def _judge_mutants(name: str, libs: list, run) -> None:
    """Load each library as ``name`` in turn; ``run()`` gives the
    element-wise and the max-scaled verdicts.  The element-wise check must
    pass the kernel as written and refuse every mutant."""
    from ecologysemanticsegmentation_torch.ops import _build

    saved = _build._loaded.get(name)
    try:
        for what, cdll in libs:
            _build._loaded[name] = cdll
            new_ok, old_ok = run()
            want = what == "as written"
            print(f"mutant check {name} ({what}): elementwise check "
                  f"{'passes' if new_ok else 'refuses'}, max-scaled check "
                  f"{'passes' if old_ok else 'refuses'}", flush=True)
            if new_ok != want:
                raise AssertionError(f"the {name} gradient check "
                                     f"{'refused' if want else 'passed'} the kernel {what}")
    finally:
        if saved is None:
            _build._loaded.pop(name, None)
        else:
            _build._loaded[name] = saved


def check_mutants() -> None:
    """Build every ``LOSS_SUMS_MUTANTS`` and ``HEAD_LOSS_MUTANTS`` copy of
    the kernel sources (one nvcc each, all together) and run phase 3's
    gradient checks on each: the loss sums at the sequential step's C = 3
    and swapped C = 1 calls and at a ragged tail (read through the pixel
    stride), the head loss unsharded (batch 16 at the main
    path's 64 -> 256 px, C = 3) and on the second row block of a 2-way
    split at 512 px.  The checks must pass the kernels as written and
    refuse every mutant.  The max-scaled check (an error of 1e-4 of the
    largest gradient allowed, against the f32 plain version) is printed
    beside."""
    import torch

    from ecologysemanticsegmentation_torch.ops import clahe_tiled as ct
    from ecologysemanticsegmentation_torch.ops import head_loss as hl
    from ecologysemanticsegmentation_torch.ops import loss_sums as ls

    ls_procs = _start_mutants("loss_sums", LOSS_SUMS_MUTANTS)
    hl_procs = _start_mutants("head_loss", HEAD_LOSS_MUTANTS)
    ct_procs = _start_mutants("clahe_tiled", CLAHE_MUTANTS)
    ls_libs = _load_mutants(ls_procs, ls._SIGNATURES)
    hl_libs = _load_mutants(hl_procs, hl._SIGNATURES)
    ct_libs = _load_mutants(ct_procs, ct._SIGNATURES)

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [_loss_sums_inputs(shape, gen) + (shape[4],)
             for shape in (LOSS_SUMS_SHAPES[0], LOSS_SUMS_SHAPES[2], LOSS_SUMS_SHAPES[4])]
    refs = [tuple(t.T for t in ls.loss_sums_bwd_reference(p.T, g.T, cot))
            for p, g, cot, _ in cases]

    def run_loss_sums():
        new_ok = old_ok = True
        for (p, g, cot, swapped), (dp_ref, dg_ref) in zip(cases, refs):
            dp, dg = ls.loss_sums_bwd_cuda(p, g, cot)
            torch.cuda.synchronize()
            new_ok &= _loss_sums_grads_ok(dp, dg, dp_ref, dg_ref, nan_ok=swapped)[0]
            fin = torch.isfinite(dp_ref)
            old_ok &= bool(
                (dp - dp_ref)[fin].abs().max() <= GRAD_RTOL * dp_ref[fin].abs().max()
                and (dg - dg_ref).abs().max() <= GRAD_RTOL * dg_ref.abs().max())
        return new_ok, old_ok

    _judge_mutants("loss_sums", ls_libs, run_loss_sums)

    gen = torch.Generator(device="cuda").manual_seed(9)
    head_cases = []
    for shape, block in (((16, 64, 64, 256, 256, 3, True), None),
                         ((8, 128, 128, 512, 512, 3, True), 1)):
        logits, labels, cot = _head_inputs(shape, gen)
        H = shape[3]
        row0 = 0 if block is None else block * (H // 2)
        if block is not None:
            labels = labels[:, row0:row0 + H // 2].contiguous()
        head_cases.append((logits, labels, cot, H, row0, block is not None,
                           hl.head_sums_shard_bwd_reference(logits.double(), labels,
                                                            cot.double(), H, row0),
                           hl.head_sums_shard_bwd_reference(logits, labels, cot, H, row0)))

    def run_head_loss():
        new_ok = old_ok = True
        for logits, labels, cot, H, row0, shard, dref64, dref32 in head_cases:
            dx = (hl.head_sums_shard_bwd_cuda(logits, labels, cot, H, row0) if shard
                  else hl.head_sums_bwd_cuda(logits, labels, cot))
            torch.cuda.synchronize()
            new_ok &= _head_grad_ok(dx, dref64)[0]
            old_ok &= bool((dx - dref32).abs().max() <= GRAD_RTOL * dref32.abs().max())
        return new_ok, old_ok

    _judge_mutants("head_loss", hl_libs, run_head_loss)

    gen = torch.Generator(device="cuda").manual_seed(5)
    clahe_cases = []
    for shape in (CLAHE_SHAPES[0], CLAHE_SHAPES[-1]):
        luma, deltas = _clahe_inputs(shape, gen)
        clahe_cases.append((luma, deltas, shape[3], ct.reference(luma, deltas, shape[3])))

    def run_clahe():
        new_ok = old_ok = True
        for luma, deltas, T, want in clahe_cases:
            ok, err = _clahe_ok(ct, luma, deltas, T, want)
            new_ok &= ok
            old_ok &= bool(err <= GRAD_RTOL * want.abs().max().item())
        return new_ok, old_ok

    _judge_mutants("clahe_tiled", ct_libs, run_clahe)


def _bf16_ulp(v):
    import torch

    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def check_augment() -> None:
    """Phase 3: device augmentation on the card against the CPU, from the
    same draws (batch 8 at 64 px), in both CLAHE forms, over host seeds that
    together fire every OneOf branch and every warp mode."""
    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    b, img = 8, 64
    gen = torch.Generator().manual_seed(6)
    images = torch.rand((b, img, img, 3), generator=gen)
    masks = (torch.rand((b, img, img, 3), generator=gen) * 3).floor() - 1.0
    seen, cases = set(), []
    for seed in range(200):
        params = aug.draw_augment_params(torch.Generator().manual_seed(seed),
                                         torch.Generator().manual_seed(seed), b, img, img)
        warp = ("warp" if params["crop_gate"] or params["rot_gate"] else
                "flip" if params["flip_gate"] else "none")
        new = {params["blur_op"], params["color_op"], warp} - seen
        if new:
            seen |= new
            cases.append(params)
    want_seen = set(aug.BLUR_NAMES) | set(aug.COLOR_NAMES) | {"warp", "flip", "none"}
    if seen != want_seen:
        raise AssertionError(f"augment check covers {sorted(seen)}, not {sorted(want_seen)}")

    def to(value, device):
        if isinstance(value, dict):
            return {k: to(v, device) for k, v in value.items()}
        return value.to(device) if isinstance(value, torch.Tensor) else value

    worst = 0.0
    for tiled in (False, True):
        for params in cases:
            cpu = aug.apply_augment(images, masks, params, tiled_clahe=tiled)
            card = aug.apply_augment(images.cuda(), masks.cuda(), to(params, "cuda"),
                                     tiled_clahe=tiled)
            got, want = card[0].float().cpu(), cpu[0].float()
            err = (got - want).abs()
            flipped = (err > AUG_ULPS * _bf16_ulp(want)).any(-1).float().mean().item()
            if not (torch.equal(card[1].cpu(), cpu[1]) and flipped <= AUG_FLIP_FRAC
                    and err.max().item() <= AUG_FLIP_MAX and card[0].dtype == torch.bfloat16):
                raise AssertionError(
                    f"augmentation on the card disagrees with the CPU (tiled={tiled}, "
                    f"{params['blur_op']}, {params['color_op']}): {flipped:.4f} of pixels "
                    f"beyond {AUG_ULPS} ulps, max err {err.max().item():.4g}")
            worst = max(worst, err.max().item())
    print(f"augment check: card = CPU in {len(cases)} draws x 2 CLAHE forms (masks exact, "
          f"max err {worst:.4g}, branches {sorted(seen)})", flush=True)


def _batch(n: int, img: int, organs: int, device: str, seed: int, ignore: float = 0.05) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    image = torch.rand((n, img, img, 3), generator=gen)
    label = (torch.rand((n, img, img, organs), generator=gen) > 0.5).float()
    label[torch.rand(label.shape, generator=gen) < ignore] = -1.0
    return {"image": image.to(device), "label": label.to(device)}


# The small step's cases: (what, organs, composite_mode, lowres_head, label
# ignore rate, model dtype, rtol).  An f32 model runs as users run it, under
# bf16 autocast on the card, against the f32 step on the CPU (STEP_RTOL):
# the flagship and the single-organ step.  The sequential step is not held
# that way: at nearly equal initial organ probabilities its cross term's
# sums of |x1 - x2| turn bf16 rounding into 3-10% of its focal and
# focal_dice metrics, and so of its loss.  The float64 cases run
# autocast-free on both sides (autocast leaves float64 alone), so the loss
# sums, f32 in both, see the same probabilities and every metric is held at
# FULLRES_STEP_RTOL: the kernels and the loss plumbing on the card against
# the plain versions.  The single-organ step and the general composite's
# intersection terms put labels in the prediction slot of the sums, so a -1
# label makes their focal metric NaN, in the reference as well (their loss
# stays finite): a metric NaN on the CPU must be NaN on the card.
FULLRES_STEP_RTOL = 1e-4  # f32 sums of 8192 terms in another order, through ratios
SMALL_STEPS = [
    ("flagship, low-resolution head loss", 3, "none", True, 0.05, "float32", STEP_RTOL),
    ("single organ, full resolution", 1, "none", False, 0.05, "float32", STEP_RTOL),
    ("sequential, full resolution", 3, "sequential", False, 0.05, "float64",
     FULLRES_STEP_RTOL),
    ("general composite, full resolution", 3, "general", False, 0.05, "float64",
     FULLRES_STEP_RTOL),
    ("single organ, full resolution", 1, "none", False, 0.05, "float64", FULLRES_STEP_RTOL),
]


def check_small_step() -> None:
    """The same unaugmented step, same weights and batch (batch 2, 64 px,
    dropout off), on the card (kernels) and on the CPU (plain versions), for
    each of ``SMALL_STEPS``; the loss must be finite."""
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.models import DeepLabV3Plus

    for what, organs, mode, lowres, ignore, dtype, rtol in SMALL_STEPS:
        metrics = {}
        for device in ("cuda", "cpu"):
            model = DeepLabV3Plus(num_classes=organs, aspp_dropout=0.0,
                                  upsample_head=not lowres).to(
                device=device, dtype=getattr(torch, dtype), memory_format=torch.channels_last)
            tx = est.make_optimizer(3e-4)
            state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
            step = est.make_train_step(model, tx, composite_mode=mode, augment=False,
                                       lowres_head=lowres)
            rng = torch.Generator(device=device).manual_seed(1)
            _, met = step(state, _batch(2, 64, organs, device, seed=2, ignore=ignore), rng,
                          0.3, [1.0, 1.0, 1.0], 3e-4, None)
            metrics[device] = {k: float(v) for k, v in met.items()}
        nan = []
        for k, want in metrics["cpu"].items():
            got = metrics["cuda"][k]
            if math.isnan(want) and math.isnan(got) and k != "loss":
                nan.append(k)
                continue
            if not (math.isfinite(got) and abs(got - want) <= rtol * abs(want) + 1e-4):
                raise AssertionError(f"small step on the card ({what}, {dtype} model): "
                                     f"{k} {got} vs CPU {want}")
        print(f"small step ({what}, {dtype} model, ignores {ignore}) agrees with the CPU step "
              f"(rtol {rtol}{', NaN on both: ' + ', '.join(nan) if nan else ''}): "
              f"loss {metrics['cuda']['loss']:.6f} vs {metrics['cpu']['loss']:.6f}", flush=True)


def _counter_dicts() -> tuple:
    from ecologysemanticsegmentation_torch.ops import clahe_tiled, head_loss, loss_sums

    return head_loss.launches, clahe_tiled.launches, loss_sums.launches


def _counters() -> dict:
    return {k: v for launches in _counter_dicts() for k, v in launches.items()}


def _zero_counters() -> None:
    for launches in _counter_dicts():
        for k in launches:
            launches[k] = 0


# Loss-sums calls per step of each full-resolution composite mode run here.
LOSS_SUMS_CALLS = {"none": 1, "sequential": 2}

# Phase 5's runs: what -> (ms/step, peak bytes allocated).
STEP_TIMES: dict[str, tuple[float, int]] = {}


def _train_run(card: str, augment: bool, tiled: bool, organs: int = 3,
               composite_mode: str = "none", lowres_head: bool = True,
               per_sample: bool = False) -> dict:
    """13 steps (3 warm-up, 10 timed) from fresh weights at full width; the
    counters are zeroed just before and read just after.  ``per_sample``
    draws the augmentation per sample (``AUGMENT_PER_SAMPLE=1``).  Returns
    the counts."""
    from ecologysemanticsegmentation_torch.data import augment as aug
    from ecologysemanticsegmentation_torch.train import trainer

    # The step reads the CLAHE form from the module flag, which
    # AUGMENT_TILED_CLAHE sets at import, and the augmentation from the
    # trainer's binding, which AUGMENT_PER_SAMPLE sets at import; every form
    # runs in this process.
    aug.TILED_CLAHE = tiled
    saved = trainer.augment_batch
    trainer.augment_batch = aug.augment_batch_per_sample if per_sample else aug.augment_batch
    try:
        return _timed_steps(card, augment, tiled, organs, composite_mode, lowres_head,
                            per_sample)
    finally:
        trainer.augment_batch = saved


def _timed_steps(card: str, augment: bool, tiled: bool, organs: int, composite_mode: str,
                 lowres_head: bool, per_sample: bool) -> dict:
    import torch

    import ecologysemanticsegmentation_torch as est

    batch_size, img = 128, 256
    what = ("flagship" if lowres_head else
            "sequential" if composite_mode == "sequential" else f"full resolution, C = {organs}")
    what += (", augment=False" if not augment else
             f", augment=True{' per sample' if per_sample else ''}, "
             f"{'tiled' if tiled else 'global'} CLAHE")
    model = est.build_model("deeplabv3plus", num_classes=organs, upsample_head=not lowres_head)
    tx = est.make_optimizer(3e-4)
    state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = est.make_train_step(model, tx, composite_mode=composite_mode, augment=augment,
                               lowres_head=lowres_head)
    batch = _batch(batch_size, img, organs, "cuda", seed=4)
    dev_gen = torch.Generator(device="cuda").manual_seed(1)
    rng = (torch.Generator().manual_seed(2), dev_gen) if augment else dev_gen
    gates = [1.0, 1.0, 1.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    losses = []
    for _ in range(3):
        state, met = step(state, batch, rng, 0.0, gates, 3e-4, None)
        losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 10
    for _ in range(timed):
        state, met = step(state, batch, rng, 0.0, gates, 3e-4, None)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    counts = _counters()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({what}): losses {[round(x, 5) for x in losses]}", flush=True)
    print(f"train step ({what}): {step_ms:.3f} ms/step, {batch_size * 1e3 / step_ms:.2f} img/s, "
          f"peak {peak / 2**30:.3f} GiB allocated, launches {counts} [{card}]", flush=True)
    STEP_TIMES[what] = (step_ms, peak)
    steps = 3 + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train step ({what}): non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train step ({what}): loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    want = {k: 0 for k in counts}
    if lowres_head:
        want["head_loss_fwd"] = want["head_loss_bwd"] = steps
    else:
        calls = LOSS_SUMS_CALLS[composite_mode]
        want["loss_sums_fwd"] = want["loss_sums_bwd"] = calls * steps
    if augment and tiled:
        want["clahe_tiled"] = steps
    if counts != want:
        raise AssertionError(f"train step ({what}) did not run its kernels as often as its "
                             f"path calls them: {counts}, expected {want}")
    return counts


def run_main_path(card: str) -> dict:
    """Phases 4 and 5 at full width; returns each kernel's launch count from
    the run that exercises it: the head loss from the unaugmented flagship
    run, the tiled CLAHE from the tiled run, the loss sums from the
    sequential run."""
    import torch

    import ecologysemanticsegmentation_torch as est

    batch_size, img, organs = 128, 256, 3

    # Phase 4: inference forward (full-resolution head).
    fmodel = est.build_model("deeplabv3plus", num_classes=organs, upsample_head=True)
    fstate = est.create_train_state(fmodel, torch.Generator().manual_seed(0),
                                    est.make_optimizer())
    forward = est.make_forward(fmodel)
    images = _batch(batch_size, img, organs, "cuda", seed=3)["image"]
    probs = forward(fstate, images)
    torch.cuda.synchronize()
    if tuple(probs.shape) != (batch_size, img, img, organs) or not torch.isfinite(probs).all():
        raise AssertionError(f"forward: shape {tuple(probs.shape)} or non-finite values")
    if not ((probs >= 0) & (probs <= 1)).all():
        raise AssertionError("forward: probabilities outside [0, 1]")
    fwd_ms = _time_ms(lambda: forward(fstate, images), iters=5, warmup=1)
    print(f"forward: {tuple(probs.shape)} finite, {fwd_ms:.3f} ms/batch of {batch_size} "
          f"[{card}]", flush=True)

    # Phase 4: the eval step (main head, union transform off, val BCE).
    eval_step = est.make_eval_step(fmodel)
    ebatch = _batch(batch_size, img, organs, "cuda", seed=3)
    out = eval_step(fstate, ebatch)
    torch.cuda.synchronize()
    eprobs = out["probs"]
    if not (tuple(eprobs.shape) == (batch_size, img, img, organs)
            and torch.isfinite(eprobs).all() and ((eprobs >= 0) & (eprobs <= 1)).all()):
        raise AssertionError("eval: probabilities of the wrong shape, non-finite or outside [0, 1]")
    if not (tuple(out["dice"].shape) == (organs,) and torch.isfinite(out["dice"]).all()
            and torch.isfinite(out["bce"]) and torch.equal(out["valid"],
                                                          torch.ones_like(out["valid"]))):
        raise AssertionError(f"eval: dice {out['dice']}, bce {out['bce']}, valid {out['valid']}")
    eval_ms = _time_ms(lambda: eval_step(fstate, ebatch), iters=5, warmup=1)
    print(f"eval: dice {[round(float(d), 6) for d in out['dice']]}, bce "
          f"{float(out['bce']):.6f}, valid {out['valid'].tolist()}, {eval_ms:.3f} ms/batch of "
          f"{batch_size} [{card}]", flush=True)
    del fmodel, fstate, images, probs, ebatch, out, eprobs

    # Phase 5: the flagship step, unaugmented and augmented in both CLAHE
    # forms; the sequential and the single-organ full-resolution steps.
    counts = _train_run(card, augment=False, tiled=False)
    _train_run(card, augment=True, tiled=False)
    tiled = _train_run(card, augment=True, tiled=True)
    seq = _train_run(card, augment=True, tiled=False, composite_mode="sequential",
                     lowres_head=False)
    _train_run(card, augment=True, tiled=False, organs=1, lowres_head=False)
    counts["clahe_tiled"] = tiled["clahe_tiled"]
    counts["loss_sums_fwd"], counts["loss_sums_bwd"] = seq["loss_sums_fwd"], seq["loss_sums_bwd"]
    return counts


# Phase 7: the trainer CLI (``train_multiclass``) on the card, in a
# temporary directory removed at the end.  (name, its directory there, env,
# flags, steps it takes, the kernels each step launches once each way.)  (a) The flagship
# at the JAX package's defaults: 108 training images an epoch padded to one
# step of 128, 6 val images, 12 epochs of one step, checkpoints at epochs
# 0, 10 and 11, the global CLAHE.  (b) The same command resumed to 13 epochs: one step.
# (c) One organ: the full-resolution loss sums through the CLI.
FLAGSHIP_ENV = {"ORGANS": "whole_body,ventral_side,dorsal_side", "IMGSIZE": "256"}
CLI_RUNS = [
    ("flagship", "flagship", FLAGSHIP_ENV, ["--num_epochs", "12"], 12,
     ("head_loss_fwd", "head_loss_bwd")),
    ("flagship resumed", "flagship", FLAGSHIP_ENV, ["--num_epochs", "13"], 1,
     ("head_loss_fwd", "head_loss_bwd")),
    ("one organ", "one_organ", {"ORGANS": "whole_body", "IMGSIZE": "256"},
     ["--num_epochs", "3"], 3, ("loss_sums_fwd", "loss_sums_bwd")),
]
CLI_FLAGS = ["--dataset", "synthetic", "--batch_size", "128"]
# The columns of the JAX CLI's metrics.csv (its train_multiclass.py:300-305).
CLI_METRICS = sorted(["epoch", "step", "lr", "bg_weight", "loss", "bce", "focal_dice",
                      "images_per_sec"])
CLI_ENV_KEYS = ("ORGANS", "IMGSIZE", "IMG_SIZE", "EXPTNAME", "SAMPLE", "MAXCHANNELS",
                "BBOX_DIR", "AUGMENT_TILED_CLAHE")


def _read_png(path: Path) -> tuple:
    """(height, width, channels) of an 8-bit grayscale or RGB PNG, after
    checking its signature, every chunk's CRC, the size of its decompressed
    rows and each row's filter type."""
    import struct
    import zlib

    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    channels = {0: 1, 2: 3}[color]
    raw = zlib.decompress(idat)
    if depth != 8 or len(raw) != h * (1 + w * channels) or any(raw[r * (1 + w * channels)] > 4
                                                             for r in range(h)):
        raise AssertionError(f"{path}: not an 8-bit PNG of {h} rows of {w} pixels")
    return h, w, channels


def _cli_run(card: str, name: str, env: dict, flags: list, steps: int, kernels: tuple):
    """Run the CLI once in the current directory with the counters zeroed
    just before and read just after; returns (final state, its output, the
    CLI's images/sec by epoch, the launch counters)."""
    import contextlib
    import io
    import os

    import torch

    from ecologysemanticsegmentation_torch import train_multiclass as cli

    for k in CLI_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(env)
    args = cli.build_argparser().parse_args(CLI_FLAGS + flags)
    log = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            state = cli.train(args)
        torch.cuda.synchronize()
    except BaseException:
        print(log.getvalue()[-8000:], file=sys.stderr, flush=True)
        raise
    wall = time.perf_counter() - t0
    counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    out = log.getvalue()
    rates = [float(m) for m in re.findall(r"^epoch \d+: ([\d.]+) images/sec", out, re.M)]
    print(f"cli ({name}): {wall:.2f} s wall, {len(rates)} epochs, the CLI's images/sec by epoch "
          f"{rates}, peak {peak / 2**30:.3f} GiB allocated, launches {counts} [{card}]",
          flush=True)
    want = {k: 0 for k in counts}
    for k in kernels:
        want[k] = steps
    if counts != want:
        raise AssertionError(f"cli ({name}) did not run its kernels once a step: {counts}, "
                             f"expected {want}")
    return state, out, rates, counts


def check_cli(card: str) -> dict:
    """Phase 7; returns the launches of each kernel in the CLI runs."""
    import importlib.util
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.data import augment as aug
    from ecologysemanticsegmentation_torch.data import imops, native
    from ecologysemanticsegmentation_torch.train import checkpoint as ck

    aug.TILED_CLAHE = False  # the JAX package's default, the global CLAHE
    t0 = time.perf_counter()
    print(f"cli: this host has cv2 {'present' if imops.HAS_CV2 else 'absent'}, PIL "
          f"{'present' if imops._pil_image() else 'absent'}, msgpack "
          f"{'present' if importlib.util.find_spec('msgpack') else 'absent'}; native "
          f"host-ops library {'built' if native.native_available() else 'absent'} (JPEG "
          f"{native.jpeg_available()}, PNG {native.png_available()})", flush=True)
    had_msgpack = "msgpack" in sys.modules
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    cwd, env = os.getcwd(), dict(os.environ)
    launches: dict = {}
    try:
        runs = {}
        for name, subdir, run_env, flags, steps, kernels in CLI_RUNS:
            (work / subdir).mkdir(exist_ok=True)
            os.chdir(work / subdir)
            runs[name] = _cli_run(card, name, run_env, flags, steps, kernels)
            for k, n in runs[name][3].items():
                launches[k] = launches.get(k, 0) + n
        flagship = work / "flagship"
        save_dir = flagship / "models" / "deeplabv3p" / "channels256" / "img256"
        ckpts = sorted(p.name for p in save_dir.iterdir())
        want = [f"deeplabv3p_epoch{e}.ckpt" for e in (0, 10, 11, 12)]
        if ckpts != want:
            raise AssertionError(f"cli: checkpoints {ckpts}, expected {want}")
        resumed = runs["flagship resumed"][1]
        latest = "Used latest model file: models/deeplabv3p/channels256/img256/" \
                 "deeplabv3p_epoch11.ckpt"
        if latest not in resumed or "Epoch: 12 ;" in resumed \
                or "Epoch: 13 ; Batch: 1/1" not in resumed:
            raise AssertionError("cli (flagship resumed): did not resume from epoch 11 and run "
                                 "epoch 12 only")
        with open(flagship / "models" / "deeplabv3p" / "metrics.csv") as f:
            header, *rows = [line.strip().split(",") for line in f]
        if header != CLI_METRICS or len(rows) != 13:
            raise AssertionError(f"cli: metrics.csv has {header} and {len(rows)} rows")
        losses = [float(r[header.index("loss")]) for r in rows[:12]]
        print(f"cli (flagship): loss by epoch {[round(x, 5) for x in losses]}", flush=True)
        # Each epoch draws another batch and augmentation: the means of the
        # first and the last three epochs, not two single steps.
        if not all(math.isfinite(x) for x in losses) or not sum(losses[-3:]) < sum(losses[:3]):
            raise AssertionError(f"cli (flagship): loss not finite or not falling: {losses}")
        # The port's reader restores the epoch-12 file into a fresh state.
        model = est.build_model("deeplabv3plus", num_classes=3, upsample_head=False)
        fresh = est.create_train_state(model, torch.Generator().manual_seed(99),
                                       est.make_optimizer(3e-4))
        epoch, fresh = ck.load_recent_model(str(save_dir), fresh, "deeplabv3p", epoch=12)
        got, ran = ck.state_to_flax(fresh), ck.state_to_flax(runs["flagship resumed"][0])
        flat = _flat_tree(got)
        if epoch != 12 or flat.keys() != _flat_tree(ran).keys() or not all(
                np.array_equal(v, _flat_tree(ran)[k]) for k, v in flat.items()):
            raise AssertionError("cli: the epoch-12 checkpoint does not restore the run's state")
        print(f"cli: the epoch-12 checkpoint restores the run's state, {len(flat)} leaves equal",
              flush=True)
        # Val triplets: the first 10 (here all 6) val images of every epoch.
        n_png = 0
        for subdir, epochs, organs in (("flagship", 13, 3), ("one_organ", 3, 1)):
            root = work / subdir / "val_images"
            for e in range(epochs):
                for j in range(6):
                    names = [f"{j}_img.png"] + [f"{j}_{kind}_organ{c}.png" for c in range(organs)
                                                for kind in ("gt", "pred")]
                    for png in names:
                        shape = _read_png(root / str(e) / png)
                        if shape != (256, 256, 3 if png.endswith("img.png") else 1):
                            raise AssertionError(f"cli: {png} of epoch {e} is {shape}")
                        n_png += 1
        print(f"cli: {n_png} val PNGs readable at 256 x 256", flush=True)
        # The host pipeline's share: the CLI's step against phase 5's.
        ms, peak = STEP_TIMES["flagship, augment=True, global CLAHE"]
        rates = runs["flagship"][2][1:]
        cli_ms = sorted(108e3 / r for r in rates)[len(rates) // 2]
        print(f"cli (flagship) against phase 5: the CLI's epoch of one step (108 images) "
              f"{cli_ms:.3f} ms median over epochs 1-11 ({108e3 / cli_ms:.2f} img/s), phase "
              f"5's augmented step {ms:.3f} ms ({128e3 / ms:.2f} img/s of 128, peak "
              f"{peak / 2**30:.3f} GiB); the difference {cli_ms - ms:.3f} ms is the host "
              f"pipeline, the metrics' transfer and the random draws [{card}]", flush=True)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(work, ignore_errors=True)
    if "msgpack" in sys.modules and not had_msgpack:
        raise AssertionError("cli: the trainer imported msgpack")
    print(f"cli: phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


# Phase 8: per-sample augmentation, the sequential trainer CLI and the eval
# CLIs.  Mask pixels of the per-sample check that may take the other
# neighbour: the card computes each sample's rotation (cos, sin) on the
# device, the CPU and the batch-uniform path on the host, so a coordinate
# one f32 ulp from a nearest-neighbour tie can round the other way.
PS_MASK_FRAC = 1e-3
SEQ_CLI_EPOCHS = 12   # one step each; checkpoints at epochs 0, 5, 10 and 11
# The synthetic set at 256 px: 128 images, split 108 / 6 / 14.
TEST_IMAGES = 14


def _params_to(params: dict, device: str) -> dict:
    """Per-sample draws moved to ``device``; the OneOf choices stay on the
    host, where the pipeline reads them."""
    out = {}
    for k, v in params.items():
        if k.endswith("_choice"):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _params_to(v, device)
        elif isinstance(v, tuple):
            out[k] = tuple(t.to(device) for t in v)
        else:
            out[k] = v.to(device)
    return out


def check_augment_per_sample() -> None:
    """Phase 8 (a), first: the per-sample apply on the card (batch 8 at
    64 px) against the per-sample apply on the CPU from the same draws and
    against eight singleton batch-uniform applies on the card, in both
    CLAHE forms, with the draws forced so that every OneOf op, the crop, the
    flip and the rotation each occur (alone and composed) and one sample
    has every gate off.  Images at phase 3's tolerance; masks equal but for
    at most ``PS_MASK_FRAC`` of their pixels."""
    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    b, img = 8, 64
    gen = torch.Generator().manual_seed(16)
    images = torch.rand((b, img, img, 3), generator=gen)
    masks = (torch.rand((b, img, img, 3), generator=gen) * 3).floor() - 1.0
    params = aug.draw_augment_params_per_sample(torch.Generator().manual_seed(17),
                                                torch.Generator().manual_seed(18), b, img, img)
    on = torch.ones((b, 1, 1, 1), dtype=torch.bool)
    on[0] = False
    params["outer"] = params["blur_gate"] = params["color_gate"] = on
    params["blur_choice"] = torch.tensor([0, 0, 1, 2, 3, 1, 2, 3])
    params["color_choice"] = torch.tensor([0, 0, 1, 2, 3, 3, 2, 1])
    params["crop_gate"] = torch.tensor([False, True, False, False, True, False, True, False])
    params["flip_gate"] = torch.tensor([False, False, True, False, True, True, False, True])
    params["rot_gate"] = torch.tensor([False, False, False, True, True, True, True, False])
    params["degree"] = torch.tensor([0.0, 12.0, 0.0, 37.0, 33.0, 71.0, 5.0, 0.0])
    card_params = _params_to(params, "cuda")
    worst, worst_mask = 0.0, 0.0
    for tiled in (False, True):
        cpu = aug.apply_augment_per_sample(images, masks, params, tiled_clahe=tiled)
        card = aug.apply_augment_per_sample(images.cuda(), masks.cuda(), card_params,
                                            tiled_clahe=tiled)
        singles = [aug.apply_augment(images[i:i + 1].cuda(), masks[i:i + 1].cuda(),
                                     aug.sample_augment_params(card_params, i),
                                     tiled_clahe=tiled) for i in range(b)]
        single = tuple(torch.cat([s[k] for s in singles]) for k in (0, 1))
        for what, want in (("the per-sample apply on the CPU", cpu),
                           ("8 singleton batch-uniform applies on the card", single)):
            got_img, want_img = card[0].float().cpu(), want[0].float().cpu()
            err = (got_img - want_img).abs()
            flipped = (err > AUG_ULPS * _bf16_ulp(want_img)).any(-1).float().mean().item()
            mask_frac = (card[1].cpu() != want[1].cpu()).float().mean().item()
            if not (flipped <= AUG_FLIP_FRAC and err.max().item() <= AUG_FLIP_MAX
                    and mask_frac <= PS_MASK_FRAC and card[0].dtype == torch.bfloat16):
                raise AssertionError(
                    f"per-sample augmentation on the card disagrees with {what} "
                    f"(tiled={tiled}): {flipped:.4f} of pixels beyond {AUG_ULPS} ulps, max "
                    f"err {err.max().item():.4g}, masks differ at {mask_frac:.4g}")
            worst = max(worst, err.max().item())
            worst_mask = max(worst_mask, mask_frac)
    # Neither granularity waits for the device: a synchronizing call would
    # hold the host until the previous step's work is done.
    on_card = images.cuda(), masks.cuda()
    for fn in (aug.augment_batch_per_sample, aug.augment_batch):
        gens = (torch.Generator().manual_seed(19), torch.Generator(device="cuda").manual_seed(20))
        fn(gens, *on_card)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(gens, *on_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"per-sample augment check: the card's per-sample apply = the CPU's and = 8 "
          f"singleton batch-uniform applies on the card, 2 CLAHE forms, every OneOf op and "
          f"warp case (max err {worst:.4g}, masks differ at {worst_mask:.4g} of pixels); no "
          f"call of either granularity synchronizes with the device", flush=True)


def _smp_state_dict(seed: int, classes: int = 3) -> dict:
    """A seeded synthetic state dict of smp 0.3.3's DeepLabV3Plus(resnet34),
    the layout of the reference's ``torch.save(net.state_dict())``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = 0.02 * torch.randn((o, i, k, k), generator=gen)

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def sep(name, i, o, bn_name):
        conv(f"{name}.0", i, 1, 3)
        conv(f"{name}.1", o, i, 1)
        bn(bn_name, o)

    conv("encoder.conv1", 64, 3, 7)
    bn("encoder.bn1", 64)
    in_ch = 64
    for layer, blocks, width in ((1, 3, 64), (2, 4, 128), (3, 6, 256), (4, 3, 512)):
        for b in range(blocks):
            base = f"encoder.layer{layer}.{b}"
            conv(f"{base}.conv1", width, in_ch if b == 0 else width, 3)
            bn(f"{base}.bn1", width)
            conv(f"{base}.conv2", width, width, 3)
            bn(f"{base}.bn2", width)
            if b == 0 and in_ch != width:
                conv(f"{base}.downsample.0", width, in_ch, 1)
                bn(f"{base}.downsample.1", width)
        in_ch = width
    conv("decoder.aspp.0.convs.0.0", 256, 512, 1)
    bn("decoder.aspp.0.convs.0.1", 256)
    for i in (1, 2, 3):
        sep(f"decoder.aspp.0.convs.{i}.0", 512, 256, f"decoder.aspp.0.convs.{i}.1")
    conv("decoder.aspp.0.convs.4.1", 256, 512, 1)
    bn("decoder.aspp.0.convs.4.2", 256)
    conv("decoder.aspp.0.project.0", 256, 256 * 5, 1)
    bn("decoder.aspp.0.project.1", 256)
    sep("decoder.aspp.1", 256, 256, "decoder.aspp.2")
    conv("decoder.block1.0", 48, 64, 1)
    bn("decoder.block1.1", 48)
    sep("decoder.block2.0", 256 + 48, 256, "decoder.block2.1")
    conv("segmentation_head.0", classes, 256, 1)
    sd["segmentation_head.0.bias"] = 0.1 * torch.randn(classes, generator=gen)
    return sd


def _run_cli(fn, args, fail_log: bool = True) -> str:
    """Call a CLI's entry point with its stdout captured; its output."""
    import contextlib
    import io

    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            fn(args)
    except BaseException:
        if fail_log:
            print(log.getvalue()[-8000:], file=sys.stderr, flush=True)
        raise
    return log.getvalue()


def check_sequential_cli(card: str) -> dict:
    """Phase 8 (b): ``train_multiclass_sequential_densenetloss`` in the
    current directory, flagship env, batch 128, augmented, for
    ``SEQ_CLI_EPOCHS`` epochs; returns its launch counters."""
    import os

    import torch

    from ecologysemanticsegmentation_torch import train_multiclass_sequential_densenetloss as scli

    for k in CLI_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(FLAGSHIP_ENV)
    args = scli.build_argparser().parse_args(CLI_FLAGS + ["--num_epochs", str(SEQ_CLI_EPOCHS)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    out = _run_cli(scli.train, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    epochs = re.findall(r"^Epoch (\d+): loss (\S+) \(([\d.]+) img/s, lr=(\S+), bg=(\S+)\)$",
                        out, re.M)
    val = [float(v) for v in re.findall(r"^Val Loss: (\S+)!$", out, re.M)]
    losses = [float(e[1]) for e in epochs]
    rates = [float(e[2]) for e in epochs]
    print(f"sequential cli: {wall:.2f} s wall, {len(epochs)} epochs, the CLI's img/s by epoch "
          f"{rates}, plateau lr by epoch {[e[3] for e in epochs]}, val BCE {val}, peak "
          f"{peak / 2**30:.3f} GiB allocated, launches {counts} [{card}]", flush=True)
    print(f"sequential cli: loss by epoch {losses}", flush=True)
    want = {k: 0 for k in counts}
    want["loss_sums_fwd"] = want["loss_sums_bwd"] = 2 * SEQ_CLI_EPOCHS
    if counts != want:
        raise AssertionError(f"sequential cli did not launch the loss sums 2 + 2 a step: "
                             f"{counts}, expected {want}")
    if len(epochs) != SEQ_CLI_EPOCHS or len(val) != SEQ_CLI_EPOCHS \
            or "finished training" not in out:
        raise AssertionError("sequential cli: did not run every epoch and its val loop "
                             "(the divergence guard aborts a run)")
    if not all(math.isfinite(x) for x in losses + val) \
            or not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"sequential cli: loss not finite or not falling: {losses}")
    save_dir = Path("models") / "deeplabv3p" / "channels256" / "img256"
    ckpts = sorted(p.name for p in save_dir.iterdir())
    want_ckpts = sorted(f"deeplabv3p_epoch{e}.ckpt" for e in (0, 5, 10, SEQ_CLI_EPOCHS - 1))
    if ckpts != want_ckpts:
        raise AssertionError(f"sequential cli: checkpoints {ckpts}, expected {want_ckpts}")
    ms, _ = STEP_TIMES["sequential, augment=True, global CLAHE"]
    cli_ms = sorted(108e3 / r for r in rates[1:])[len(rates[1:]) // 2]
    print(f"sequential cli against phase 5: the CLI's epoch of one step (108 images) "
          f"{cli_ms:.3f} ms median over epochs 1-{SEQ_CLI_EPOCHS - 1} ({108e3 / cli_ms:.2f} "
          f"img/s), phase 5's sequential step {ms:.3f} ms; the host's share "
          f"{cli_ms - ms:.3f} ms ({(cli_ms - ms) / cli_ms:.0%}) [{card}]", flush=True)
    return counts


def check_eval_clis(card: str, work: Path) -> None:
    """Phase 8 (c): the sequential evaluator over (b)'s checkpoints in
    ``work / "sequential"`` (the sweep, a second call, ``--single_model``
    with ``--edge_analysis``), and ``test_multiclass`` over a reference
    ``.pt`` file and over its round trip through ``save_checkpoint``; no
    kernel may launch."""
    import os

    import numpy as np
    import torch

    import ecologysemanticsegmentation_torch as est
    import ecologysemanticsegmentation_torch.train as ptrain
    from ecologysemanticsegmentation_torch import test_multiclass as tm
    from ecologysemanticsegmentation_torch import test_multiclass_sequential_densenetloss as tms
    from ecologysemanticsegmentation_torch.train import checkpoint as ck

    organs = FLAGSHIP_ENV["ORGANS"]
    batch_ms = []
    make_eval_step = ptrain.make_eval_step

    def timed_make_eval_step(model, apply_union_reverse=False):
        step = make_eval_step(model, apply_union_reverse)

        def timed(state, batch):
            if batch["image"].shape[0] != TEST_IMAGES:  # --single_model, the edge analysis
                return step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def parse(module, flags):
        return module.build_argparser().parse_args(["--dataset", "synthetic"] + flags)

    ptrain.make_eval_step = timed_make_eval_step
    _zero_counters()
    try:
        os.chdir(work / "sequential")
        epochs = [0, 5, 10, SEQ_CLI_EPOCHS - 1]
        results = {}
        out = _run_cli(lambda a: results.setdefault("sweep", tms.test(a)), parse(tms, []))
        sweep = results["sweep"]
        if [e for e, _ in sweep] != epochs or not all(
                d.shape == (3,) and np.isfinite(d).all() and ((d >= 0) & (d <= 1)).all()
                for _, d in sweep):
            raise AssertionError(f"eval: the sequential sweep scored {sweep}")
        ranking = re.findall(r"^Epoch (\d+) : Organ : (\S+) DICE Score", out, re.M)
        print(f"eval (sequential sweep): per-organ Dice by epoch "
              f"{[(e, [round(float(x), 6) for x in d]) for e, d in sweep]}, ranking "
              f"{ranking}, {len(batch_ms)} batches of {TEST_IMAGES} [{card}]", flush=True)
        out = _run_cli(lambda a: results.setdefault("skip", tms.test(a)), parse(tms, []))
        if results["skip"] != [] or any(f"Skipping epoch {e}! Test already done!" not in out
                                        for e in epochs):
            raise AssertionError("eval: a second call did not skip every epoch")
        last = str(SEQ_CLI_EPOCHS - 1)
        _run_cli(tms.test, parse(tms, ["--single_model", last, "--edge_analysis",
                                       "--results_dir", "single"]))
        overlays = sorted((Path("single") / last.zfill(4) / organs).iterdir())
        edges = sorted((Path("single") / f"edge_analysis_epoch{last}").iterdir())
        if len(overlays) != TEST_IMAGES * 4 * 2 or len(edges) != 2 * 2 * 3:
            raise AssertionError(f"eval: {len(overlays)} overlay and {len(edges)} edge PNGs")
        for png in overlays + edges:
            shape = _read_png(png)
            if shape != (256, 256, 3 if png in overlays else 1):
                raise AssertionError(f"eval: {png} is {shape}")
        print(f"eval (--single_model {last} --edge_analysis): {len(overlays)} overlay and "
              f"{len(edges)} edge-analysis PNGs readable at 256 x 256", flush=True)

        # The reference's .pt weights, and the same weights through the
        # port's msgpack checkpoint: the two scores must be equal.
        save_dir = Path("models") / "deeplabv3p" / "channels256" / "img256"
        scores = {}
        for name in ("pt", "round_trip"):
            (work / name / save_dir).mkdir(parents=True)
            os.chdir(work / name)
            if name == "pt":
                torch.save(_smp_state_dict(seed=5), save_dir / "deeplabv3p_epoch0.pt")
            else:
                model = est.build_model("deeplabv3plus", num_classes=3)
                state = ck.load_checkpoint_file(
                    str(work / "pt" / save_dir / "deeplabv3p_epoch0.pt"), tm.eval_template(model))
                ck.save_checkpoint(str(save_dir), "deeplabv3p", 0, state)
                del model, state
            _run_cli(lambda a: scores.setdefault(name, tm.test(a)), parse(tm, []))
        (ep, got), (ep_rt, want) = scores["pt"][0], scores["round_trip"][0]
        if not (ep == ep_rt == 0 and np.isfinite(got).all() and np.array_equal(got, want)):
            raise AssertionError(f"eval: the .pt file scored {got}, its msgpack round trip "
                                 f"{want}")
        print(f"eval (test_multiclass): the reference .pt file scores {got.tolist()}, equal "
              f"to its round trip through save_checkpoint [{card}]", flush=True)
    finally:
        ptrain.make_eval_step = make_eval_step
    counts = _counters()
    if any(counts.values()):
        raise AssertionError(f"eval launched kernels: {counts}")
    ms = sorted(batch_ms)
    print(f"eval: {ms[len(ms) // 2]:.3f} ms per batch of {TEST_IMAGES} at 256 px (median of "
          f"{len(ms)} batches, min {ms[0]:.3f}, max {ms[-1]:.3f}), no kernel launched "
          f"[{card}]", flush=True)


def check_phase8(card: str) -> dict:
    """Phase 8; returns the launches of the per-sample tiled-CLAHE run and
    of the sequential CLI."""
    import os
    import shutil
    import tempfile

    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    t0 = time.perf_counter()
    check_augment_per_sample()
    _train_run(card, augment=True, tiled=False, per_sample=True)
    per_sample = _train_run(card, augment=True, tiled=True, per_sample=True)
    for tiled in ("global", "tiled"):
        ms, peak = STEP_TIMES[f"flagship, augment=True per sample, {tiled} CLAHE"]
        ms5, peak5 = STEP_TIMES[f"flagship, augment=True, {tiled} CLAHE"]
        print(f"per-sample flagship ({tiled} CLAHE): {ms:.3f} ms/step, peak {peak / 2**30:.3f} "
              f"GiB; phase 5's batch-uniform step {ms5:.3f} ms/step, peak "
              f"{peak5 / 2**30:.3f} GiB; +{ms - ms5:.3f} ms/step [{card}]", flush=True)
    torch.cuda.empty_cache()
    aug.TILED_CLAHE = False  # the JAX package's default, the global CLAHE
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_phase8_"))
    cwd, env = os.getcwd(), dict(os.environ)
    try:
        (work / "sequential").mkdir()
        os.chdir(work / "sequential")
        seq = check_sequential_cli(card)
        torch.cuda.empty_cache()
        check_eval_clis(card, work)
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"per_sample": per_sample, "sequential_cli": seq}


# Phase 9: the rest of the model zoo.  (a) Small parity steps: float64
# models, 64 px, batch 4, dropout 0 where the JAX module takes it as an
# argument, unaugmented, card (kernels) against CPU (plain versions) at
# FULLRES_STEP_RTOL.  The EfficientNet U-Net fixes its stochastic-depth p
# inside (0.05): both runs draw its masks from one seeded CPU generator.
# (what, model arguments of build_model or "effnet", composite_mode,
# lowres_head, deep supervision)
ZOO_SMALL = [
    ("vgg_unet, max_channels 256, deep supervision",
     dict(name="vgg_unet", max_channels=256, deepsupervision=True), "none", False, True),
    ("unet, resnet34", dict(name="unet"), "none", False, False),
    ("unet, resnet50", dict(name="unet", encoder_name="resnet50"), "none", False, False),
    ("deeplabv3plus, resnet50, low-resolution head",
     dict(name="deeplabv3plus", encoder_name="resnet50", upsample_head=False), "none", True,
     False),
    ("deeplabv3plus_depthwise, sequential",
     dict(name="deeplabv3plus_depthwise"), "sequential", False, False),
    ("efficientnet_v2s_unet, depth 0.2", "effnet", "none", False, False),
]
# (b) Full-width steps on the flagship's data (batch 128 at 256 px, C = 3,
# the global CLAHE, bf16 autocast, 13 steps): (what, build_model arguments,
# composite_mode, lowres_head, deep supervision).  The VGG U-Net runs at the
# CLI's default max_channels 256, plain and with remat from the same
# weights, batch and generator seeds.
ZOO_FULL = [
    ("vgg_unet, max_channels 256, deep supervision",
     dict(name="vgg_unet", max_channels=256, deepsupervision=True), "none", False, True),
    ("vgg_unet, max_channels 256, deep supervision, remat",
     dict(name="vgg_unet", max_channels=256, deepsupervision=True, remat=True), "none", False,
     True),
    ("unet, resnet34", dict(name="unet"), "none", False, False),
    ("unet, resnet50", dict(name="unet", encoder_name="resnet50"), "none", False, False),
    ("deeplabv3plus, resnet50, low-resolution head",
     dict(name="deeplabv3plus", encoder_name="resnet50", upsample_head=False), "none", True,
     False),
    ("deeplabv3plus_depthwise, sequential", dict(name="deeplabv3plus_depthwise"), "sequential",
     False, False),
    ("efficientnet_v2s_unet", dict(name="efficientnet_v2s_unet"), "none", False, False),
]
ZOO_CLI_EPOCHS = 4     # train_multiclass --model vgg_unet --deepsupervision
ZOO_SEQ_EPOCHS = 3     # train_multiclass_sequential_densenetloss --depthwiseconv


def _zoo_model(spec, device: str, dtype=None):
    """A phase-9 model: ``build_model`` of ``spec``, or the EfficientNet U-Net
    at depth 0.2; with ``dtype``, dropout 0 where the model takes it."""
    import torch

    from ecologysemanticsegmentation_torch import models

    if spec == "effnet":
        model = models.EfficientNetV2SUNet(3, depth_multiplier=0.2)
    elif dtype is None:
        return models.build_model(num_classes=3, device=device, **spec)
    elif spec["name"] == "vgg_unet":
        model = models.VGGUNet(3, spec["max_channels"], dropout_p=0.0,
                               deepsupervision=spec["deepsupervision"])
    elif spec["name"] == "deeplabv3plus":
        model = models.DeepLabV3Plus(3, spec["encoder_name"], aspp_dropout=0.0,
                                     upsample_head=spec["upsample_head"])
    elif spec["name"] == "deeplabv3plus_depthwise":
        model = models.DeepLabV3PlusDepthwise(3, aspp_dropout=0.0)
    else:
        model = models.build_model(num_classes=3, device="cpu", **spec)
    return model.to(device=device, dtype=dtype, memory_format=torch.channels_last)


def check_zoo_small_steps() -> None:
    """Phase 9 (a): each model's small step on the card against the CPU."""
    import torch

    import ecologysemanticsegmentation_torch as est

    for what, spec, mode, lowres, deepsup in ZOO_SMALL:
        metrics = {}
        for device in ("cuda", "cpu"):
            model = _zoo_model(spec, device, torch.float64)
            tx = est.make_optimizer(3e-4)
            state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
            step = est.make_train_step(model, tx, composite_mode=mode, augment=False,
                                       deepsupervision=deepsup, lowres_head=lowres)
            # a CPU generator on both sides: the same dropout masks
            _, met = step(state, _batch(4, 64, 3, device, seed=2), torch.Generator().manual_seed(1),
                          0.3, [1.0, 1.0, 1.0], 3e-4, None)
            metrics[device] = {k: float(v) for k, v in met.items()}
        for k, want in metrics["cpu"].items():
            got = metrics["cuda"][k]
            if not (math.isfinite(got) and abs(got - want) <= FULLRES_STEP_RTOL * abs(want) + 1e-4):
                raise AssertionError(f"zoo small step on the card ({what}): {k} {got} vs CPU "
                                     f"{want}")
        print(f"zoo small step ({what}, float64 model) agrees with the CPU step (rtol "
              f"{FULLRES_STEP_RTOL}): loss {metrics['cuda']['loss']:.6f} vs "
              f"{metrics['cpu']['loss']:.6f}", flush=True)


def _zoo_run(card: str, what: str, spec: dict, mode: str, lowres: bool, deepsup: bool) -> tuple:
    """13 steps (3 warm-up, 10 timed) of one model at full width from seed 0,
    counters zeroed just before and read just after; returns (the counts, the
    first step's loss, its gradients)."""
    import torch

    import ecologysemanticsegmentation_torch as est

    batch_size, img = 128, 256
    model = _zoo_model(spec, "cuda")
    tx = est.make_optimizer(3e-4)
    state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = est.make_train_step(model, tx, composite_mode=mode, augment=True,
                               deepsupervision=deepsup, lowres_head=lowres)
    batch = _batch(batch_size, img, 3, "cuda", seed=4)
    rng = (torch.Generator().manual_seed(2), torch.Generator(device="cuda").manual_seed(1))
    gates = [1.0, 1.0, 1.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    losses, grads = [], None
    for i in range(3):
        state, met = step(state, batch, rng, 0.0, gates, 3e-4, None)
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 10
    for _ in range(timed):
        state, met = step(state, batch, rng, 0.0, gates, 3e-4, None)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    counts = _counters()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    print(f"zoo step ({what}): losses {[round(x, 5) for x in losses]}", flush=True)
    print(f"zoo step ({what}): {step_ms:.3f} ms/step, {batch_size * 1e3 / step_ms:.2f} img/s, "
          f"peak {peak / 2**30:.3f} GiB allocated, launches {counts} [{card}]", flush=True)
    STEP_TIMES[f"zoo: {what}"] = (step_ms, peak)
    steps = 3 + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"zoo step ({what}): non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"zoo step ({what}): loss did not fall ({losses[0]} -> "
                             f"{losses[-1]})")
    want = {k: 0 for k in counts}
    if lowres:
        want["head_loss_fwd"] = want["head_loss_bwd"] = steps
    else:
        want["loss_sums_fwd"] = want["loss_sums_bwd"] = LOSS_SUMS_CALLS[mode] * steps
    if counts != want:
        raise AssertionError(f"zoo step ({what}) did not run its kernels as often as its path "
                             f"calls them: {counts}, expected {want}")
    return counts, losses[0], grads


def check_zoo_full(card: str) -> dict:
    """Phase 9 (b); returns the launches summed over its runs."""
    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    aug.TILED_CLAHE = False  # the global CLAHE
    total: dict = {}
    first = {}
    for what, spec, mode, lowres, deepsup in ZOO_FULL:
        counts, loss0, grads = _zoo_run(card, what, spec, mode, lowres, deepsup)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        if spec["name"] == "vgg_unet":
            first[bool(spec.get("remat"))] = (loss0, grads)
        del grads
        torch.cuda.empty_cache()
    (loss, grads), (rloss, rgrads) = first[False], first[True]
    worst = 0.0
    for n, g in grads.items():
        err = (rgrads[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        worst = max(worst, err)
        if not err <= STEP_RTOL:
            raise AssertionError(f"zoo: the remat step's gradient of {n} is {err:.3g} of its "
                                 f"scale away from the plain step's")
    if not abs(rloss - loss) <= STEP_RTOL * abs(loss):
        raise AssertionError(f"zoo: the remat step's first loss {rloss} vs plain {loss}")
    ms, peak = STEP_TIMES["zoo: " + ZOO_FULL[0][0]]
    rms, rpeak = STEP_TIMES["zoo: " + ZOO_FULL[1][0]]
    print(f"zoo: vgg_unet remat's first step = the plain step's (loss {rloss:.6f} vs "
          f"{loss:.6f}, gradients within {worst:.3g} of each tensor's scale, bound "
          f"{STEP_RTOL}); remat {rms:.3f} ms/step, peak {rpeak / 2**30:.3f} GiB against plain "
          f"{ms:.3f} ms/step, peak {peak / 2**30:.3f} GiB [{card}]", flush=True)
    return total


def check_zoo_clis(card: str) -> dict:
    """Phase 9 (c), in the current directory: ``train_multiclass --model
    vgg_unet --deepsupervision``, ``test_multiclass --deepsupervision`` over
    its checkpoints, and ``train_multiclass_sequential_densenetloss
    --depthwiseconv``; returns the launches summed over the trainers."""
    import os

    import numpy as np
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch import test_multiclass as tm
    from ecologysemanticsegmentation_torch import train_multiclass_sequential_densenetloss as scli
    from ecologysemanticsegmentation_torch.train import checkpoint as ck

    work = Path(os.getcwd())
    (work / "vgg").mkdir()
    os.chdir(work / "vgg")
    flags = ["--model", "vgg_unet", "--deepsupervision", "--num_epochs", str(ZOO_CLI_EPOCHS)]
    state, out, rates, total = _cli_run(card, "vgg_unet --deepsupervision", FLAGSHIP_ENV, flags,
                                        ZOO_CLI_EPOCHS, ("loss_sums_fwd", "loss_sums_bwd"))
    save_dir = Path("models") / "deeplabv3p" / "channels256" / "img256"
    ckpts = sorted(p.name for p in save_dir.iterdir())
    want = sorted(f"deeplabv3p_epoch{e}.ckpt" for e in (0, ZOO_CLI_EPOCHS - 1))
    if ckpts != want:
        raise AssertionError(f"zoo cli: checkpoints {ckpts}, expected {want}")
    with open(Path("models") / "deeplabv3p" / "metrics.csv") as f:
        header, *rows = [line.strip().split(",") for line in f]
    losses = [float(r[header.index("loss")]) for r in rows]
    if header != CLI_METRICS or len(rows) != ZOO_CLI_EPOCHS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"zoo cli: metrics.csv has {header}, rows {rows}")
    model = est.build_model("vgg_unet", num_classes=3, deepsupervision=True)
    fresh = est.create_train_state(model, torch.Generator().manual_seed(99),
                                   est.make_optimizer(3e-4))
    epoch, fresh = ck.load_recent_model(str(save_dir), fresh, "deeplabv3p")
    got, ran = _flat_tree(ck.state_to_flax(fresh)), _flat_tree(ck.state_to_flax(state))
    if epoch != ZOO_CLI_EPOCHS - 1 or got.keys() != ran.keys() or not all(
            np.array_equal(v, ran[k]) for k, v in got.items()):
        raise AssertionError("zoo cli: the last checkpoint does not restore the run's state")
    print(f"zoo cli (vgg_unet --deepsupervision): loss by epoch {losses}, the CLI's img/s by "
          f"epoch {rates}; the last checkpoint restores the run's state, {len(got)} leaves "
          f"equal [{card}]", flush=True)
    del model, fresh, state
    torch.cuda.empty_cache()

    _zero_counters()
    results = {}
    _run_cli(lambda a: results.setdefault("dice", tm.test(a)), tm.build_argparser().parse_args(
        ["--dataset", "synthetic", "--deepsupervision"]))
    counts = _counters()
    scored = results["dice"]
    if [e for e, _ in scored] != [0, ZOO_CLI_EPOCHS - 1] or not all(
            d.shape == (3,) and np.isfinite(d).all() and ((d >= 0) & (d <= 1)).all()
            for _, d in scored) or any(counts.values()):
        raise AssertionError(f"zoo eval (--deepsupervision): {scored}, launches {counts}")
    print(f"zoo eval (test_multiclass --deepsupervision): per-organ Dice by epoch "
          f"{[(e, [round(float(x), 6) for x in d]) for e, d in scored]}, no kernel launched",
          flush=True)

    (work / "depthwise").mkdir()
    os.chdir(work / "depthwise")
    args = scli.build_argparser().parse_args(
        CLI_FLAGS + ["--depthwiseconv", "--num_epochs", str(ZOO_SEQ_EPOCHS)])
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    out = _run_cli(scli.train, args)
    torch.cuda.synchronize()
    counts = _counters()
    epochs = re.findall(r"^Epoch (\d+): loss (\S+) \(([\d.]+) img/s", out, re.M)
    want = {k: 0 for k in counts}
    want["loss_sums_fwd"] = want["loss_sums_bwd"] = 2 * ZOO_SEQ_EPOCHS
    if counts != want or len(epochs) != ZOO_SEQ_EPOCHS or "finished training" not in out \
            or not all(math.isfinite(float(e[1])) for e in epochs):
        raise AssertionError(f"zoo sequential cli (--depthwiseconv): launches {counts}, "
                             f"expected {want}; epochs {epochs}")
    print(f"zoo sequential cli (--depthwiseconv): {time.perf_counter() - t0:.2f} s wall, loss "
          f"by epoch {[float(e[1]) for e in epochs]}, img/s {[float(e[2]) for e in epochs]}, "
          f"launches {counts} [{card}]", flush=True)
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def check_phase9(card: str) -> dict:
    """Phase 9; returns each kernel's launches over its counted runs."""
    import os
    import shutil
    import tempfile

    import torch

    from ecologysemanticsegmentation_torch.data import augment as aug

    t0 = time.perf_counter()
    check_zoo_small_steps()
    torch.cuda.empty_cache()
    launches = check_zoo_full(card)
    aug.TILED_CLAHE = False
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_phase9_"))
    cwd, env = os.getcwd(), dict(os.environ)
    try:
        os.chdir(work)
        for k, n in check_zoo_clis(card).items():
            launches[k] = launches.get(k, 0) + n
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# Phase 6: four ranks on the one card over gloo (NCCL refuses two ranks on
# one device; gloo stages the collectives through host memory).
PAR_WORLD = 4
PAR_TIMEOUT_S = 600      # the whole phase; a hang fails the run
PAR_SMALL = dict(img=64, batch=4, organs=3, features=32)  # float64, dropout 0
PAR_SMALL_CASES = [("flagship", 2), ("sequential", 2), ("flagship", 1)]  # (step, model axis)
PAR_FULL = dict(img=512, batch=16, organs=3, model_parallel=2, steps=13, timed=10)
# Adam's first step is about lr * sign(g), so where g is as small as its
# rounding a parameter may move by up to 2 lr the other way (the JAX
# spatial test's 2e-3 at lr 1e-3).
PAR_LR = 1e-3


def _digest(tensors) -> str:
    """sha256 of named tensors' bytes: bitwise equality across ranks."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _small_step(kind: str, mesh=None) -> dict:
    """One unaugmented float64 step on the card (64 px, batch 4, decoder
    32, dropout 0) from seed-0 weights: metrics, gradients, parameters,
    buffers."""
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.models import DeepLabV3Plus

    lowres = kind == "flagship"
    cfg = PAR_SMALL
    model = DeepLabV3Plus(num_classes=cfg["organs"], decoder_features=cfg["features"],
                          aspp_dropout=0.0, upsample_head=not lowres).to(
        device="cuda", dtype=torch.float64, memory_format=torch.channels_last)
    tx = est.make_optimizer(PAR_LR)
    state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = est.make_train_step(model, tx, composite_mode="none" if lowres else "sequential",
                               augment=False, lowres_head=lowres, spatial_mesh=mesh)
    batch = _batch(cfg["batch"], cfg["img"], cfg["organs"], "cuda", seed=2)
    batch["image"] = batch["image"] * 0.5 + torch.linspace(0.0, 0.5, cfg["batch"],
                                                           device="cuda")[:, None, None, None]
    _, met = step(state, batch, torch.Generator(device="cuda").manual_seed(1), 0.0,
                  [1.0, 0.5, 0.7], PAR_LR, None)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def _parallel_rank(rank: int, port: int, queue) -> None:
    """Phase 6 on one rank: (a) the small float64 steps on each grid
    against the one-rank step on the card; (b) the full-width spatial
    flagship run, counted.  Puts this rank's results on ``queue``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.data import augment as aug
    from ecologysemanticsegmentation_torch.parallel import (
        all_reduce_grads,
        broadcast_state,
        create_mesh,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=PAR_WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        out = {"rank": rank, "small": {}}
        # (a) small float64 steps, each against the one-rank step on the card
        refs = {kind: _small_step(kind) for kind in ("flagship", "sequential")}
        for kind, model_parallel in PAR_SMALL_CASES:
            mesh = create_mesh(model_parallel, device="cuda")
            _zero_counters()
            got = _small_step(kind, mesh)
            counts = _counters()
            want = refs[kind]
            diffs = torch.cat([(got["params"][k] - want["params"][k]).abs().reshape(-1)
                               for k in want["params"]])
            out["small"][(kind, mesh.data, mesh.model)] = {
                "loss": got["metrics"]["loss"], "want_loss": want["metrics"]["loss"],
                "grads": max((got["grads"][k] - want["grads"][k]).abs().max().item()
                             / max(want["grads"][k].abs().max().item(), 1e-30)
                             for k in want["grads"]),
                "params": diffs.max().item(), "params_mean": diffs.mean().item(),
                "buffers": max((got["buffers"][k] - want["buffers"][k]).abs().max().item()
                               for k in want["buffers"]),
                "digest": _digest(sorted(got["params"].items()) + sorted(got["buffers"].items())),
                "counts": counts}
        del refs
        # (b) the full-width spatial flagship run
        cfg = PAR_FULL
        mesh = create_mesh(cfg["model_parallel"], device="cuda")
        aug.TILED_CLAHE = False
        model = est.build_model("deeplabv3plus", num_classes=cfg["organs"], upsample_head=False)
        tx = est.make_optimizer(3e-4)
        state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
        broadcast_state(model, mesh)
        step = est.make_train_step(model, tx, augment=True, lowres_head=True, spatial_mesh=mesh)
        batch = _batch(cfg["batch"], cfg["img"], cfg["organs"], "cuda", seed=4)
        rng = (torch.Generator().manual_seed(2),
               torch.Generator(device="cuda").manual_seed(1 + 1000 * mesh.data_index))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        losses, warm = [], cfg["steps"] - cfg["timed"]
        for i in range(cfg["steps"]):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, met = step(state, batch, rng, 0.0, [1.0, 1.0, 1.0], 3e-4, None)
            losses.append(met["loss"])
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / cfg["timed"]
        out["counts"] = _counters()
        out["losses"] = [float(x) for x in losses]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["digest"] = _digest(sorted(model.named_parameters()) + sorted(model.named_buffers()))
        out["grid"] = (mesh.data, mesh.model)
        # What the step's collectives cost alone: the gradient all-reduce
        # (every parameter, one buffer) and one small all-reduce (a
        # BatchNorm layer's sums), each timed over the world.
        out["grad_allreduce_ms"] = _time_ms(
            lambda: all_reduce_grads(model.parameters(), mesh.world), iters=5, warmup=1)
        small = torch.zeros(2 * 512 + 1, device="cuda")
        out["small_allreduce_ms"] = _time_ms(lambda: dist.all_reduce(small, group=mesh.world),
                                             iters=50, warmup=5)
        queue.put(out)
    finally:
        dist.destroy_process_group()


def check_parallel(card: str) -> dict:
    """Phase 6: spawn ``PAR_WORLD`` ranks on cuda:0 over gloo, each running
    :func:`_parallel_rank`; any rank's failure, or the phase outliving
    ``PAR_TIMEOUT_S``, fails the run.  Checks (a) every small step against
    the one-rank step (loss within 1e-5 relative, gradients within 1e-5 of
    each tensor's scale, parameters within 2 lr, BN statistics 1e-12,
    parameters and buffers bitwise equal on every rank, each rank's launches
    those of one step of its path) and (b) the
    full-width run (finite, falling loss equal on every rank; parameters and
    buffers bitwise equal on every rank; 13 + 13 per-shard head-loss
    launches on each rank and no other kernel's).  Returns rank 0's counts
    of (b)."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = mp.start_processes(_parallel_rank, args=(port, q), nprocs=PAR_WORLD, join=False,
                               start_method="spawn")
    results = []
    try:
        while len(results) < PAR_WORLD:
            if time.perf_counter() - t0 > PAR_TIMEOUT_S:
                raise TimeoutError(f"phase 6 ran past {PAR_TIMEOUT_S} s")
            procs.join(timeout=0.01)  # raises if a rank failed
            try:
                results.append(q.get(timeout=1.0))
            except queue_mod.Empty:
                pass
        while not procs.join(timeout=1.0):
            if time.perf_counter() - t0 > PAR_TIMEOUT_S:
                raise TimeoutError(f"phase 6 ran past {PAR_TIMEOUT_S} s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.terminate()
    results.sort(key=lambda r: r["rank"])
    print(f"parallel: {PAR_WORLD} ranks on one card over gloo, {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (a)
    for key in results[0]["small"]:
        kind, data, model = key
        for res in results:
            r = res["small"][key]
            rel = abs(r["loss"] - r["want_loss"]) / max(abs(r["want_loss"]), 1.0)
            ok = (math.isfinite(r["loss"]) and rel < 1e-5 and r["grads"] <= 1e-5
                  and r["params"] <= 2 * PAR_LR + 1e-6 and r["params_mean"] < 1e-2 * PAR_LR
                  and r["buffers"] <= 1e-12)
            if not ok:
                raise AssertionError(f"parallel small step ({kind}, grid {data} x {model}), rank "
                                     f"{res['rank']}, disagrees with the one-rank step: {r}")
        digests = {res["small"][key]["digest"] for res in results}
        if len(digests) != 1:
            raise AssertionError(f"parallel small step ({kind}, grid {data} x {model}): "
                                 f"parameters or buffers differ between ranks")
        # one step: the flagship launches the per-shard head loss once each
        # way, the sequential step the loss sums twice; nothing else
        want = {k: 0 for k in results[0]["small"][key]["counts"]}
        names = (("head_loss_shard_fwd", "head_loss_shard_bwd", 1) if kind == "flagship"
                 else ("loss_sums_fwd", "loss_sums_bwd", LOSS_SUMS_CALLS[kind]))
        want[names[0]] = want[names[1]] = names[2]
        for res in results:
            if res["small"][key]["counts"] != want:
                raise AssertionError(f"parallel small step ({kind}, grid {data} x {model}), rank "
                                     f"{res['rank']}: launches {res['small'][key]['counts']}, "
                                     f"expected {want}")
        r = results[0]["small"][key]
        print(f"parallel small step ({kind}, float64, grid {data} x {model}) = one-rank step: "
              f"loss {r['loss']:.9f} vs {r['want_loss']:.9f}, gradients {r['grads']:.3g} of "
              f"scale, params max {r['params']:.3g} mean {r['params_mean']:.3g}, BN "
              f"{r['buffers']:.3g}; equal on all ranks; launches {r['counts']}", flush=True)

    # (b)
    cfg = PAR_FULL
    losses = results[0]["losses"]
    for res in results:
        print(f"parallel full-width run, rank {res['rank']} (grid {res['grid'][0]} x "
              f"{res['grid'][1]}): {res['step_ms']:.3f} ms/step, peak {res['peak_gib']:.3f} GiB "
              f"allocated, launches {res['counts']}; alone: gradient all-reduce "
              f"{res['grad_allreduce_ms']:.3f} ms, a BatchNorm-sized all-reduce "
              f"{res['small_allreduce_ms']:.3f} ms [{card}; {PAR_WORLD} ranks time-sharing one "
              f"card, collectives staged through host memory: not a multi-card figure]",
              flush=True)
        if res["losses"] != losses:
            raise AssertionError(f"parallel run: rank {res['rank']}'s losses differ from rank 0's")
        want = {k: 0 for k in res["counts"]}
        want["head_loss_shard_fwd"] = want["head_loss_shard_bwd"] = cfg["steps"]
        if res["counts"] != want:
            raise AssertionError(f"parallel run, rank {res['rank']}: launches {res['counts']}, "
                                 f"expected {want}")
    print(f"parallel full-width run (DeepLabV3+ resnet34, decoder 256, C = {cfg['organs']}, "
          f"{cfg['img']} px, global batch {cfg['batch']}, augment=True global CLAHE, bf16 "
          f"autocast): losses {[round(x, 5) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"parallel run: loss not finite or not falling: {losses}")
    if len({res["digest"] for res in results}) != 1:
        raise AssertionError("parallel run: parameters or buffers differ between ranks")
    print("parallel full-width run: parameters and BN buffers bitwise equal on every rank",
          flush=True)
    return results[0]["counts"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ecologysemanticsegmentation_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--loss-sums-times"] and len(sys.argv) <= 3:
        tree = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else ROOT
        sys.path.insert(0, str(tree))
        from ecologysemanticsegmentation_torch.ops import loss_sums
        card = _card()
        print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; the "
              f"loss-sums kernels of {tree}", flush=True)
        loss_sums.library()
        time_loss_sums(loss_sums, card)
        return 0
    if sys.argv[1:2] == ["--clahe-times"] and len(sys.argv) <= 3:
        tree = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else ROOT
        sys.path.insert(0, str(tree))
        from ecologysemanticsegmentation_torch.ops import clahe_tiled
        card = _card()
        print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; the "
              f"tiled-CLAHE apply of {tree}", flush=True)
        clahe_tiled.library()
        time_clahe(clahe_tiled, card, variants=not _parent_route(clahe_tiled))
        return 0
    sys.path.insert(0, str(ROOT))
    from ecologysemanticsegmentation_torch.ops import _build, clahe_tiled, head_loss, loss_sums

    # Phase 1: device.
    card = _card()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    if sys.argv[1:] == ["--mutants"]:
        check_mutants()
        return 0
    if sys.argv[1:] == ["--zoo"]:
        _build.build(["head_loss", "loss_sums"])
        head_loss.library()
        loss_sums.library()
        check_phase9(card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    # Phase 2: build.
    t0 = time.perf_counter()
    _build.build(["head_loss", "clahe_tiled", "loss_sums"])
    head_loss.library()
    clahe_tiled.library()
    loss_sums.library()
    for name, info in _build.build_info.items():
        print(f"build {name}: {info['seconds']:.2f} s", flush=True)
        for entry, usage in _ptxas_usage(info["log"]):
            print(f"  ptxas {entry}: {usage}", flush=True)
            if entry in NO_SPILL and _spills(usage):
                raise AssertionError(f"{entry} spills registers at a main path's C")
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    # Phase 3: kernels against their plain versions.
    report = check_kernels(card)
    report.update(check_shard_kernels(card))
    report.update(check_clahe(card))
    report.update(check_loss_sums(card))
    check_augment()
    check_small_step()
    # Phases 4 and 5: the main path, counted.
    counts = run_main_path(card)
    torch.cuda.empty_cache()
    # Phase 7: the trainer CLI, counted run by run.
    cli_counts = check_cli(card)
    torch.cuda.empty_cache()
    # Phase 8: per-sample augmentation, the sequential CLI, the eval CLIs.
    phase8 = check_phase8(card)
    torch.cuda.empty_cache()
    # Phase 9: the rest of the model zoo, its CLIs.
    zoo = check_phase9(card)
    # Phase 6: the parallel paths, counted on each rank.
    counts.update({k: v for k, v in check_parallel(card).items() if k.startswith("head_loss_shard")})
    for name, entry in report.items():
        entry["launches"] = counts[name]
        entry["cli_launches"] = cli_counts.get(name, 0)
        entry["per_sample_launches"] = phase8["per_sample"][name]
        entry["seq_cli_launches"] = phase8["sequential_cli"][name]
        entry["zoo_launches"] = zoo.get(name, 0)
    print(json.dumps({"kernels": list(report.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
