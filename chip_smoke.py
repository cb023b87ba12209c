#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (an exception ends the run with a non-zero
exit code before the result line is printed):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernels from ``ecologysemanticsegmentation_torch/ops/csrc``
   with nvcc;
3. kernels: every kernel against its plain PyTorch version on the card at the
   main path's shapes and at the other shapes it serves, with its time, the
   plain version's time and its bound;
4. forward: ``make_forward`` at batch 128, 256 px, full width;
5. train step: DeepLabV3+ (resnet34, full width), batch 128 at 256 px, C = 3,
   ``augment=False, lowres_head=True``, bf16 autocast; the launch counters are
   zeroed just before and read just after, and every kernel of the path must
   have launched; the loss must be finite and fall; a small batch of the same
   step on the card must agree with the step on the CPU (plain versions, f32).

The device time of the step by layer is not measured here:
``python3 -m ecologysemanticsegmentation_torch.train.profile_step`` does that.

The line before the last holds the card's name and power limit; the
``kernels`` JSON line comes before it; the last line is the device result.
Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero and prints no result.
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

# (B, h, w, H, W, C, align_corners): the main path's shape first.
SHAPES = [
    (128, 64, 64, 256, 256, 3, True),
    (128, 64, 64, 256, 256, 1, True),
    (32, 64, 64, 256, 256, 11, True),
    (3, 64, 64, 256, 256, 3, False),
    (1, 128, 128, 512, 512, 3, True),
    (1, 256, 256, 1024, 1024, 3, True),
]
SUM_RTOL = 1e-4     # 8.4 M-term f32 sums, summed in another order
GRAD_RTOL = 1e-4    # of max |dlogits|: transcendentals and projections reordered
STEP_RTOL = 3e-2    # bf16 autocast on the card against the f32 step on the CPU


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "Used N registers, ... smem") pairs from nvcc's -Xptxas -v log,
    the kernel named by its function and template argument."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+(fwd_kernel|bwd_rows_kernel|bwd_gather_kernel)"
                             r"(?:ILi(\d+)E)?", m.group(1))
            entry = f"{name.group(1)}<{name.group(2)}>" if name and name.group(2) else (
                name.group(1) if name else m.group(1))
        elif entry and "Used" in line:
            out.append((entry, "Used " + line.split("Used", 1)[1].strip()))
            entry = None
    return out


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


def check_kernels(card: str) -> dict:
    """Phase 3: each kernel against its plain version at every shape."""
    import torch

    from ecologysemanticsegmentation_torch.ops import head_loss as hl

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for shape in SHAPES:
        B, h, w, H, W, C, ac = shape
        logits, labels, cot = _head_inputs(shape, gen)
        sums = hl.head_sums_cuda(logits, labels, ac)
        ref = hl.head_sums_reference(logits, labels, ac)
        dx = hl.head_sums_bwd_cuda(logits, labels, cot, ac)
        dref = hl.head_sums_bwd_reference(logits, labels, cot, ac)
        torch.cuda.synchronize()
        fwd_err = (sums - ref).abs().max().item()
        bwd_err = (dx - dref).abs().max().item()
        fwd_ok = bool(((sums - ref).abs() <= SUM_RTOL * ref.abs() + 1e-3).all())
        bwd_ok = bwd_err <= GRAD_RTOL * dref.abs().max().item()
        exact_count = bool((sums[7] == (labels >= 0).sum((0, 1, 2)).float()).all())
        print(f"kernel check {shape}: fwd max_abs_err {fwd_err:.6g} (max |sum| "
              f"{ref.abs().max().item():.6g}), bwd max_abs_err {bwd_err:.6g} "
              f"(max |dlogits| {dref.abs().max().item():.6g}), count row exact {exact_count}",
              flush=True)
        if not (fwd_ok and bwd_ok and exact_count and torch.isfinite(dx).all()):
            raise AssertionError(f"head-loss kernel disagrees with its plain version at {shape}")
        if shape != SHAPES[0]:
            continue
        elems = B * H * W * C
        in_bytes = labels.numel() * 2 + logits.numel() * 4
        fwd_ms = _time_ms(lambda: hl.head_sums_cuda(logits, labels, ac))
        fwd_plain = _time_ms(lambda: hl.head_sums_reference(logits, labels, ac), iters=5)
        bwd_ms = _time_ms(lambda: hl.head_sums_bwd_cuda(logits, labels, cot, ac))
        bwd_plain = _time_ms(lambda: hl.head_sums_bwd_reference(logits, labels, cot, ac), iters=5)
        fb, fby = _bound(in_bytes + 8 * C * 4, elems * FWD_OPS_PER_ELEM)
        bb, bby = _bound(in_bytes + 8 * C * 4 + logits.numel() * 4, elems * BWD_OPS_PER_ELEM)
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
        print(f"kernel times at {shape} [{card}]: fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, "
              f"bound {fb:.4f} by {fby}), bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, "
              f"bound {bb:.4f} by {bby})", flush=True)
    return report


def _batch(n: int, img: int, organs: int, device: str, seed: int) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    image = torch.rand((n, img, img, 3), generator=gen)
    label = (torch.rand((n, img, img, organs), generator=gen) > 0.5).float()
    label[torch.rand(label.shape, generator=gen) < 0.05] = -1.0
    return {"image": image.to(device), "label": label.to(device)}


def check_small_step() -> None:
    """The same step, same weights and batch (batch 2, 64 px, dropout off),
    on the card (kernels, bf16 autocast) and on the CPU (plain, f32)."""
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.models import DeepLabV3Plus

    metrics = {}
    for device in ("cuda", "cpu"):
        model = DeepLabV3Plus(num_classes=3, aspp_dropout=0.0, upsample_head=False).to(
            device=device, memory_format=torch.channels_last)
        tx = est.make_optimizer(3e-4)
        state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
        step = est.make_train_step(model, tx)
        rng = torch.Generator(device=device).manual_seed(1)
        _, met = step(state, _batch(2, 64, 3, device, seed=2), rng, 0.0, [1.0, 1.0, 1.0],
                      3e-4, None)
        metrics[device] = {k: float(v) for k, v in met.items()}
    for k, want in metrics["cpu"].items():
        got = metrics["cuda"][k]
        if not (math.isfinite(got) and abs(got - want) <= STEP_RTOL * abs(want) + 1e-4):
            raise AssertionError(f"small step on the card: {k} {got} vs CPU {want}")
    print(f"small step agrees with the CPU step (rtol {STEP_RTOL}): loss "
          f"{metrics['cuda']['loss']:.6f} vs {metrics['cpu']['loss']:.6f}", flush=True)


def run_main_path(card: str) -> dict:
    """Phases 4 and 5 on the full-width flagship model; returns the launch
    counts of the run."""
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.ops import head_loss as hl

    batch_size, img, organs = 128, 256, 3
    for k in hl.launches:
        hl.launches[k] = 0

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
    del fmodel, fstate, probs

    # Phase 5: the train step.
    model = est.build_model("deeplabv3plus", num_classes=organs, upsample_head=False)
    tx = est.make_optimizer(3e-4)
    state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = est.make_train_step(model, tx, augment=False, lowres_head=True)
    batch = _batch(batch_size, img, organs, "cuda", seed=4)
    rng = torch.Generator(device="cuda").manual_seed(1)
    gates = [1.0, 1.0, 1.0]
    torch.cuda.reset_peak_memory_stats()
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
    losses = [float(x) for x in losses]
    counts = dict(hl.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step: losses {[round(x, 5) for x in losses]}", flush=True)
    print(f"train step: {step_ms:.3f} ms/step, {batch_size * 1e3 / step_ms:.2f} img/s, "
          f"peak {peak / 2**30:.3f} GiB allocated, launches {counts} [{card}]", flush=True)
    steps = 3 + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train step: non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train step: loss did not fall ({losses[0]} -> {losses[-1]})")
    if counts != {"head_loss_fwd": steps, "head_loss_bwd": steps}:
        raise AssertionError(f"train step did not run the kernels once per step: {counts}")
    return counts


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
    sys.path.insert(0, str(ROOT))
    from ecologysemanticsegmentation_torch.ops import _build, head_loss

    # Phase 1: device.
    card = _card()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    # Phase 2: build.
    t0 = time.perf_counter()
    head_loss.library()
    for name, info in _build.build_info.items():
        print(f"build {name}: {info['seconds']:.2f} s", flush=True)
        for entry, usage in _ptxas_usage(info["log"]):
            print(f"  ptxas {entry}: {usage}", flush=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    # Phase 3: kernels against their plain versions.
    report = check_kernels(card)
    check_small_step()
    # Phases 4 and 5: the main path, counted.
    counts = run_main_path(card)
    for name, entry in report.items():
        entry["launches"] = counts[name]
    print(json.dumps({"kernels": list(report.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
