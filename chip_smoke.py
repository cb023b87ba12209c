#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (an exception ends the run with a non-zero
exit code before the result line is printed):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernels from ``ecologysemanticsegmentation_torch/ops/csrc``
   with nvcc, one process per source, all started together;
3. kernels: every kernel against its plain PyTorch version on the card at the
   main path's shapes and at the other shapes it serves, with its time, the
   plain version's time and its bound (the head loss also at 512, 768 and
   1024 px); device augmentation on the card against the same draws on the
   CPU, in both CLAHE forms; a small batch of the unaugmented step on the
   card against the step on the CPU (plain versions, f32);
4. forward: ``make_forward`` at batch 128, 256 px, full width;
5. train step: DeepLabV3+ (resnet34, full width), batch 128 at 256 px, C = 3,
   ``lowres_head=True``, bf16 autocast, 13 steps each of: ``augment=False``;
   ``augment=True`` with the global CLAHE; ``augment=True`` with the tiled
   CLAHE (``AUGMENT_TILED_CLAHE=1``).  For each, the launch counters are
   zeroed just before and read just after: every kernel of the path must have
   launched once per step (the tiled-CLAHE kernel in the tiled run only), and
   the loss must be finite and fall.

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
    (32, 128, 128, 512, 512, 3, True),
    (16, 192, 192, 768, 768, 3, True),
    (8, 256, 256, 1024, 1024, 3, True),
]
# Shapes whose times are printed: the main path's, and the sizes at which
# the JAX package selects its row-blocked kernels (head_loss.py:272, :298),
# at the main path's pixels per batch.
TIMED = {SHAPES[0], SHAPES[6], SHAPES[7], SHAPES[8]}

# Tiled CLAHE (B, H, W, tiles, bins): the main path's shape first.
CLAHE_SHAPES = [
    (128, 256, 256, 8, 64),
    (128, 256, 256, 8, 32),
    (1, 512, 512, 8, 64),
    (4, 192, 320, 8, 64),
]
CLAHE_ATOL = 1e-5   # f32 sums of <= K + 2 terms of magnitude <= 1, in another order
# Augmentation on the card against the CPU (bf16): every value within 2 bf16
# ulps, except on at most 1% of the pixels (a rounding difference moved the
# pixel across a CLAHE bin or a hue sector), which stay within 1/16.
AUG_ULPS, AUG_FLIP_FRAC, AUG_FLIP_MAX = 2, 0.01, 1 / 16
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
            name = re.search(r"\d+(fwd_kernel|bwd_rows_kernel|bwd_gather_kernel|clahe_apply_kernel)"
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


def _clahe_inputs(shape, gen):
    """Luminance in [0, 1] and per-tile CDF steps of random histograms."""
    import torch

    B, H, W, T, K = shape
    luma = torch.rand((B, H, W), generator=gen, device="cuda")
    hist = torch.rand((B, T, T, K), generator=gen, device="cuda") + 0.1
    cdf = torch.cumsum(hist, -1)
    cdf = cdf / cdf[..., -1:]
    return luma, torch.diff(cdf, dim=-1, prepend=torch.zeros_like(cdf[..., :1]))


def check_clahe(card: str) -> dict:
    """Phase 3: the tiled-CLAHE kernel against its plain version at every
    shape; its time, the plain version's and the bound at the main path's.
    The wrapper's x pre-contraction (an einsum) runs outside the timed
    kernel, as in the JAX package."""
    import torch

    from ecologysemanticsegmentation_torch.ops import clahe_tiled as ct

    gen = torch.Generator(device="cuda").manual_seed(5)
    report = {}
    for shape in CLAHE_SHAPES:
        B, H, W, T, K = shape
        luma, deltas = _clahe_inputs(shape, gen)
        wx, wy = ct._weights(W, T, luma.device), ct._weights(H, T, luma.device)
        gx = torch.einsum("btsk,xs->bktx", deltas, wx)
        got = ct.apply_cuda(luma, gx, T)
        want = ct._apply_reference(luma, gx, wy)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"kernel check clahe_tiled {shape}: max_abs_err {err:.6g} (max |out| "
              f"{want.abs().max().item():.6g}, atol {CLAHE_ATOL})", flush=True)
        if not (err <= CLAHE_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"tiled-CLAHE kernel disagrees with its plain version at {shape}")
        if shape != CLAHE_SHAPES[0]:
            continue
        ms = _time_ms(lambda: ct.apply_cuda(luma, gx, T))
        plain_ms = _time_ms(lambda: ct._apply_reference(luma, gx, wy), iters=5)
        # bytes: luma in, Gx in, out; operations: the two-tap form's
        # 2 taps x K bins x (mul + add) and the bin index (mul + floor)
        nbytes = (luma.numel() * 2 + gx.numel() + 2 * H) * 4 + 2 * H * 4
        bound, by = _bound(nbytes, B * H * W * (2 * 2 * K + 2))
        report["clahe_tiled"] = dict(
            name="clahe_tiled", route="cuda",
            source="ecologysemanticsegmentation_torch/ops/csrc/clahe_tiled.cu",
            replaces="ecologysemanticsegmentation_tpu/ops/pallas/clahe_tiled.py:109",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None)
        print(f"kernel times clahe_tiled at {shape} [{card}]: {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, bound {bound:.4f} by {by})", flush=True)
    return report


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


def _counters() -> dict:
    from ecologysemanticsegmentation_torch.ops import clahe_tiled, head_loss

    return {**head_loss.launches, **clahe_tiled.launches}


def _zero_counters() -> None:
    from ecologysemanticsegmentation_torch.ops import clahe_tiled, head_loss

    for launches in (head_loss.launches, clahe_tiled.launches):
        for k in launches:
            launches[k] = 0


def _train_run(card: str, augment: bool, tiled: bool) -> dict:
    """13 flagship steps (3 warm-up, 10 timed) from fresh weights; the
    counters are zeroed just before and read just after.  Returns the
    counts."""
    import torch

    import ecologysemanticsegmentation_torch as est
    from ecologysemanticsegmentation_torch.data import augment as aug

    batch_size, img, organs = 128, 256, 3
    what = ("augment=False" if not augment else
            f"augment=True, {'tiled' if tiled else 'global'} CLAHE")
    # The step reads the CLAHE form from the module flag, which
    # AUGMENT_TILED_CLAHE sets at import; both forms run in this process.
    aug.TILED_CLAHE = tiled
    model = est.build_model("deeplabv3plus", num_classes=organs, upsample_head=False)
    tx = est.make_optimizer(3e-4)
    state = est.create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = est.make_train_step(model, tx, augment=augment, lowres_head=True)
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
    steps = 3 + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train step ({what}): non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train step ({what}): loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    want = {"head_loss_fwd": steps, "head_loss_bwd": steps,
            "clahe_tiled": steps if augment and tiled else 0}
    if counts != want:
        raise AssertionError(f"train step ({what}) did not run the kernels once per step: "
                             f"{counts}, expected {want}")
    return counts


def run_main_path(card: str) -> dict:
    """Phases 4 and 5 on the full-width flagship model; returns the launch
    counts of the tiled augmented run, which goes through every kernel."""
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
    del fmodel, fstate, probs

    # Phase 5: the train step, unaugmented and augmented in both CLAHE forms.
    _train_run(card, augment=False, tiled=False)
    _train_run(card, augment=True, tiled=False)
    return _train_run(card, augment=True, tiled=True)


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
    from ecologysemanticsegmentation_torch.ops import _build, clahe_tiled, head_loss

    # Phase 1: device.
    card = _card()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    # Phase 2: build.
    t0 = time.perf_counter()
    _build.build(["head_loss", "clahe_tiled"])
    head_loss.library()
    clahe_tiled.library()
    for name, info in _build.build_info.items():
        print(f"build {name}: {info['seconds']:.2f} s", flush=True)
        for entry, usage in _ptxas_usage(info["log"]):
            print(f"  ptxas {entry}: {usage}", flush=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    # Phase 3: kernels against their plain versions.
    report = check_kernels(card)
    report.update(check_clahe(card))
    check_augment()
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
