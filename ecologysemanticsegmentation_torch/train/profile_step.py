"""Device time of the train steps by layer, under ``torch.profiler``.

    python3 -m ecologysemanticsegmentation_torch.train.profile_step
    AUGMENT_TILED_CLAHE=1 python3 -m ecologysemanticsegmentation_torch.train.profile_step
    AUGMENT_PER_SAMPLE=1 python3 -m ecologysemanticsegmentation_torch.train.profile_step

For each of the flagship step (DeepLabV3+ resnet34 at full width, C = 3,
the fused head loss), the sequential trainer's step (C = 3, full
resolution, ``composite_mode="sequential"``) and the single-organ step
(C = 1, full resolution), all with ``augment=True`` (CLAHE form from
``AUGMENT_TILED_CLAHE``, draws per batch, or per sample under
``AUGMENT_PER_SAMPLE=1``): builds the model, runs three warm-up steps on a
fixed random batch (batch 128 at 256 px, random weights from seed 0), then
one step under the profiler that is not recorded, then profiles three steps
and prints the device time per step of each layer (kernels grouped by
name), the device's busy share of the wall time, and the largest kernels.
Every step's profile sees the same augmentation draws (the same seeds,
the same number of steps before it), so the steps compare like with like.
The augmentation's own device time comes from a profile of
the step's ``augment_batch`` alone on the flagship's batch, with generators of its
own, since its kernels share names with the model's.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import time

import torch

BATCH_SIZE, IMG, WARMUP, STEPS = 128, 256, 3, 3

# The steps profiled: (what, organs, composite_mode, lowres_head).
PROFILED = [
    ("flagship", 3, "none", True),
    ("sequential", 3, "sequential", False),
    ("single organ", 1, "none", False),
]

# Kernel-name keywords of each layer; the first match wins.
CATEGORIES = [
    ("loss sums (this port's CUDA kernels)", ("loss_sums_fwd_kernel", "loss_sums_bwd_kernel")),
    ("head loss (this port's CUDA kernels)",
     ("fwd_kernel", "bwd_rows_kernel", "bwd_gather_kernel")),
    ("tiled CLAHE (this port's CUDA kernel)", ("clahe_apply_kernel",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolution (cuDNN / CUTLASS)", ("conv", "xmma", "cutlass", "cudnn", "dgrad", "wgrad",
                                       "gemm", "sm90_", "nchwtonhwc", "nhwctonchw")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("reductions", ("reduce_kernel",)),
]


def _category(kernel: str) -> str:
    name = kernel.lower()
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "elementwise and other"


def _profiled(fn, steps: int):
    """Run ``fn`` once unrecorded and ``steps`` times recorded under the
    profiler; returns the device kernels' events and the wall ms per call.
    The wall clock covers the recorded calls and stops before the last
    ``prof.step()``, which processes the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=1, active=steps, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for i in range(1 + steps):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            fn()
            if i == steps:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            prof.step()
    events = prof.key_averages()
    # A record_function range (``Optimizer.step#Adam.step``) also shows as a
    # device event under its host op's name; only kernels are counted.
    host_ops = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host_ops]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    return kernels, wall_ms


def _print_top(kernels, calls: int, per: str, n: int = 12) -> None:
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]:
        print(f"  kernel {e.key[:100]}: {e.self_device_time_total / 1e3 / calls:.3f} ms/{per}, "
              f"{e.count / calls:g} launches/{per}", flush=True)


def _batch(organs: int) -> dict:
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH_SIZE, IMG, IMG, organs)
    label = (torch.rand(shape, generator=gen) > 0.5).float()
    label[torch.rand(shape, generator=gen) < 0.05] = -1.0
    image = torch.rand((BATCH_SIZE, IMG, IMG, 3), generator=gen)
    return {"image": image.cuda(), "label": label.cuda()}


def main() -> None:
    from .. import build_model
    from ..data import augment as aug
    from . import trainer
    from .trainer import create_train_state, make_optimizer, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clahe = ("tiled" if aug.TILED_CLAHE else "global") + " CLAHE, draws per " + (
        "sample" if trainer.augment_batch is aug.augment_batch_per_sample else "batch")
    gates = [1.0, 1.0, 1.0]
    for what, organs, mode, lowres in PROFILED:
        model = build_model("deeplabv3plus", num_classes=organs, upsample_head=not lowres)
        tx = make_optimizer(3e-4)
        state = create_train_state(model, torch.Generator().manual_seed(0), tx)
        step = make_train_step(model, tx, composite_mode=mode, augment=True, lowres_head=lowres)
        batch = _batch(organs)
        rng = (torch.Generator().manual_seed(3), torch.Generator(device="cuda").manual_seed(2))
        for _ in range(WARMUP):
            state, _ = step(state, batch, rng, 0.0, gates, 3e-4, None)
        torch.cuda.synchronize()

        if what == "flagship":
            # Augmentation alone: its device time and launches per call.  Its
            # own generators leave every step's profile the same draws.
            aug_rng = (torch.Generator().manual_seed(4),
                       torch.Generator(device="cuda").manual_seed(5))
            aug_kernels, aug_wall = _profiled(
                lambda: trainer.augment_batch(aug_rng, batch["image"], batch["label"]), STEPS)
            aug_busy = sum(e.self_device_time_total for e in aug_kernels) / 1e3 / STEPS
            aug_launches = sum(e.count for e in aug_kernels) // STEPS
            print(f"profile, augment_batch alone ({clahe}), batch {BATCH_SIZE} at {IMG} "
                  f"px [{card}]: device {aug_busy:.3f} ms of {aug_wall:.3f} ms/call wall, "
                  f"{aug_launches} kernel launches/call", flush=True)
            _print_top(aug_kernels, STEPS, "call")

        def one_step():
            nonlocal state
            state, _ = step(state, batch, rng, 0.0, gates, 3e-4, None)

        kernels, wall_ms = _profiled(one_step, STEPS)
        by_cat: dict[str, float] = {}
        for e in kernels:
            cat = _category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3 / STEPS
        busy = sum(by_cat.values())
        print(f"profile, augmented {what} step ({clahe}), batch {BATCH_SIZE} at {IMG} px, "
              f"C = {organs}, {STEPS} steps under torch.profiler [{card}]: device busy "
              f"{busy:.3f} ms of {wall_ms:.3f} ms/step wall ({100 * busy / wall_ms:.1f}%), "
              f"{sum(e.count for e in kernels) // STEPS} kernel launches/step", flush=True)
        for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
            print(f"  {cat}: {ms:.3f} ms/step ({100 * ms / busy:.1f}%)", flush=True)
        _print_top(kernels, STEPS, "step")
        del model, state, step, batch


if __name__ == "__main__":
    main()
