"""Device time of the flagship train step by layer, under ``torch.profiler``.

    python3 -m ecologysemanticsegmentation_torch.train.profile_step

Builds DeepLabV3+ (resnet34, full width) for C = 3 with the fused head
loss, runs three warm-up steps on a fixed random batch (batch 128 at
256 px, random weights from seed 0), then one step under the profiler
that is not recorded, then profiles three steps and prints
the device time per step of each layer (kernels grouped by name), the
device's busy share of the wall time, and the largest kernels.  Needs a
CUDA device.
"""

from __future__ import annotations

import subprocess
import time

import torch

BATCH_SIZE, IMG, WARMUP, STEPS = 128, 256, 3, 3

# Kernel-name keywords of each layer; the first match wins.
CATEGORIES = [
    ("head loss (this port's CUDA kernels)",
     ("fwd_kernel", "bwd_rows_kernel", "bwd_gather_kernel")),
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


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from .. import build_model
    from .trainer import create_train_state, make_optimizer, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = build_model("deeplabv3plus", num_classes=3, upsample_head=False)
    tx = make_optimizer(3e-4)
    state = create_train_state(model, torch.Generator().manual_seed(0), tx)
    step = make_train_step(model, tx, augment=False, lowres_head=True)
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH_SIZE, IMG, IMG, 3)
    label = (torch.rand(shape, generator=gen) > 0.5).float()
    label[torch.rand(shape, generator=gen) < 0.05] = -1.0
    batch = {"image": torch.rand(shape, generator=gen).cuda(), "label": label.cuda()}
    rng = torch.Generator(device="cuda").manual_seed(2)
    gates = [1.0, 1.0, 1.0]
    for _ in range(WARMUP):
        state, _ = step(state, batch, rng, 0.0, gates, 3e-4, None)
    torch.cuda.synchronize()

    # The profiler's first step pays its own start-up on the host; it is
    # run but not recorded.  The wall clock covers the recorded steps and
    # stops before the last ``prof.step()``, which processes the trace.
    sched = schedule(wait=0, warmup=1, active=STEPS, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for i in range(1 + STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, _ = step(state, batch, rng, 0.0, gates, 3e-4, None)
            if i == STEPS:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
            prof.step()
    events = prof.key_averages()
    # A record_function range (``Optimizer.step#Adam.step``) also shows as a
    # device event under its host op's name; only kernels are counted.
    host_ops = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host_ops]
    by_cat: dict[str, float] = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3 / STEPS
    busy = sum(by_cat.values())
    if busy == 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"profile, batch {BATCH_SIZE} at {IMG} px, {STEPS} steps under torch.profiler "
          f"[{card}]: device busy {busy:.3f} ms of {wall_ms:.3f} ms/step wall "
          f"({100 * busy / wall_ms:.1f}%)", flush=True)
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.3f} ms/step ({100 * ms / busy:.1f}%)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  kernel {e.key[:100]}: {e.self_device_time_total / 1e3 / STEPS:.3f} ms/step, "
              f"{e.count // STEPS} launches/step", flush=True)


if __name__ == "__main__":
    main()
