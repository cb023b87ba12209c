"""Rank side of the port's parallel tests: four gloo processes on the CPU.

Imported by the spawned ranks (it imports no JAX) and by the tests, which
run the same deterministic inputs, weights and steps on one rank to hold
the ranks' results against.  :func:`run_ranks` spawns the ranks, bounds
them by a timeout (a hang fails the test) and returns each rank's results.

Sizes: DeepLabV3+ (resnet34, decoder 32, ASPP dropout 0) at 64 px, batch 4,
float64 weights, C = 3: the smallest image whose 1/16 map splits over four
row blocks.
"""

from __future__ import annotations

import copy
import datetime
import functools
import hashlib
import os
import socket
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ecologysemanticsegmentation_torch import make_optimizer, make_train_step
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus
from ecologysemanticsegmentation_torch.ops import loss_sums as tls
from ecologysemanticsegmentation_torch.parallel import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    create_mesh,
    halo_exchange,
    shard_batch,
)
from ecologysemanticsegmentation_torch.train import TrainState, init_weights

WORLD = 4
IMG, BATCH, ORGANS, FEATURES = 64, 4, 3, 32
LR = 1e-3
GATES = [1.0, 0.5, 0.7]
# (model_parallel) -> the (data, model) grids of the world of 4
GRIDS = (2, 1, 4)
# Halo shapes: (top, bottom); with blocks of 2 rows, (3, 2) reaches two
# ranks up.
HALOS = ((1, 1), (1, 0), (2, 2), (3, 2))


# ---------------------------------------------------------------- inputs


@functools.lru_cache(maxsize=None)
def _initial_model(upsample_head: bool) -> DeepLabV3Plus:
    model = DeepLabV3Plus(num_classes=ORGANS, decoder_features=FEATURES, aspp_dropout=0.0,
                          upsample_head=upsample_head)
    model = model.to(torch.float64, memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def build_model(upsample_head: bool) -> DeepLabV3Plus:
    """A fresh copy of the model initialized from seed 0."""
    return copy.deepcopy(_initial_model(upsample_head))


def images() -> torch.Tensor:
    """Images of unlike brightness (a 1x1 BatchNorm over equal-mean images
    sits at var ~ 0, where its gradient is rounding noise)."""
    g = torch.Generator().manual_seed(3)
    return (torch.rand((BATCH, IMG, IMG, 3), generator=g, dtype=torch.float64) * 0.5
            + torch.linspace(0.0, 0.5, BATCH, dtype=torch.float64)[:, None, None, None])


def batch() -> dict:
    """The step's batch: labels in {0, 1, 2} (a 2 that label prep
    binarizes) with 5% -1 ignores."""
    g = torch.Generator().manual_seed(4)
    label = torch.randint(0, 3, (BATCH, IMG, IMG, ORGANS), generator=g).float()
    label[torch.rand(label.shape, generator=g) < 0.05] = -1.0
    return {"image": images().float(), "label": label}


def output_weights(shape) -> torch.Tensor:
    """A fixed linear functional of the model's output, for its gradients."""
    g = torch.Generator().manual_seed(5)
    return torch.randn(shape, generator=g, dtype=torch.float64)


def loss_sums_inputs():
    """tests/test_head_loss_spatial.py's loss-sums shapes: B 8, 64 px, C 3."""
    rs = np.random.RandomState(3)
    probs = 1.0 / (1.0 + np.exp(-rs.randn(8, 64, 64, 3)))
    labels = (np.random.RandomState(0).rand(8, 64, 64, 3) > 0.5).astype(np.float32)
    cot = np.random.RandomState(4).randn(8, 3).astype(np.float32)
    return probs.astype(np.float32), labels, cot


# ------------------------------------------------------------- one step


def model_run(model, imgs, spatial=None, mesh=None) -> dict:
    """Train-mode forward, the gradients of a fixed functional of the
    output (summed over ranks on a mesh), and the BN buffers after."""
    model.train()
    out = model(imgs, spatial=spatial) if spatial is not None else model(imgs)
    wts = output_weights((BATCH, IMG, IMG, ORGANS))
    if mesh is not None:
        wts = shard_batch(wts, mesh, spatial=True)
    (out.double() * wts).sum().backward()
    if mesh is not None:
        all_reduce_grads(model.parameters(), mesh.world)
    return {"out": out.detach(),
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers())}


def step_run(kind: str, mesh=None) -> dict:
    """One unaugmented step ("flagship": low-resolution head loss;
    "sequential": full resolution, ``composite_mode="sequential"``) from
    the fixed weights and batch: metrics, the gradients Adam received,
    Adam's first moment, the parameters and BN buffers after."""
    lowres = kind == "flagship"
    model = build_model(upsample_head=not lowres)
    tx = make_optimizer(LR)
    state = TrainState(step=0, model=model, optimizer=tx(model.parameters()))
    step = make_train_step(model, tx, composite_mode="none" if lowres else "sequential",
                           augment=False, lowres_head=lowres, spatial_mesh=mesh)
    state, met = step(state, batch(), torch.Generator().manual_seed(1), 0.0, GATES, LR, None)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "mu": {n: state.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()},
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers())}


def digest(tensors: dict) -> str:
    """sha256 of the tensors' bytes, in name order: bitwise equality across
    ranks."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def scaled_err(got: dict, want: dict) -> float:
    """The largest ``max|got - want| / max|want|`` over the tensors."""
    return max((got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
               for k in want)


def abs_err(got: dict, want: dict) -> float:
    return max((got[k] - want[k]).abs().max().item() for k in want)


def compare_model(got: dict, want: dict, mesh) -> dict:
    block = shard_batch(want["out"], mesh, spatial=True)
    return {"out": (got["out"] - block).abs().max().item(),
            "out_scale": block.abs().max().item(),
            "grads": scaled_err(got["grads"], want["grads"]),
            "buffers": abs_err(got["buffers"], want["buffers"]),
            "buffers_digest": digest(got["buffers"])}


def compare_step(got: dict, want: dict) -> dict:
    """The one-rank step's results against this rank's: the metrics of both,
    the gradients' error relative to each tensor's scale, the parameters'
    largest and mean absolute error, the BN buffers' largest error, and
    digests of the parameters and buffers."""
    diffs = torch.cat([(got["params"][k] - want["params"][k]).abs().reshape(-1)
                       for k in want["params"]])
    return {"metrics": got["metrics"], "want_metrics": want["metrics"],
            "grads": scaled_err(got["grads"], want["grads"]),
            "params": diffs.max().item(), "params_mean": diffs.mean().item(),
            "buffers": abs_err(got["buffers"], want["buffers"]),
            "params_digest": digest(got["params"]), "buffers_digest": digest(got["buffers"])}


# ---------------------------------------------------------- collectives


def _seeded(shape, *seed) -> torch.Tensor:
    """float64 normal draws named by ``seed`` (the same in every process)."""
    g = torch.Generator().manual_seed(zlib.crc32(repr(seed).encode()))
    return torch.randn(shape, generator=g, dtype=torch.float64)


def collectives_check(mesh) -> dict:
    """Each collective's forward and backward on this rank against what the
    whole tensors give (every rank can build every rank's inputs and
    cotangents from their seeds); returns the largest errors."""
    errs = {}
    rank, world = mesh.rank, mesh.size

    # sum all-reduce over the world, both backward rules
    for rule in ("sum", "identity"):
        x = _seeded((3, 5), "ar", rank).requires_grad_()
        y = all_reduce_sum(x, mesh.world, grad=rule)
        want = sum(_seeded((3, 5), "ar", r) for r in range(world))
        y.backward(_seeded((3, 5), "ar-cot", rank))
        want_dx = (sum(_seeded((3, 5), "ar-cot", r) for r in range(world)) if rule == "sum"
                   else _seeded((3, 5), "ar-cot", rank))
        errs[f"all_reduce_sum[{rule}]"] = max((y - want).abs().max().item(),
                                              (x.grad - want_dx).abs().max().item())

    # all-gather of row blocks over the model group, NCHW rows and NHWC rows
    m, k, d = mesh.model, mesh.model_index, mesh.data_index
    for dim, shape in ((2, (2, 3, 2 * m, 5)), (1, (2, 2 * m, 5, 3))):
        full = _seeded(shape, "gather", d, dim)
        per = shape[dim] // m
        x = full.narrow(dim, k * per, per).clone().requires_grad_()
        y = all_gather_rows(x, dim, mesh.model_group, k, m)
        cots = [_seeded(shape, "gather-cot", d, dim, q) for q in range(m)]
        y.backward(cots[k])
        want_dx = sum(c.narrow(dim, k * per, per) for c in cots)
        errs[f"all_gather_rows[dim {dim}]"] = max((y - full).abs().max().item(),
                                                  (x.grad - want_dx).abs().max().item())

    # halo exchange over the model group, blocks of 2 rows, zero and -inf pads
    n = 2
    for top, bottom in HALOS:
        for pad in (0.0, float("-inf")):
            full = _seeded((2, 3, n * m, 4), "halo", d)
            x = full[:, :, k * n:(k + 1) * n].clone().requires_grad_()
            y = halo_exchange(x, top, bottom, 2, mesh.model_group, k, m, pad)
            padded = torch.cat([full.new_full((2, 3, top, 4), pad), full,
                                full.new_full((2, 3, bottom, 4), pad)], 2)
            want = padded[:, :, k * n:(k + 1) * n + top + bottom]
            shape = (2, 3, top + n + bottom, 4)
            cots = [_seeded(shape, "halo-cot", d, q, top, bottom) for q in range(m)]
            y.backward(cots[k])
            gpad = torch.zeros_like(padded)
            for q in range(m):
                gpad[:, :, q * n:q * n + top + n + bottom] += cots[q]
            want_dx = gpad[:, :, top + k * n:top + (k + 1) * n]
            fwd = (y - want).nan_to_num().abs().max().item() if pad == 0.0 else float(
                not torch.equal(y, want))
            errs[f"halo_exchange[{top},{bottom},pad {pad}]"] = max(
                fwd, (x.grad - want_dx).abs().max().item())
            # bf16 (the autocast activations): the forward is exact
            yb = halo_exchange(x.detach().bfloat16(), top, bottom, 2, mesh.model_group, k, m, pad)
            errs[f"halo_exchange[{top},{bottom},pad {pad}] bf16"] = float(
                not torch.equal(yb, want.bfloat16()))

    # gradient all-reduce: every parameter's .grad summed over the world
    params = [torch.nn.Parameter(torch.zeros(2, 3, dtype=torch.float64)),
              torch.nn.Parameter(torch.zeros(4, dtype=torch.float64))]
    params[0].grad = _seeded((2, 3), "grad", rank)
    params[1].grad = None if rank % 2 else _seeded((4,), "grad1", rank)
    all_reduce_grads(params, mesh.world)
    want0 = sum(_seeded((2, 3), "grad", r) for r in range(world))
    want1 = sum(_seeded((4,), "grad1", r) for r in range(world) if r % 2 == 0)
    errs["all_reduce_grads"] = max((params[0].grad - want0).abs().max().item(),
                                   (params[1].grad - want1).abs().max().item())
    return errs


def loss_sums_check(mesh) -> dict:
    """``loss_sums_nhwc_spatial`` on this rank's block, its gradient in the
    block's probabilities, and ``spatial_mesh_context``'s rerouting."""
    probs, labels, cot = loss_sums_inputs()
    p = shard_batch(torch.from_numpy(probs), mesh, spatial=True).contiguous().requires_grad_()
    g = shard_batch(torch.from_numpy(labels), mesh, spatial=True).contiguous()
    sums = tls.loss_sums_nhwc_spatial(p, g, mesh)
    (sums[:7] * torch.from_numpy(cot[:7])).sum().backward()
    with tls.spatial_mesh_context(mesh):
        inside = tls.loss_sums_nhwc(p.detach(), g)
    outside = tls.loss_sums_nhwc(p.detach(), g)
    return {"sums": sums.detach().numpy(), "dp": p.grad.numpy(), "inside": inside.numpy(),
            "outside": outside.numpy(), "stack_after": list(tls._SPATIAL_STACK)}


# --------------------------------------------------------------- jobs


def job_parallel(rank: int) -> dict:
    """tests/test_torch_parallel.py: on each grid, the collectives and the
    row-partitioned model; on (2, 2) the flagship and sequential steps and
    the spatial loss sums; on (4, 1) the data-parallel flagship step.  Each
    rank runs the one-rank references itself and returns its errors
    against them (the weights are too large to ship)."""
    want_model = model_run(build_model(upsample_head=True), images())
    want_steps = {kind: step_run(kind) for kind in ("flagship", "sequential")}
    results = {}
    for model_parallel in GRIDS:
        mesh = create_mesh(model_parallel, device="cpu")
        res = {"collectives": collectives_check(mesh)}
        got = model_run(build_model(upsample_head=True),
                        shard_batch(images(), mesh, spatial=True), mesh.spatial(), mesh)
        res["model"] = compare_model(got, want_model, mesh)
        kinds = {2: ("flagship", "sequential"), 1: ("flagship",)}.get(model_parallel, ())
        for kind in kinds:
            res[kind] = compare_step(step_run(kind, mesh), want_steps[kind])
        if model_parallel == 2:
            res["loss_sums"] = loss_sums_check(mesh)
        results[(mesh.data, mesh.model)] = res
    return results


def job_flagship_2x2(rank: int) -> dict:
    """tests/test_torch_parallel_jax.py: the flagship step on the (2, 2)
    grid; rank 0 also returns its parameters and Adam's first
    moment (float32: the weights are large) and its BN buffers (float64),
    the others their digests."""
    got = step_run("flagship", create_mesh(2, device="cpu"))
    out = {"metrics": got["metrics"], "params_digest": digest(got["params"]),
           "buffers_digest": digest(got["buffers"])}
    if rank == 0:
        out["params"] = {k: v.float().numpy() for k, v in got["params"].items()}
        out["mu"] = {k: v.float().numpy() for k, v in got["mu"].items()}
        out["buffers"] = {k: v.numpy() for k, v in got["buffers"].items()}
    return out


JOBS = {"parallel": job_parallel, "flagship_2x2": job_flagship_2x2}


# -------------------------------------------------------------- spawn


def bound_threads() -> None:
    """Bound torch's intra-op threads in a test process to one pytest-xdist
    worker's share of the cores, as :func:`_rank_main` bounds each rank to 1."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _rank_main(rank: int, port: int, out_dir: str, job: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(JOBS[job](rank), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: str, out_dir: Path, timeout: float = 400.0) -> list[dict]:
    """Spawn the world's ranks on ``job``; each rank's results, in rank
    order.  Any rank's failure, or the ranks outliving ``timeout``
    seconds, fails the call (and ends every rank)."""
    ctx = mp.start_processes(_rank_main, args=(_free_port(), str(out_dir), job), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks of {job!r} ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
