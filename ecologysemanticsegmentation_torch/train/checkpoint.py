"""Checkpoints of the port, in the JAX package's file layout and format
(counterpart of ``ecologysemanticsegmentation_tpu/train/checkpoint.py``).

Files are ``<save_dir>/<EXPTNAME>_epoch<N>.ckpt`` under
``models/<EXPTNAME>/channels<MAXCHANNELS>/img<IMGSIZE>/``; resume globs
them and takes the largest epoch, a given epoch on request, and gives
``(-1, template)`` when nothing loads or a file is corrupt or of another
architecture.  Writes are atomic (a temporary file, then a rename).

A file holds what ``flax.serialization.to_bytes`` writes for the JAX
package's ``TrainState``: ``{step, params, batch_stats, opt_state}`` with
``opt_state`` the state of its ``make_optimizer(lr, grad_accum)``, packed
with msgpack (:mod:`._msgpack`; msgpack itself need not be installed).
The JAX package's ``load_recent_model`` restores a file of the port's, and
the port restores one of the JAX package's (:mod:`..models.from_flax` maps
the parameters and the optimizer state).  :func:`load_checkpoint_file` also
reads the reference's ``.pt`` weights.
"""

from __future__ import annotations

import glob
import os
import re
import traceback
from typing import Any

import numpy as np

from ..models.from_flax import (
    from_flax_variables,
    optimizer_from_flax,
    optimizer_to_flax,
    to_flax_variables,
)
from . import _msgpack


def state_to_flax(state) -> dict:
    """The JAX ``TrainState``'s state dict of the port's ``TrainState``, numpy."""
    variables = to_flax_variables(state.model.state_dict())
    return {
        "step": np.asarray(state.step, np.int32),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": optimizer_to_flax(state.model, state.optimizer),
    }


def _check_tree(template: Any, tree: Any, path: str = "") -> None:
    """Raise unless ``tree`` has ``template``'s keys at every level and its
    leaves' shapes (an architecture or optimizer of another kind)."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint has {got} at {path or '/'}, the state "
                             f"expects {sorted(template)} (incompatible architecture)")
        for k in template:
            _check_tree(template[k], tree[k], f"{path}/{k}")
        return
    shape = np.shape(tree) if isinstance(tree, (np.ndarray, np.generic)) else None
    if shape != np.shape(template):
        raise ValueError(f"checkpoint leaf {path} has shape {shape}, the state expects "
                         f"{np.shape(template)} (incompatible architecture)")


def state_from_flax(state, tree: dict):
    """Load a JAX ``TrainState`` state dict into ``state``, in place, after
    checking it against ``state``'s own; returns ``state``."""
    _check_tree(state_to_flax(state), tree)
    state.model.load_state_dict(from_flax_variables(tree))
    optimizer_from_flax(state.model, state.optimizer, tree["opt_state"])
    state.step = int(tree["step"])
    return state


def checkpoint_path(save_dir: str, expt_name: str, epoch: int) -> str:
    return os.path.join(save_dir, f"{expt_name}_epoch{epoch}.ckpt")


def save_checkpoint(save_dir: str, expt_name: str, epoch: int, state) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = checkpoint_path(save_dir, expt_name, epoch)
    data = _msgpack.packb(state_to_flax(state))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def _epoch_of(path: str) -> int | None:
    m = re.search(r"epoch(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def list_checkpoints(save_dir: str, expt_name: str) -> list[tuple[int, str]]:
    """All (epoch, path) pairs, ascending by epoch."""
    paths = glob.glob(os.path.join(save_dir, f"{expt_name}*"))
    pairs = [(e, p) for p in paths if (e := _epoch_of(p)) is not None]
    return sorted(pairs)


def _read(path: str, template_state):
    with open(path, "rb") as f:
        tree = _msgpack.unpackb(f.read())
    return state_from_flax(template_state, tree)


def load_recent_model(save_dir: str, template_state, expt_name: str,
                      epoch: int | None = None) -> tuple[int, Any]:
    """Resume: the latest epoch by default, ``epoch`` on request; restores
    into ``template_state`` in place.  ``(-1, template_state)``, unchanged,
    when nothing loads."""
    try:
        pairs = list_checkpoints(save_dir, expt_name)
        if not pairs:
            return -1, template_state
        if epoch is None:
            start_epoch, path = pairs[-1]
        else:
            matches = [(e, p) for e, p in pairs if e == epoch]
            if not matches:
                return -1, template_state
            start_epoch, path = matches[0]
        state = _read(path, template_state)
        print(f"Used latest model file: {path}")
        return start_epoch, state
    except Exception:
        traceback.print_exc()
        return -1, template_state


def load_checkpoint_file(path: str, template_state):
    """Load one checkpoint into ``template_state``; None when it is corrupt
    or of another architecture (the eval sweep's skip contract).

    ``.pt``/``.pth`` files are the reference's PyTorch checkpoints
    (``torch.save(net.state_dict())`` of an smp DeepLabV3Plus, bare or
    under a ``"state_dict"`` key): their weights and BatchNorm statistics
    are mapped by :func:`..models.import_torch.smp_checkpoint_to_variables`;
    the step and the optimizer stay the template's."""
    try:
        if path.endswith((".pt", ".pth")):
            return _load_torch_checkpoint(path, template_state)
        return _read(path, template_state)
    except Exception:
        traceback.print_exc()
        return None


def _load_torch_checkpoint(path: str, template_state):
    import torch

    from ..models.import_torch import smp_checkpoint_to_variables

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    variables = smp_checkpoint_to_variables(sd)
    _check_tree(to_flax_variables(template_state.model.state_dict()), variables)
    template_state.model.load_state_dict(from_flax_variables(variables))
    return template_state


def make_checkpointer(backend: str, save_dir: str, expt_name: str):
    """The trainer's checkpointing behind ``--ckpt``: ``restore(template,
    epoch)``, ``save(epoch, state)``, ``finalize()``.  Only ``msgpack`` is
    ported."""
    if backend == "msgpack":
        return _MsgpackCheckpointer(save_dir, expt_name)
    if backend == "orbax":
        raise NotImplementedError("--ckpt orbax (asynchronous checkpoints) is not ported "
                                  "yet (ROADMAP queue 1, item 12)")
    raise ValueError(f"unknown checkpoint backend: {backend}")


class _MsgpackCheckpointer:
    def __init__(self, save_dir: str, expt_name: str):
        self.save_dir, self.expt_name = save_dir, expt_name

    def restore(self, template_state, epoch: int | None = None):
        return load_recent_model(self.save_dir, template_state, self.expt_name, epoch)

    def save(self, epoch: int, state) -> None:
        save_checkpoint(self.save_dir, self.expt_name, epoch, state)

    def finalize(self) -> None:
        pass
