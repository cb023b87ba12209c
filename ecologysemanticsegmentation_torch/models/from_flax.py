"""Weight bridge between the JAX package's flax variables and the port's
``state_dict``.

The port names its submodules as the flax tree names them, so a parameter
path ``aspp/atrous0/pointwise/kernel`` becomes ``aspp.atrous0.pointwise.weight``.
Leaves map as:

* conv ``kernel`` (KH, KW, I, O) -> ``weight`` (O, I, KH, KW); this covers
  depthwise (K, K, 1, C) -> (C, 1, K, K) and pointwise (1, 1, Cin, F) ->
  (F, Cin, 1, 1);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``; conv ``bias`` -> ``bias``;
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

Inputs and outputs are numpy (the tests pass arrays between the packages).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _insert(tree: dict, path: list[str], value: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_flax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` flax trees -> a ``state_dict``."""
    sd = {}
    for path, v in _flatten(variables["params"]):
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1)
        sd[".".join(path[:-1] + (_PARAM_LEAF[path[-1]],))] = torch.from_numpy(
            np.ascontiguousarray(a))
    for path, v in _flatten(variables.get("batch_stats", {})):
        sd[".".join(path[:-1] + (_STAT_LEAF[path[-1]],))] = torch.from_numpy(
            np.array(v, np.float32))
    return sd


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_flax_variables`: numpy ``{"params", "batch_stats"}``."""
    params: dict = {}
    stats: dict = {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            _insert(stats, mods + [leaf[len("running_"):]], a)
        elif leaf == "weight" and a.ndim == 4:
            _insert(params, mods + ["kernel"], np.ascontiguousarray(a.transpose(2, 3, 1, 0)))
        elif leaf == "weight":
            _insert(params, mods + ["scale"], a)
        else:
            _insert(params, mods + [leaf], a)
    return {"params": params, "batch_stats": stats}
