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

The trees come out with their keys sorted at every level, as
``jax.device_get`` leaves them, so a checkpoint packs to the JAX package's
bytes.

:func:`optimizer_to_flax` and :func:`optimizer_from_flax` map the
optimizer of ``train.make_optimizer(lr, grad_accum)`` to and from the
``opt_state`` of the JAX package's ``make_optimizer``
(``inject_hyperparams(adam)``, wrapped in ``MultiSteps`` when
``grad_accum > 1``): Adam's ``exp_avg`` and ``exp_avg_sq`` are ``mu`` and
``nu`` (parameter names and layouts as above), the per-tensor ``step`` is
``count``, ``param_groups[0]["lr"]`` is ``hyperparams/learning_rate``, and
``MultiSteps``'s accumulator, ``mini_step`` and update count are
``acc_grads``, ``mini_step`` and ``gradient_step``.

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


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


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
    return {"params": _sorted(params), "batch_stats": _sorted(stats)}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _i32(x) -> np.ndarray:
    return np.asarray(x, np.int32)


def _adam(optimizer):
    """The Adam inside ``optimizer`` (itself, or a ``MultiSteps``'s inner)."""
    return getattr(optimizer, "inner", optimizer)


def optimizer_to_flax(model: torch.nn.Module, optimizer) -> dict:
    """The JAX package's ``opt_state`` of ``model``'s optimizer, numpy."""
    adam = _adam(optimizer)
    named = list(model.named_parameters())
    states = [adam.state.get(p, {}) for _, p in named]
    count = int(states[0]["step"]) if "step" in states[0] else 0

    def moment(key):
        return to_flax_variables({
            n: s[key] if key in s else torch.zeros_like(p)
            for (n, p), s in zip(named, states)})["params"]

    group = adam.param_groups[0]
    b1, b2 = group["betas"]
    inner = {
        "count": _i32(count),
        "hyperparams": {"b1": _f32(b1), "b2": _f32(b2), "eps": _f32(group["eps"]),
                        "eps_root": _f32(0.0), "learning_rate": _f32(group["lr"])},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": _i32(count), "mu": moment("exp_avg"),
                              "nu": moment("exp_avg_sq")}, "1": {}},
    }
    if adam is optimizer:
        return inner
    acc = dict(zip(optimizer._params, optimizer._acc))
    return {
        "mini_step": _i32(optimizer.mini_step),
        "gradient_step": _i32(count),
        "inner_opt_state": inner,
        "acc_grads": to_flax_variables({n: acc[p] for n, p in named})["params"],
        "skip_state": {},
    }


@torch.no_grad()
def optimizer_from_flax(model: torch.nn.Module, optimizer, opt_state: Mapping) -> None:
    """Load the JAX package's ``opt_state`` into ``model``'s optimizer, in
    place.  Adam's betas and eps stay the optimizer's; a count of 0 leaves
    Adam's state empty, as a fresh optimizer's is."""
    adam = _adam(optimizer)
    inner = opt_state if adam is optimizer else opt_state["inner_opt_state"]
    adam_state = inner["inner_state"]["0"]
    count = int(adam_state["count"])
    mu = from_flax_variables({"params": adam_state["mu"]})
    nu = from_flax_variables({"params": adam_state["nu"]})
    for n, p in model.named_parameters():
        adam.state.pop(p, None)
        if count:
            adam.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                             "exp_avg": torch.empty_like(p).copy_(mu[n]),
                             "exp_avg_sq": torch.empty_like(p).copy_(nu[n])}
    for group in adam.param_groups:
        group["lr"] = float(inner["hyperparams"]["learning_rate"])
    if adam is not optimizer:
        optimizer.mini_step = int(opt_state["mini_step"])
        acc = from_flax_variables({"params": opt_state["acc_grads"]})
        by_param = dict(zip(optimizer._params, optimizer._acc))
        for n, p in model.named_parameters():
            by_param[p].copy_(acc[n])
