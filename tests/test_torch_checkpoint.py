"""Checkpoint interchange between the port and the JAX package, both ways,
at ``grad_accum`` 1 and 2, without compiling a JAX model.

The port's state is a small model of the port's own layers (conv, flax
BatchNorm, separable conv, a biased 1x1 head), named as flax names them;
the JAX template is ``TrainState(step, params, batch_stats,
make_optimizer(lr, grad_accum=k).init(params))`` built from the port
model's ``to_flax_variables``.

* port save -> JAX ``load_recent_model``: every leaf equal, the file the
  bytes flax writes, Adam's moments, counts and the ``MultiSteps``
  accumulator where the mapping puts them;
* JAX ``save_checkpoint`` -> port restore: parameters, BN statistics, Adam
  moments, counts, learning rate and the accumulator equal;
* an Adam step after the port restores the JAX file equals one after it
  restores its own file, bitwise, and the JAX package's step within f32
  rounding;
* an architecture-mismatched, an optimizer-mismatched, a truncated and a
  corrupt file give ``(-1, template)``, the template untouched.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from torch import nn

from ecologysemanticsegmentation_torch.models.common import (
    BatchNorm2d,
    ConvBNAct,
    SeparableConvBNAct,
)
from ecologysemanticsegmentation_torch.models.from_flax import to_flax_variables
from ecologysemanticsegmentation_torch.train import checkpoint as tck
from ecologysemanticsegmentation_torch.train import trainer as ttrainer
from ecologysemanticsegmentation_tpu.train import checkpoint as jck
from ecologysemanticsegmentation_tpu.train import trainer as jtrainer
from _torch_parallel_ranks import bound_threads

bound_threads()

LR = 2e-3


class Tiny(nn.Module):
    def __init__(self, classes: int = 3):
        super().__init__()
        self.stem = ConvBNAct(3, 8, 3)
        self.block = SeparableConvBNAct(8, 8)
        self.head = nn.Conv2d(8, classes, 1, bias=True)


def _port_state(k: int, classes: int = 3, seed: int = 0, steps: int = 3):
    """A port state with every part non-trivial: ``steps`` optimizer steps on
    random gradients (at k = 2 the last one left mid-accumulation), random
    BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    model = Tiny(classes)
    state = ttrainer.create_train_state(model, gen, ttrainer.make_optimizer(1e-3, grad_accum=k))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.normal_(generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        for group in state.optimizer.param_groups:
            group["lr"] = LR
        state.optimizer.step()
        state.step += 1
    return state


def _jax_template(model: nn.Module, k: int):
    v = to_flax_variables(model.state_dict())
    return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats=v["batch_stats"],
                               opt_state=jtrainer.make_optimizer(1e-3, grad_accum=k).init(v["params"]))


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(serialization.to_state_dict(tree))[0]
    return {jax.tree_util.keystr(path): np.asarray(v) for path, v in flat}


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for key in la:
        assert la[key].shape == lb[key].shape and np.array_equal(la[key], lb[key]), key


def _adam_parts(opt_state, k: int):
    inner = opt_state if k == 1 else opt_state["inner_opt_state"]
    return inner, inner["inner_state"]["0"]


def _kernel(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("k", [1, 2])
def test_port_file_restores_in_jax(tmp_path, k):
    state = _port_state(k)
    path = tck.save_checkpoint(str(tmp_path), "expt", 4, state)
    epoch, jstate = jck.load_recent_model(str(tmp_path), _jax_template(state.model, k), "expt")
    assert epoch == 4
    got = jax.device_get(jstate)
    _assert_trees_equal(got, tck.state_to_flax(state))
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(got)
    # The mapping's meaning, leaf by leaf for the head.
    opt = serialization.to_state_dict(got.opt_state)
    inner, adam = _adam_parts(opt, k)
    torch_adam = state.optimizer.inner if k > 1 else state.optimizer
    head = state.model.head.weight
    assert np.array_equal(got.params["head"]["kernel"], _kernel(head))
    assert np.array_equal(adam["mu"]["head"]["kernel"], _kernel(torch_adam.state[head]["exp_avg"]))
    assert np.array_equal(adam["nu"]["head"]["kernel"],
                          _kernel(torch_adam.state[head]["exp_avg_sq"]))
    assert int(adam["count"]) == int(inner["count"]) == (3 if k == 1 else 1)
    assert inner["hyperparams"]["learning_rate"] == np.float32(LR)
    assert int(got.step) == 3
    if k > 1:
        assert int(opt["mini_step"]) == 1 and int(opt["gradient_step"]) == 1
        acc = dict(zip(state.optimizer._params, state.optimizer._acc))
        assert np.array_equal(opt["acc_grads"]["head"]["kernel"], _kernel(acc[head]))
        assert np.abs(opt["acc_grads"]["head"]["kernel"]).max() > 0


def _jax_state(model: nn.Module, k: int, seed: int = 1, steps: int = 3):
    """A JAX state with optax updates taken on random gradients."""
    rng = np.random.RandomState(seed)
    tx = jtrainer.make_optimizer(1e-3, grad_accum=k)
    st = _jax_template(model, k)
    params = jax.tree_util.tree_map(lambda p: p + rng.randn(*p.shape).astype(np.float32) * 0.1,
                                    st.params)
    stats = jax.tree_util.tree_map(lambda s: rng.rand(*s.shape).astype(np.float32) + 0.5,
                                   st.batch_stats)
    opt_state = tx.init(params)
    for _ in range(steps):
        inner = opt_state if k == 1 else opt_state.inner_opt_state
        inner.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return tx, st.replace(step=jnp.asarray(steps, jnp.int32), params=params, batch_stats=stats,
                          opt_state=opt_state)


@pytest.mark.parametrize("k", [1, 2])
def test_jax_file_restores_in_port(tmp_path, k):
    _, jstate = _jax_state(Tiny(), k)
    jck.save_checkpoint(str(tmp_path), "expt", 5, jstate)
    state = _port_state(k, seed=3, steps=0)
    epoch, restored = tck.load_recent_model(str(tmp_path), state, "expt")
    assert epoch == 5 and restored is state
    _assert_trees_equal(jax.device_get(jstate), tck.state_to_flax(state))
    model, opt = state.model, state.optimizer
    torch_adam = opt.inner if k > 1 else opt
    js = serialization.to_state_dict(jax.device_get(jstate))
    inner, adam = _adam_parts(js["opt_state"], k)
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        node = js["params"]
        for m in mods:
            node = node[m]
        want = node["kernel" if leaf == "weight" and p.ndim == 4 else
                    "scale" if leaf == "weight" else leaf]
        assert np.array_equal(_kernel(p) if p.ndim == 4 else p.detach().numpy(), want), name
        s = torch_adam.state[p]
        assert float(s["step"]) == int(adam["count"]) == (3 if k == 1 else 1)
    assert np.array_equal(model.stem.bn.running_var.numpy(),
                          js["batch_stats"]["stem"]["bn"]["var"])
    assert np.array_equal(_kernel(torch_adam.state[model.head.weight]["exp_avg_sq"]),
                          adam["nu"]["head"]["kernel"])
    assert torch_adam.param_groups[0]["lr"] == float(np.float32(LR))
    assert state.step == 3
    if k > 1:
        assert opt.mini_step == 1
        acc = dict(zip(opt._params, opt._acc))
        assert np.array_equal(_kernel(acc[model.head.weight]),
                              js["opt_state"]["acc_grads"]["head"]["kernel"])


@pytest.mark.parametrize("k", [1, 2])
def test_adam_step_after_restore(tmp_path, k):
    tx, jstate = _jax_state(Tiny(), k)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, "expt", 5, jstate)
    a = _port_state(k, seed=5, steps=0)
    assert tck.load_recent_model(jdir, a, "expt")[0] == 5
    tck.save_checkpoint(pdir, "expt", 5, a)
    b = _port_state(k, seed=6, steps=0)
    assert tck.load_recent_model(pdir, b, "expt")[0] == 5

    rng = np.random.RandomState(9)
    params, opt_state = jstate.params, jstate.opt_state
    for _ in range(k):  # k micro-steps: one Adam update
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        named = {}  # the same gradients, in torch's layout
        for name, p in a.model.named_parameters():
            *mods, leaf = name.split(".")
            node = grads
            for m in mods:
                node = node[m]
            g = node["kernel" if leaf == "weight" and p.ndim == 4 else
                     "scale" if leaf == "weight" else leaf]
            named[name] = torch.from_numpy(np.ascontiguousarray(
                g.transpose(3, 2, 0, 1) if p.ndim == 4 else g))
        for st in (a, b):
            for name, p in st.model.named_parameters():
                p.grad = named[name].clone()
            st.optimizer.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name
    got = to_flax_variables(a.model.state_dict())["params"]
    for key, want in _leaves(params).items():
        np.testing.assert_allclose(_leaves(got)[key], want, rtol=0, atol=2e-7, err_msg=key)


def test_incompatible_and_corrupt_files_are_skipped(tmp_path):
    d = str(tmp_path)
    tck.save_checkpoint(d, "expt", 1, _port_state(1, classes=2))
    template = _port_state(1, classes=3, seed=4)
    before = {k: v.clone() for k, v in template.model.state_dict().items()}
    opt_before = tck.state_to_flax(template)["opt_state"]

    def untouched():
        assert all(torch.equal(before[k], v) for k, v in template.model.state_dict().items())
        _assert_trees_equal(opt_before, tck.state_to_flax(template)["opt_state"])
        assert template.step == 3

    assert tck.load_recent_model(d, template, "expt") == (-1, template)  # head of 2 classes
    untouched()
    tck.save_checkpoint(d, "expt", 2, _port_state(2, classes=3))  # a MultiSteps state
    assert tck.load_recent_model(d, template, "expt") == (-1, template)
    untouched()
    good = tck.save_checkpoint(d, "expt", 3, _port_state(1, classes=3, seed=8))
    with open(good, "rb") as f:
        data = f.read()
    with open(os.path.join(d, "expt_epoch4.ckpt"), "wb") as f:
        f.write(data[: len(data) // 2])
    assert tck.load_recent_model(d, template, "expt") == (-1, template)  # truncated
    untouched()
    with open(os.path.join(d, "expt_epoch5.ckpt"), "wb") as f:
        f.write(b"not a checkpoint")
    assert tck.load_recent_model(d, template, "expt") == (-1, template)
    untouched()
    assert tck.load_checkpoint_file(os.path.join(d, "expt_epoch5.ckpt"), template) is None
    assert tck.load_recent_model(d, template, "expt", epoch=9) == (-1, template)
    epoch, state = tck.load_recent_model(d, template, "expt", epoch=3)
    assert epoch == 3 and state is template
    assert tck.list_checkpoints(d, "expt") == jck.list_checkpoints(d, "expt")
    assert tck.checkpoint_path(d, "e", 7) == jck.checkpoint_path(d, "e", 7)
    # a reference .pt file is read since the .pt import (tests/test_torch_import_torch.py);
    # one that cannot be read is skipped, as any other
    with open(os.path.join(d, "ref.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    assert tck.load_checkpoint_file(os.path.join(d, "ref.pt"), template) is None
    with pytest.raises(NotImplementedError, match="item 12"):
        tck.make_checkpointer("orbax", d, "expt")
    with pytest.raises(ValueError):
        tck.make_checkpointer("bogus", d, "expt")
