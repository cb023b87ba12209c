"""The port's DeepLabV3+ (ecologysemanticsegmentation_torch/models) held
against the JAX package's flax module, from the same weights.

Both run in float32 on the CPU at 64 px, batch 2, with ``aspp_dropout=0``
(the two frameworks' random streams cannot match) and narrow decoder
features (32).  BatchNorm scales, biases and statistics are perturbed away
from their init so that a wrong leaf mapping shows.  Tolerance: rtol 1e-4 /
atol 1e-4 on eval logits and on BN statistics (f32 convolutions over ~40
layers, summed in another order by the two backends); atol 5e-4 (2e-4 of
the logits' range of ~2.3) on train-mode logits, where normalizing with
batch-2 statistics amplifies the rounding (flax takes the variance as
E[x^2] - E[x]^2, torch in two passes).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ecologysemanticsegmentation_tpu.models.deeplabv3plus import DeepLabV3Plus as FlaxDeepLab
from ecologysemanticsegmentation_torch.models import DeepLabV3Plus, from_flax_variables
from ecologysemanticsegmentation_torch.models import to_flax_variables
from ecologysemanticsegmentation_torch.train import init_weights
from _torch_parallel_ranks import bound_threads

bound_threads()

TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-4, atol=5e-4)
NUM_CLASSES, FEATURES, IMG, BATCH = 3, 32, 64, 2


def _flax(upsample_head):
    return FlaxDeepLab(num_classes=NUM_CLASSES, decoder_features=FEATURES, aspp_dropout=0.0,
                       upsample_head=upsample_head, dtype=jnp.float32)


@pytest.fixture(scope="module")
def variables():
    """Random flax variables, made through the port (flax's own ``init``
    costs ~30 s of eager tracing): lecun-normal kernels from a seeded
    generator, then perturbed BatchNorm leaves."""
    m = DeepLabV3Plus(num_classes=NUM_CLASSES, decoder_features=FEATURES)
    init_weights(m, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    out = {}
    for col, tree in to_flax_variables(m.state_dict()).items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            if path[-1] == "scale":
                a = 1.0 + 0.1 * rs.randn(*a.shape)
            elif path[-1] == "bias" or path[-1] == "mean":
                a = 0.1 * rs.randn(*a.shape)
            elif path[-1] == "var":
                a = rs.uniform(0.5, 1.5, a.shape)
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).rand(BATCH, IMG, IMG, 3).astype(np.float32)


def _port(variables, upsample_head):
    m = DeepLabV3Plus(num_classes=NUM_CLASSES, decoder_features=FEATURES, aspp_dropout=0.0,
                      upsample_head=upsample_head).to(memory_format=torch.channels_last)
    m.load_state_dict(from_flax_variables(variables))
    return m


def test_weight_bridge_round_trip(variables):
    back = to_flax_variables(from_flax_variables(variables))
    for col in ("params", "batch_stats"):
        want, got = flatten_dict(variables[col]), flatten_dict(back[col])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # every leaf of the port's state_dict is covered by the flax tree
    assert set(from_flax_variables(variables)) == set(_port(variables, True).state_dict())


@pytest.mark.parametrize("upsample_head", [True, False])
def test_forward_eval(variables, images, upsample_head):
    want = _flax(upsample_head).apply(variables, jnp.asarray(images), train=False)
    m = _port(variables, upsample_head).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(images))
    assert got.dtype == torch.float32
    scale = IMG if upsample_head else IMG // 4
    assert tuple(got.shape) == (BATCH, scale, scale, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("upsample_head", [True, False])
def test_forward_train_and_bn_stats(variables, images, upsample_head):
    want, mutated = _flax(upsample_head).apply(variables, jnp.asarray(images), train=True,
                                               mutable=["batch_stats"])
    m = _port(variables, upsample_head).train()
    with torch.no_grad():
        got = m(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAIN_TOL)
    stats = flatten_dict(to_flax_variables(m.state_dict())["batch_stats"])
    want_stats = flatten_dict(mutated["batch_stats"])
    assert set(stats) == set(want_stats)
    for k, a in want_stats.items():
        np.testing.assert_allclose(stats[k], np.asarray(a), err_msg="/".join(k), **TOL)
    # flax's biased running variance: at the ASPP pool branch (a 1x1 map,
    # n = batch = 2) torch.nn.BatchNorm2d's unbiased update would differ 2x
    k = ("aspp", "pool_conv", "bn", "var")
    moved = np.abs(np.asarray(want_stats[k]) - flatten_dict(variables["batch_stats"])[k])
    assert moved.max() > 1e-3
