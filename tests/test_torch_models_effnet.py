"""The port's EfficientNetV2-S U-Net held against the JAX package's, from
the same weights, on the CPU at 32 px, batch 2, C = 3: the flax tree of the
full V2-S plan (``depth_multiplier`` 1.0), from ``jax.eval_shape(model.init,
...)``, equals the port's key for key and shape for shape, both ways; at
``depth_multiplier`` 0.2 the model's eval forward matches in float64 at
``_torch_models.TOL``, and the encoder's pyramid has the JAX widths.  Train
mode is held by the blocks' tests and the card's small step: the JAX model
draws its stochastic-depth masks (p = 0.05, fixed inside) from JAX's own
streams.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ecologysemanticsegmentation_tpu.models import efficientnet_v2s as jeff
from ecologysemanticsegmentation_torch.models import EfficientNetV2SUNet, build_model
from _torch_models import TOL, assert_same_tree, jax_apply, load, perturbed_variables
from _torch_parallel_ranks import bound_threads

bound_threads()

CLASSES, IMG, BATCH = 3, 32, 2


def test_flax_tree_full_depth():
    port = build_model("efficientnet_v2s_unet", CLASSES, device="cpu")
    assert_same_tree(jeff.EfficientNetV2SUNet(CLASSES), port)
    # 2 + 4 + 4 + 6 + 9 + 15 blocks
    assert len([n for n, _ in port.encoder.named_children() if n.startswith("stage")]) == 40


def test_forward_eval_and_features():
    images = np.random.RandomState(1).rand(BATCH, IMG, IMG, 3)
    port = EfficientNetV2SUNet(CLASSES, depth_multiplier=0.2)
    variables = perturbed_variables(port)
    port = load(port, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images))
        feats = port.encoder(torch.from_numpy(images).permute(0, 3, 1, 2))
    want = jax_apply(jeff.EfficientNetV2SUNet(CLASSES, 0.2, dtype=jnp.float64), variables,
                     images, train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, IMG, IMG, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # [/2, /4, /8, /16, /32]: the tensors before each stride-2 block, then the last
    assert [tuple(f.shape[1:]) for f in feats] == [(24, 16, 16), (48, 8, 8), (64, 4, 4),
                                                   (160, 2, 2), (256, 1, 1)]
