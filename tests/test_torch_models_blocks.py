"""The port's model building blocks held against the JAX package's, from
the same weights, in float64 on the CPU (eval mode unless stated):
``NearestUpConcatConv`` in both ``up_first`` orders, with and without a
skip, ``NearestUpDepthwiseConv``, ``ConvBNAct`` with strides, dilation,
groups, a bias, SiLU or no activation and the fused ``(low, skip)`` entry,
the nearest resizes (a non-integer ratio included), ``SqueezeExcite``,
``FusedMBConv``, ``MBConv``, ``MBDeconv`` at both strides and the
``EfficientNetDeconvDecoder``.

Also, port only: ``StochasticDropout``'s survival rate and scale, the
initializers ``init_weights`` follows, and rematerialization: a VGG U-Net
train step with dropout on (p = 0.05) gives bitwise the plain step's
gradients and BatchNorm buffers from the same generator seed, and its
replay did reuse the forward's masks.

Tolerance: ``_torch_models.TOL`` (float64 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from ecologysemanticsegmentation_tpu.models import common as jcommon
from ecologysemanticsegmentation_tpu.models import efficientnet_v2s as jeff
from ecologysemanticsegmentation_tpu.models import mbdeconv as jmb
from ecologysemanticsegmentation_tpu.ops import resize as jresize
from ecologysemanticsegmentation_torch.models import (
    DeepLabV3PlusDepthwise,
    EfficientNetDeconvDecoder,
    FusedMBConv,
    MBConv,
    MBDeconv,
    VGGUNet,
)
from ecologysemanticsegmentation_torch.models import common as pcommon
from ecologysemanticsegmentation_torch.models.efficientnet_v2s import SqueezeExcite
from ecologysemanticsegmentation_torch.ops import resize as presize
from ecologysemanticsegmentation_torch.train import (
    TrainState,
    init_weights,
    make_optimizer,
    make_train_step,
)
from _torch_models import TOL, jax_apply, load, perturbed_variables
from _torch_parallel_ranks import bound_threads

bound_threads()

def _images(b, h, w, c, seed=1):
    return np.random.RandomState(seed).randn(b, h, w, c)


def _port(module, *xs, **kw):
    """``module`` on NHWC numpy inputs (NCHW inside), NHWC numpy out."""
    args = [None if x is None else torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    with torch.no_grad():
        out = module(*args, **kw)
    return out.permute(0, 2, 3, 1).numpy()


def _held(port_module, flax_module, *xs, port_kw=None, flax_kw=None):
    variables = perturbed_variables(port_module)
    port_module = load(port_module, variables).eval()
    got = _port(port_module, *xs, **(port_kw or {}))
    want = jax_apply(flax_module, variables, *xs, **(flax_kw or {}))
    np.testing.assert_allclose(got, want, **TOL)
    return got


@pytest.mark.parametrize("up_first", [True, False])
@pytest.mark.parametrize("skip", [5, None])
def test_nearest_up_concat_conv(up_first, skip):
    low = _images(2, 6, 7, 4)
    skip_x = None if skip is None else _images(2, 12, 14, skip, seed=2)
    port = pcommon.NearestUpConcatConv(4, skip or 0, 3, use_bias=True, up_first=up_first)
    variables = perturbed_variables(port)
    port = load(port, variables)
    flax = jcommon.NearestUpConcatConv(3, use_bias=True, up_first=up_first, dtype=jnp.float64)
    got = _port(port, low, skip_x)
    want = jax_apply(flax, variables, low, skip_x) if skip else jax_apply(flax, variables, low)
    assert got.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_nearest_up_depthwise_conv():
    low = _images(2, 5, 6, 8)
    port = pcommon.NearestUpDepthwiseConv(8, use_bias=True)
    variables = perturbed_variables(port)
    got = _port(load(port, variables), low)
    want = jax_apply(jcommon.NearestUpDepthwiseConv(use_bias=True, dtype=jnp.float64),
                     variables, low)
    np.testing.assert_allclose(got, want, **TOL)


# (port kwargs, flax kwargs, input channels, features)
CONV_BN_ACT = {
    "stride2": (dict(kernel_size=3, stride=2), dict(strides=(2, 2)), 4, 6),
    "dilation2": (dict(kernel_size=3, dilation=2), dict(dilation=(2, 2)), 4, 6),
    "depthwise_stride2_silu": (dict(kernel_size=3, stride=2, groups=6, act=F.silu),
                               dict(strides=(2, 2), groups=6, act=fnn.silu), 6, 6),
    "1x1_bias_no_act": (dict(kernel_size=1, use_bias=True, act=None),
                        dict(kernel_size=(1, 1), use_bias=True, act=None), 4, 6),
    "7x7_stride2": (dict(kernel_size=7, stride=2), dict(kernel_size=(7, 7), strides=(2, 2)),
                    3, 5),
}


@pytest.mark.parametrize("case", list(CONV_BN_ACT))
def test_conv_bn_act(case):
    port_kw, flax_kw, cin, feats = CONV_BN_ACT[case]
    x = _images(2, 9, 10, cin)
    _held(pcommon.ConvBNAct(cin, feats, **port_kw),
          jcommon.ConvBNAct(feats, dtype=jnp.float64, **flax_kw), x)


def _fused(port, flax, low, skip_x):
    """``port((low, skip))`` and ``flax((low, skip))``, the fused entry."""
    variables = perturbed_variables(port)
    port = load(port, variables).eval()
    args = tuple(None if a is None else torch.from_numpy(a).permute(0, 3, 1, 2)
                 for a in (low, skip_x))
    with torch.no_grad():
        got = port(args).permute(0, 2, 3, 1).numpy()
    with jax.enable_x64(True):
        want = flax.apply(variables, tuple(None if a is None else jnp.asarray(a)
                                           for a in (low, skip_x)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("skip", [3, 0])
def test_conv_bn_act_fused_entry(skip):
    skip_x = _images(2, 8, 10, skip, seed=3) if skip else None
    _fused(pcommon.ConvBNAct(6, 7, up_skip=skip), jcommon.ConvBNAct(7, dtype=jnp.float64),
           _images(2, 4, 5, 6), skip_x)


def test_conv_bn_act_fused_depthwise_entry():
    _fused(pcommon.ConvBNAct(6, 6, groups=6, act=F.silu, up_skip=0),
           jcommon.ConvBNAct(6, groups=6, act=fnn.silu, dtype=jnp.float64),
           _images(2, 4, 5, 6), None)
    with pytest.raises(ValueError):
        pcommon.ConvBNAct(6, 6, groups=6, up_skip=2)
    with pytest.raises(ValueError):
        pcommon.ConvBNAct(6, 6, kernel_size=1, up_skip=2)


@pytest.mark.parametrize("out_hw", [(7, 11), (20, 9), (26, 26), (13, 13)])
def test_resize_nearest(out_hw):
    x = _images(2, 13, 13, 3).astype(np.float32)
    got = presize.resize_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize.resize_nearest(jnp.asarray(x),
                                                                         out_hw)))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest(scale):
    x = _images(2, 5, 7, 3).astype(np.float32)
    got = presize.upsample_nearest(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize.upsample_nearest(jnp.asarray(x),
                                                                           scale)))
    # the NCHW form the models use keeps channels_last
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    if scale == 2:
        up = pcommon.up2(nchw)
        assert up.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(), got)


def test_squeeze_excite():
    x = _images(2, 6, 6, 16)
    _held(SqueezeExcite(16, 4), jeff.SqueezeExcite(4, dtype=jnp.float64), x)


@pytest.mark.parametrize("expand", [1, 4])
def test_fused_mbconv(expand):
    cin = 8
    for stride, feats in ((1, cin), (2, 12)):
        x = _images(2, 8, 8, cin)
        _held(FusedMBConv(cin, feats, expand, stride),
              jeff.FusedMBConv(feats, expand, stride, dtype=jnp.float64), x)


@pytest.mark.parametrize("use_se", [True, False])
def test_mbconv(use_se):
    cin = 8
    for stride, feats in ((1, cin), (2, 12)):
        x = _images(2, 8, 8, cin)
        _held(MBConv(cin, feats, 4, stride, use_se),
              jeff.MBConv(feats, 4, stride, use_se, dtype=jnp.float64), x)


@pytest.mark.parametrize("stride,feats", [(1, 8), (1, 6), (2, 6)])
def test_mbdeconv(stride, feats):
    x = _images(2, 6, 5, 8)
    got = _held(MBDeconv(8, feats, stride=stride), jmb.MBDeconv(feats, stride=stride,
                                                               dtype=jnp.float64), x)
    assert got.shape == (2, 6 * stride, 5 * stride, feats)


def test_efficientnet_deconv_decoder():
    x = _images(2, 2, 2, 16)
    port = EfficientNetDeconvDecoder(16, 3, (12, 8))
    got = _held(port, jmb.EfficientNetDeconvDecoder(3, (12, 8), dtype=jnp.float64), x)
    assert got.shape == (2, 8, 8, 3)


def test_stochastic_dropout_rate_and_scale():
    p, keep = 0.05, 0.95
    drop = pcommon.StochasticDropout(p).train()
    x = torch.rand(400_000, dtype=torch.float64) + 0.5
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    n = x.numel()
    # survival within 5 binomial standard deviations of 1 - p
    assert abs(kept.double().mean().item() - keep) < 5 * np.sqrt(p * keep / n)
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=1e-15, atol=0)
    # the same generator seed draws the same mask; another seed another
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(1)))
    # off in eval mode and at p = 0
    assert drop.eval()(x, torch.Generator()) is x
    assert pcommon.StochasticDropout(0.0).train()(x) is x
    # bf16 survivors scaled as the JAX module scales them: x * (1 / keep in x's dtype)
    xb = x[:1000].to(torch.bfloat16)
    yb = drop.train()(xb, torch.Generator().manual_seed(2))
    scale = (torch.ones((), dtype=torch.bfloat16) / keep)
    assert torch.equal(yb[yb != 0], xb[yb != 0] * scale)


def test_init_weights_follows_flax_initializers():
    """lecun-normal kernels (variance 1/fan_in), kaiming-normal for the
    depthwise wrapper's ``last_layers`` (variance 2/fan_in), both truncated
    at 2 standard deviations of the untruncated normal; zero conv biases;
    BatchNorm scale 1, bias 0, mean 0, var 1."""
    model = DeepLabV3PlusDepthwise(num_classes=40, encoder_name="resnet34")
    for m in model.modules():
        for t in m.parameters(recurse=False):
            t.data.fill_(7.0)
    init_weights(model, torch.Generator().manual_seed(0))

    def check(w, variance):
        fan_in = w[0].numel()
        std = np.sqrt(variance / fan_in) / 0.87962566103423978
        assert w.abs().max().item() <= 2 * std
        # the truncated normal's variance is the target variance
        assert abs(w.var().item() / (variance / fan_in) - 1) < 0.05

    check(model.last_layers.weight, 2.0)
    check(model.smp_deeplab_model.encoder.layer3_block0.conv1.weight, 1.0)
    assert torch.equal(model.last_layers.bias, torch.zeros(40))
    assert torch.equal(model.smp_deeplab_model.head.bias, torch.zeros(200))
    bn = model.smp_deeplab_model.encoder.bn1
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.bias, torch.zeros(64)) and torch.equal(bn.running_mean, torch.zeros(64))


def _vgg_step(remat: bool, monkeypatch):
    """One train step of a small VGG U-Net with deep supervision and
    dropout (p = 0.05) from seed 0; its gradients, buffers, loss and the
    number of masks the replays reused."""
    replayed = []
    keep_mask = pcommon.MaskTape.keep_mask

    def counting(self, x, keep):
        if self.replayed is not None:
            replayed.append(1)
        return keep_mask(self, x, keep)

    monkeypatch.setattr(pcommon.MaskTape, "keep_mask", counting)
    model = VGGUNet(3, max_channels=256, deepsupervision=True, remat=remat).to(
        memory_format=torch.channels_last)
    init_weights(model, torch.Generator().manual_seed(0))
    tx = make_optimizer(1e-3)
    state = TrainState(0, model, tx(model.parameters()))
    step = make_train_step(model, tx, augment=False, deepsupervision=True)
    gen = torch.Generator().manual_seed(5)
    batch = {"image": torch.rand(2, 32, 32, 3, generator=gen),
             "label": (torch.rand(2, 32, 32, 3, generator=gen) > 0.5).float()}
    state, met = step(state, batch, torch.Generator().manual_seed(3), 0.0, [1.0, 1.0, 1.0],
                      1e-3, None)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return grads, buffers, float(met["loss"]), len(replayed)


def test_remat_equals_plain_bitwise(monkeypatch):
    grads, buffers, loss, replayed = _vgg_step(False, monkeypatch)
    rgrads, rbuffers, rloss, rreplayed = _vgg_step(True, monkeypatch)
    assert replayed == 0
    # 3 encoder stages' and the dropout blocks' masks came back in the replays
    assert rreplayed > 10
    assert rloss == loss
    assert grads.keys() == rgrads.keys() and buffers.keys() == rbuffers.keys()
    for k in grads:
        assert torch.equal(grads[k], rgrads[k]), k
    for k in buffers:
        assert torch.equal(buffers[k], rbuffers[k]), k


def test_checkpointed_replay_leaves_running_stats(monkeypatch):
    """A checkpointed region's BatchNorm updates its running statistics
    once, in the forward, and not again in the replay."""
    block = pcommon.ConvBNAct(3, 4).train()
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    before = block.bn.running_mean.clone()
    y = pcommon.checkpointed(block, lambda t, tape: block(t), None, x)
    once = block.bn.running_mean.clone()
    y.sum().backward()
    assert not torch.equal(once, before)
    assert torch.equal(block.bn.running_mean, once)
    assert not block.bn.replaying

