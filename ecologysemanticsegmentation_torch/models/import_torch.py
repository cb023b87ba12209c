"""The reference's PyTorch checkpoints onto the port's models (port of the
JAX package's ``models/import_torch.py``).

The reference trains ``smp.DeepLabV3Plus(encoder_name="resnet34")``
(segmentation-models-pytorch 0.3.3), or its ``--depthwiseconv`` wrapper,
and saves ``net.state_dict()``.  These functions map such a state dict, a
torchvision ResNet encoder's (resnet34 or resnet50) and torchvision
``vgg19_bn``'s features onto the JAX package's flax trees, as the JAX
package does, leaf for leaf:
convolutions OIHW -> HWIO, BatchNorm ``weight``/``bias`` to ``scale``/
``bias`` and ``running_mean``/``running_var`` to the ``batch_stats``
``mean``/``var``.  :func:`.from_flax.from_flax_variables` turns the trees
into the port's ``state_dict`` (``train/checkpoint.py`` does, for a
``.pt`` file).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .vgg import VGG19_CFG


def _t2f_conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _numpy(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def resnet_encoder_from_torch(
    state_dict: Mapping[str, Any], prefix: str = ""
) -> tuple[dict, dict]:
    """A torchvision ResNet state dict -> (params, batch_stats) flax trees of
    the encoder (``layer{N}_block{M}`` names; a Bottleneck block's
    ``conv3``/``bn3`` come with its ``conv1``/``conv2``).  ``prefix`` strips a
    leading namespace (``"encoder."`` in smp checkpoints); ``fc.*`` is
    ignored."""
    params: dict = {}
    stats: dict = {}

    def np_(key):
        return _numpy(state_dict[prefix + key])

    def bn(src: str, dst: tuple[str, ...]) -> None:
        _set(params, dst + ("scale",), np_(f"{src}.weight"))
        _set(params, dst + ("bias",), np_(f"{src}.bias"))
        _set(stats, dst + ("mean",), np_(f"{src}.running_mean"))
        _set(stats, dst + ("var",), np_(f"{src}.running_var"))

    _set(params, ("conv1", "kernel"), _t2f_conv(np_("conv1.weight")))
    bn("bn1", ("bn1",))

    for layer in range(1, 5):
        if not any(k.startswith(f"{prefix}layer{layer}.") for k in state_dict):
            break
        block = 0
        while any(k.startswith(f"{prefix}layer{layer}.{block}.") for k in state_dict):
            src = f"layer{layer}.{block}"
            dst = f"layer{layer}_block{block}"
            conv = 1
            while f"{prefix}{src}.conv{conv}.weight" in state_dict:
                _set(params, (dst, f"conv{conv}", "kernel"),
                     _t2f_conv(np_(f"{src}.conv{conv}.weight")))
                bn(f"{src}.bn{conv}", (dst, f"bn{conv}"))
                conv += 1
            if f"{prefix}{src}.downsample.0.weight" in state_dict:
                _set(params, (dst, "downsample_conv", "kernel"),
                     _t2f_conv(np_(f"{src}.downsample.0.weight")))
                bn(f"{src}.downsample.1", (dst, "downsample_bn"))
            block += 1
    return params, stats


def vgg19_bn_encoder_from_torch(state_dict: Mapping[str, Any], max_channels: int = 512,
                                prefix: str = "features.") -> tuple[dict, dict]:
    """torchvision ``vgg19_bn`` features -> (params, batch_stats) flax trees
    of the VGG U-Net's encoder (``conv{i}`` with bias, ``bn{i}``), truncated
    at the first conv wider than ``max_channels`` as the encoder is.  The
    torch ``Sequential`` holds conv, bn, relu per conv and one max pool per
    stage."""
    params: dict = {}
    stats: dict = {}

    def np_(key):
        return _numpy(state_dict[prefix + key])

    torch_idx = 0  # index in the torch Sequential
    conv_idx = 0
    for spec in VGG19_CFG:
        if spec == "M":
            torch_idx += 1
            continue
        if int(spec) > max_channels:
            break
        _set(params, (f"conv{conv_idx}", "kernel"), _t2f_conv(np_(f"{torch_idx}.weight")))
        _set(params, (f"conv{conv_idx}", "bias"), np_(f"{torch_idx}.bias"))
        bn_src = f"{torch_idx + 1}"
        _set(params, (f"bn{conv_idx}", "scale"), np_(f"{bn_src}.weight"))
        _set(params, (f"bn{conv_idx}", "bias"), np_(f"{bn_src}.bias"))
        _set(stats, (f"bn{conv_idx}", "mean"), np_(f"{bn_src}.running_mean"))
        _set(stats, (f"bn{conv_idx}", "var"), np_(f"{bn_src}.running_var"))
        torch_idx += 3  # conv, bn, relu
        conv_idx += 1
    return params, stats


def smp_deeplabv3plus_from_torch(
    state_dict: Mapping[str, Any], prefix: str = ""
) -> tuple[dict, dict]:
    """An smp 0.3.3 ``DeepLabV3Plus(resnet34)`` state dict -> (params,
    batch_stats) flax trees of DeepLabV3+:

    ========================================  =================================
    smp key                                   destination
    ========================================  =================================
    encoder.conv1/bn1/layerN.M.*              encoder.* (torchvision layout)
    decoder.aspp.0.convs.0.{0,1}              aspp.conv1x1.{conv,bn}
    decoder.aspp.0.convs.{1,2,3}.0.{0,1},.1   aspp.atrous{i}.{depthwise,pointwise,bn}
    decoder.aspp.0.convs.4.{1,2}              aspp.pool_conv.{conv,bn} (0 is the pool)
    decoder.aspp.0.project.{0,1}              aspp.project.{conv,bn}
    decoder.aspp.{1.0,1.1,2}                  aspp_out.{depthwise,pointwise,bn}
    decoder.block1.{0,1}                      low_project.{conv,bn}
    decoder.block2.0.{0,1}, block2.1          fuse.{depthwise,pointwise,bn}
    segmentation_head.0.{weight,bias}         head.{kernel,bias}
    ========================================  =================================
    """
    params: dict = {}
    stats: dict = {}

    def np_(key):
        return _numpy(state_dict[prefix + key])

    def bn(src: str, dst: tuple[str, ...]) -> None:
        _set(params, dst + ("scale",), np_(f"{src}.weight"))
        _set(params, dst + ("bias",), np_(f"{src}.bias"))
        _set(stats, dst + ("mean",), np_(f"{src}.running_mean"))
        _set(stats, dst + ("var",), np_(f"{src}.running_var"))

    def conv_bn(conv_src: str, bn_src: str, dst: str) -> None:
        _set(params, (dst, "conv", "kernel"), _t2f_conv(np_(f"{conv_src}.weight")))
        bn(bn_src, (dst, "bn"))

    def sep_conv_bn(sep_src: str, bn_src: str, dst: str) -> None:
        _set(params, (dst, "depthwise", "kernel"), _t2f_conv(np_(f"{sep_src}.0.weight")))
        _set(params, (dst, "pointwise", "kernel"), _t2f_conv(np_(f"{sep_src}.1.weight")))
        bn(bn_src, (dst, "bn"))

    params["encoder"], stats["encoder"] = resnet_encoder_from_torch(
        state_dict, prefix=prefix + "encoder.")

    conv_bn("decoder.aspp.0.convs.0.0", "decoder.aspp.0.convs.0.1", "conv1x1")
    for i in range(3):
        sep_conv_bn(f"decoder.aspp.0.convs.{i + 1}.0", f"decoder.aspp.0.convs.{i + 1}.1",
                    f"atrous{i}")
    conv_bn("decoder.aspp.0.convs.4.1", "decoder.aspp.0.convs.4.2", "pool_conv")
    conv_bn("decoder.aspp.0.project.0", "decoder.aspp.0.project.1", "project")
    aspp = {k: params.pop(k) for k in
            ("conv1x1", "atrous0", "atrous1", "atrous2", "pool_conv", "project")}
    params["aspp"], stats["aspp"] = aspp, {k: stats.pop(k) for k in aspp}

    sep_conv_bn("decoder.aspp.1", "decoder.aspp.2", "aspp_out")
    conv_bn("decoder.block1.0", "decoder.block1.1", "low_project")
    sep_conv_bn("decoder.block2.0", "decoder.block2.1", "fuse")

    _set(params, ("head", "kernel"), _t2f_conv(np_("segmentation_head.0.weight")))
    _set(params, ("head", "bias"), np_("segmentation_head.0.bias"))
    return params, stats


def smp_checkpoint_to_variables(state_dict: Mapping[str, Any]) -> dict:
    """A reference checkpoint (``torch.save(net.state_dict())``) -> flax
    ``{"params", "batch_stats"}`` of DeepLabV3+, or of
    ``DeepLabV3PlusDepthwise`` for the ``--depthwiseconv`` wrapper's layout
    (``smp_deeplab_model.*`` and ``last_layers.{weight,bias}``)."""
    if any(k.startswith("smp_deeplab_model.") for k in state_dict):
        inner_p, inner_s = smp_deeplabv3plus_from_torch(state_dict, prefix="smp_deeplab_model.")
        params = {"smp_deeplab_model": inner_p,
                  "last_layers": {"kernel": _t2f_conv(_numpy(state_dict["last_layers.weight"])),
                                  "bias": _numpy(state_dict["last_layers.bias"])}}
        return {"params": params, "batch_stats": {"smp_deeplab_model": inner_s}}
    params, stats = smp_deeplabv3plus_from_torch(state_dict)
    return {"params": params, "batch_stats": stats}


def strip_smp_deeplab_prefix(state_dict: Mapping[str, Any]) -> dict:
    """The sequential script's warm-start remap: strip the
    ``smp_deeplab_model.`` prefix and drop the ``segmentation_head`` entries."""
    out = {}
    for k, v in state_dict.items():
        if "segmentation_head" in k:
            continue
        out[k.removeprefix("smp_deeplab_model.")] = v
    return out
