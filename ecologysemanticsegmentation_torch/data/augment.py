"""Device augmentation of a batch (port of
``ecologysemanticsegmentation_tpu/data/augment.py::augment_batch``).

Probability tree, as in the JAX package:

* outer ``p=0.7`` gate (per sample) over [ OneOf{defocus, gaussian-blur,
  zoom-blur, fog} (p=.4) -> OneOf{color-jitter, brightness-contrast, gamma,
  emboss} (p=.4) -> FancyPCA (.3) -> channel-shuffle (.5) -> to-gray (.3) ],
* geometry with batch-uniform gates and parameters, composed into one affine
  warp: random-resized-crop (p=.21) -> hflip (p=.35) -> rotate 0-90 (p=.4),
  bilinear for the image and nearest for the mask (label values stay exactly
  in {-1, 0, 1}); a step where only the flip fired reverses the columns,
* independent per-sample tail: HSV shift (.4), CLAHE (.7), tone curve (.5).

The work is split in two.  :func:`draw_augment_params` draws every random
value: the batch-uniform ones (the OneOf choices, the geometric gates, the
crop box and the degree) on the host from a CPU ``torch.Generator``, so the
branches below are plain Python and no device value is read back; the
per-sample ones (gates, (B,1,1,1) parameters, the fog field, the PCA
alphas) on the device from the device generator.  :func:`apply_augment`
computes the pipeline from those values and draws nothing, which is how the
tests feed it the JAX package's draws.  As in the JAX package, a gated op
runs on the whole batch every step and ``where`` selects its output.

The image is computed in bfloat16 and returned in bfloat16, following each
JAX op's dtypes: per-sample parameters are bfloat16 where the JAX op casts
them, coordinates, histograms and PCA statistics are float32.  Each op here
rounds to bfloat16 after every operation, as JAX does op by op; under
``jax.jit`` XLA may keep float32 between fused operations, so the pipeline
agrees with the jitted JAX pipeline to a few bfloat16 ulps, not bitwise.

``AUGMENT_TILED_CLAHE=1`` selects the tile-adaptive CLAHE (8x8 tiles, 64
bins, the kernel of ``ops/clahe_tiled.py``) over the default clip-limited
global form; it is read once, at import, as the JAX package reads it.

Per-sample granularity (the reference's, ``AUGMENT_PER_SAMPLE=1``):
:func:`draw_augment_params_per_sample` draws every value per sample, the
OneOf choices on the host (the batch is split by op without reading the
device) and the rest on the device: the crop box, the flip, the rotation
gate and degree become (B,) tensors.  :func:`apply_augment_per_sample` runs
each OneOf op once on the samples that chose it (index, apply, scatter
back), composes one 3x3 affine per sample (the identity where a gate is
off) and warps the whole batch with one (B, H, W) coordinate field, so its
launches do not grow with the batch.  Sample ``i`` of it equals
:func:`apply_augment` on the singleton batch ``[i]`` with
:func:`sample_augment_params` of ``i``, bitwise.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.clahe_tiled import tiled_clahe_new_luma
from ..ops.resize import resize_bilinear

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

TILED_CLAHE = os.environ.get("AUGMENT_TILED_CLAHE", "0").lower() not in ("0", "", "false")

# AUGMENT_PER_SAMPLE=1 makes the train step draw the augmentation per sample
# (:func:`augment_batch_per_sample`) instead of per batch.  Read at import.
PER_SAMPLE = os.environ.get("AUGMENT_PER_SAMPLE", "0").lower() not in ("0", "", "false")


@functools.lru_cache(maxsize=64)
def _on(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The host constant ``name`` of this module on ``device`` in ``dtype``,
    copied once: a copy from pageable host memory on every step would wait
    for the device."""
    return torch.from_numpy(_CONSTS[name]()).to(device=device, dtype=dtype)


def _round_to(value: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``: JAX casts a weakly typed
    constant to the array's dtype before the operation."""
    return float(torch.tensor(value, dtype=dtype))


# --------------------------------------------------------------- conv helpers


def _depthwise_conv(x: torch.Tensor, kernel: str) -> torch.Tensor:
    """x NHWC, the (kh, kw) kernel named ``kernel`` cast to x's dtype; SAME
    padding, per channel (cross-correlation, as ``lax.conv_general_dilated``)."""
    c = x.shape[-1]
    k = _on(kernel, x.device, x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, *k.shape), padding="same", groups=c)
    return y.permute(0, 2, 3, 1)


def _disk_kernel(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    yy, xx = np.mgrid[:n, :n] - radius
    k = (yy**2 + xx**2 <= radius**2).astype(np.float32)
    return k / k.sum()


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    r = size // 2
    yy, xx = np.mgrid[:size, :size] - r
    k = np.exp(-(yy**2 + xx**2) / (2.0 * sigma**2)).astype(np.float32)
    return k / k.sum()


# --------------------------------------------------------- geometric sampling


def _reflect101(x: torch.Tensor, n: int) -> torch.Tensor:
    """Integer indices reflected into [0, n) without repeating the edge."""
    period = 2 * (n - 1) if n > 1 else 1
    x = torch.remainder(x.abs(), period)
    return torch.where(x >= n, period - x, x)


def _gather(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``x[b, yi, xi]`` for integer coordinates (H, W) shared across the
    batch or (B, H, W), one field per sample."""
    if yi.dim() == 2:
        return x[:, yi, xi]
    return x[torch.arange(x.shape[0], device=x.device)[:, None, None], yi, xi]


def _bilinear_warp(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample the NHWC batch at float32 coordinates, (H, W) shared across
    the batch or (B, H, W) per sample, reflect101 border; the weights are
    cast to x's dtype first."""
    h, w = x.shape[1:3]
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    wy = (ys - y0f)[..., None].to(x.dtype)
    wx = (xs - x0f)[..., None].to(x.dtype)

    y0, x0 = y0f.long(), x0f.long()
    y0, y1 = _reflect101(y0, h), _reflect101(y0 + 1, h)
    x0, x1 = _reflect101(x0, w), _reflect101(x0 + 1, w)
    top = _gather(x, y0, x0) * (1 - wx) + _gather(x, y0, x1) * wx
    bot = _gather(x, y1, x0) * (1 - wx) + _gather(x, y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _nearest_warp(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour :func:`_bilinear_warp` for masks: label values pass
    through exactly (round half to even, as ``jnp.round``)."""
    h, w = x.shape[1:3]
    return _gather(x, _reflect101(torch.round(ys).long(), h),
                   _reflect101(torch.round(xs).long(), w))


# ------------------------------------------------------------ color utilities


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(-1)
    mn = img.amin(-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    sector = torch.remainder(i.to(torch.int32), 6).long()[..., None]

    def select(*vals):  # vals[k] where sector == k, as jnp.select
        return torch.stack(vals, dim=-1).gather(-1, sector)[..., 0]

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _luma(img: torch.Tensor) -> torch.Tensor:
    """Rec. 601 luminance; the weights are cast to img's dtype, the dot is
    taken in float32 and rounded once, as XLA's dot accumulates."""
    wts = _on("luma", img.device, img.dtype).float()
    return torch.matmul(img.float(), wts).to(img.dtype)


# ------------------------------------------------------------- the transforms
# Each takes the NHWC batch and its drawn parameters; per-sample parameters
# are (B,1,1,1) (or (B,1,1) for the HSV ones), as in the JAX ops.


def _defocus(x):
    return _depthwise_conv(x, "disk3")


def _gauss_blur(x):
    return _depthwise_conv(x, "gauss3")


def _zoom_blur(x):
    h, w = x.shape[1:3]
    acc = x
    for factor in (1.03, 1.06, 1.09, 1.11):
        ch, cw = int(round(h / factor)), int(round(w / factor))
        top, left = (h - ch) // 2, (w - cw) // 2
        acc = acc + resize_bilinear(x[:, top:top + ch, left:left + cw], (h, w))
    return acc / 5.0


def _fog(x, coef, field):
    h, w = x.shape[1:3]
    alpha = coef * _round_to(0.6, coef.dtype) * resize_bilinear(field, (h, w))
    return x * (1 - alpha) + alpha


def _color_jitter(x, bright, contr, sat, hshift):
    x = x * bright
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * contr + mean
    luma = _luma(x)[..., None]
    x = (x - luma) * sat + luma
    hsv = _rgb_to_hsv(x.clamp(0, 1))
    hue = torch.remainder(hsv[..., 0] + hshift.to(x.dtype), 1.0)
    return _hsv_to_rgb(torch.cat([hue[..., None], hsv[..., 1:]], dim=-1))


def _brightness_contrast(x, contrast, brightness):
    return x * (1.0 + contrast) + brightness


def _gamma(x, g):
    return torch.pow(x.clamp(1e-6, 1.0), g)


_EMBOSS_K = np.array([[-1.0, -1.0, 0.0], [-1.0, 1.0, 1.0], [0.0, 1.0, 1.0]], np.float32)


def _emboss(x, alpha, strength):
    embossed = _depthwise_conv(x, "emboss") * strength + 0.5
    return x * (1 - alpha) + embossed * alpha


def _eigh3x3(a: torch.Tensor):
    """Closed-form symmetric 3x3 eigendecomposition, batched (Smith 1961):
    (B,3,3) f32 -> (eigval (B,3) ascending, eigvec (B,3,3) columns).  The
    same arithmetic as the JAX package's, not ``torch.linalg.eigh``."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = (a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2])[:, None, None] / 3.0
    p1 = a[:, 0, 1] ** 2 + a[:, 0, 2] ** 2 + a[:, 1, 2] ** 2
    aq = a - q * eye
    p2 = (aq[:, 0, 0] ** 2 + aq[:, 1, 1] ** 2 + aq[:, 2, 2] ** 2) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-20))[:, None, None]
    bm = aq / p
    r = (
        bm[:, 0, 0] * (bm[:, 1, 1] * bm[:, 2, 2] - bm[:, 1, 2] * bm[:, 2, 1])
        - bm[:, 0, 1] * (bm[:, 1, 0] * bm[:, 2, 2] - bm[:, 1, 2] * bm[:, 2, 0])
        + bm[:, 0, 2] * (bm[:, 1, 0] * bm[:, 2, 1] - bm[:, 1, 1] * bm[:, 2, 0])
    ) / 2.0
    phi = torch.arccos(r.clamp(-1.0, 1.0)) / 3.0
    q1, p1d = q[:, 0, 0], p[:, 0, 0]
    lam_hi = q1 + 2.0 * p1d * torch.cos(phi)
    lam_lo = q1 + 2.0 * p1d * torch.cos(phi + 2.0 * np.pi / 3.0)
    lam_mid = 3.0 * q1 - lam_hi - lam_lo
    eigval = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)  # ascending

    def vec(lam):
        m = a - lam[:, None, None] * eye
        c01 = torch.linalg.cross(m[:, 0], m[:, 1])
        c02 = torch.linalg.cross(m[:, 0], m[:, 2])
        c12 = torch.linalg.cross(m[:, 1], m[:, 2])
        n01 = (c01 * c01).sum(-1, keepdim=True)
        n02 = (c02 * c02).sum(-1, keepdim=True)
        n12 = (c12 * c12).sum(-1, keepdim=True)
        v = torch.where(n01 >= torch.maximum(n02, n12), c01,
                        torch.where(n02 >= n12, c02, c12))
        return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-20))

    eigvec = torch.stack([vec(eigval[:, i]) for i in range(3)], dim=-1)  # columns
    return eigval, eigvec


def _fancy_pca(x, alphas, alpha_std=0.35):
    """``alphas`` are the (B, 3) standard normal draws."""
    b = x.shape[0]
    flat = x.reshape(b, -1, 3)
    mean = flat.float().mean(dim=1, keepdim=True)
    centered = (flat - mean.to(flat.dtype)).float()  # products of bf16 are exact in f32
    cov = torch.einsum("npc,npd->ncd", centered, centered) / flat.shape[1]
    cov = cov + 1e-6 * torch.eye(3, device=x.device)
    eigval, eigvec = _eigh3x3(cov)
    delta = torch.einsum("ncd,nd->nc", eigvec, alphas * alpha_std * eigval)
    return x + delta[:, None, None, :].to(x.dtype)


_PERMS3 = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1], [2, 1, 0]], np.int64
)
# The JAX op multiplies by eye(3)[perm], so output channel d is input
# channel argsort(perm)[d]: a gather by the inverse permutation, bit for bit.
_GATHER3 = np.argsort(_PERMS3, axis=1)


def _channel_shuffle(x, idx):
    src = _on("gather3", x.device, torch.int64)[idx]  # (B, 3)
    return torch.gather(x, -1, src[:, None, None, :].expand(x.shape))


def _to_gray(x):
    return _luma(x)[..., None].expand(x.shape)


def _hsv_shift(x, dh, ds, dv):
    hsv = _rgb_to_hsv(x.clamp(0, 1))
    return _hsv_to_rgb(torch.stack([
        torch.remainder(hsv[..., 0] + dh.to(x.dtype), 1.0),
        (hsv[..., 1] + ds.to(x.dtype)).clamp(0, 1),
        (hsv[..., 2] + dv.to(x.dtype)).clamp(0, 1),
    ], dim=-1))


def _histogram(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Exact f32 counts of each bin over the last axis: (..., n) -> (..., bins).
    A scatter-add of ones (exact below 2**24), not ``bincount``, which reads
    the largest index back to the host on CUDA."""
    flat = idx.reshape(-1, idx.shape[-1]).long()
    rows, n = flat.shape
    flat = flat + torch.arange(rows, device=idx.device)[:, None] * bins
    counts = torch.zeros(rows * bins, dtype=torch.float32, device=idx.device)
    counts.scatter_add_(0, flat.reshape(-1), torch.ones(rows * n, device=idx.device))
    return counts.reshape(*idx.shape[:-1], bins)


_CLAHE_BINS = 32


def _clahe(x, clip_limit):
    """Clip-limited global equalization: the histogram of a 4x subsampled
    luminance, 32 bins.  The bin index is formed in the luminance's dtype
    (``luma * 31`` rounds in bf16 before it is truncated), as in the JAX op."""
    b, h, w, _ = x.shape
    clip = clip_limit.reshape(b, 1)
    luma = _luma(x.clamp(0, 1)).clamp(0.0, 1.0)
    ds = luma[:, ::4, ::4].reshape(b, -1)
    n = ds.shape[1]
    idx = (ds * (_CLAHE_BINS - 1)).to(torch.int32).clamp(0, _CLAHE_BINS - 1)
    hist = _histogram(idx, _CLAHE_BINS)
    cap = clip * n / _CLAHE_BINS
    excess = (hist - cap).clamp(min=0.0).sum(dim=1, keepdim=True)
    hist = torch.minimum(hist, cap) + excess / _CLAHE_BINS
    cdf = torch.cumsum(hist, dim=1) / n
    deltas = torch.diff(cdf, dim=1, prepend=torch.zeros_like(cdf[:, :1]))
    # The JAX op sums deltas[k] * 1{idx >= k} over k; that is the prefix sum
    # of the deltas up to idx, looked up per pixel.
    lut = torch.cumsum(deltas, dim=1)
    idx = (luma * (_CLAHE_BINS - 1)).to(torch.int32).clamp(0, _CLAHE_BINS - 1)
    new_luma = torch.gather(lut, 1, idx.reshape(b, -1).long()).reshape(b, h, w)
    scale = new_luma / luma.float().clamp(min=1e-6)
    return x * scale[..., None].to(x.dtype)


_CLAHE_TILES = 8
_CLAHE_TILED_BINS = 64


def _clahe_tiled(x, clip_limit):
    """Tile-adaptive CLAHE (cv2 semantics: 8x8 tiles, per-tile clipped
    histograms of a 2x subsample, 64 bins, bilinear between tile LUTs; the
    apply is :func:`..ops.clahe_tiled.tiled_clahe_new_luma`).  Needs H and W
    divisible by 16; other sizes take the global form."""
    b, h, w, _ = x.shape
    t = _CLAHE_TILES
    if h % (2 * t) or w % (2 * t):
        return _clahe(x, clip_limit)
    bins = _CLAHE_TILED_BINS
    clip = clip_limit.reshape(b, 1, 1)
    luma = _luma(x.clamp(0, 1)).clamp(0.0, 1.0).float()
    th2, tw2 = h // t // 2, w // t // 2
    ds = luma[:, ::2, ::2].reshape(b, t, th2, t, tw2)
    ds = ds.permute(0, 1, 3, 2, 4).reshape(b, t * t, th2 * tw2)
    n = th2 * tw2
    idx = (ds * (bins - 1)).to(torch.int32).clamp(0, bins - 1)
    hist = _histogram(idx, bins)  # (B, T*T, bins)
    cap = clip * n / bins
    excess = (hist - cap).clamp(min=0.0).sum(dim=2, keepdim=True)
    hist = torch.minimum(hist, cap) + excess / bins
    cdf = torch.cumsum(hist, dim=2) / n
    deltas = torch.diff(cdf, dim=2, prepend=torch.zeros_like(cdf[:, :, :1]))
    new_luma = tiled_clahe_new_luma(luma, deltas.reshape(b, t, t, bins), t)
    scale = new_luma / luma.clamp(min=1e-6)
    return x * scale[..., None].to(x.dtype)


def _tone_curve(x, z):
    """``z`` is the (B,1,1,1) standard normal draw of the control point."""
    c = (0.5 + 0.25 * z).clamp(0.0, 1.0).to(x.dtype)
    t = x.clamp(0, 1)
    return 2 * (1 - t) * t * c + t * t


_CONSTS = {
    "luma": lambda: _LUMA,
    "disk3": lambda: _disk_kernel(3),
    "gauss3": lambda: _gaussian_kernel(3, 0.2 + 1e-3),
    "emboss": lambda: _EMBOSS_K,
    "gather3": lambda: _GATHER3,
}


# ------------------------------------------------------------------- pipeline

# OneOf blocks: (name, op, its per-sample parameters as (name, lo, hi) of a
# uniform draw cast to bf16, as the JAX ``_u`` does).
_BLUR_OPS = (
    ("defocus", _defocus, ()),
    ("gauss_blur", _gauss_blur, ()),
    ("zoom_blur", _zoom_blur, ()),
    ("fog", _fog, (("coef", 0.3, 1.0),)),
)
_COLOR_OPS = (
    ("color_jitter", _color_jitter, (("bright", 0.6, 1.4), ("contr", 0.6, 1.4),
                                     ("sat", 0.6, 1.4))),
    ("brightness_contrast", _brightness_contrast, (("contrast", -0.2, 0.2),
                                                   ("brightness", -0.2, 0.2))),
    ("gamma", _gamma, (("g", 0.8, 1.2),)),
    ("emboss", _emboss, (("alpha", 0.3, 0.6), ("strength", 0.3, 0.7))),
)
BLUR_NAMES = tuple(name for name, _, _ in _BLUR_OPS)
COLOR_NAMES = tuple(name for name, _, _ in _COLOR_OPS)
# The per-sample tensors every draw holds, batch first.
_TAIL_KEYS = ("outer", "pca_gate", "pca_alpha", "shuffle_gate", "shuffle_idx", "gray_gate",
              "hsv_gate", "hsv_dh", "hsv_ds", "hsv_dv", "clahe_gate", "clahe_clip",
              "tone_gate", "tone_z")


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _gate(gen, p, b, device):
    return torch.rand((b, 1, 1, 1), generator=gen, device=device) < p


def _crop_box(h: int, w: int, scale, log_ratio, u_top, u_left):
    """Random-resized-crop box (top, left, ch, cw) in float32, as the JAX
    pipeline derives it from its four uniform draws: numbers give 0-d
    tensors, (B,) tensors one box per sample."""
    f32 = torch.float32
    area = torch.as_tensor(scale, dtype=f32) * h * w
    ratio = torch.exp(torch.as_tensor(log_ratio, dtype=f32))
    cw = torch.sqrt(area * ratio).clamp(8.0, w)
    ch = torch.sqrt(area / ratio).clamp(8.0, h)
    top = torch.as_tensor(u_top, dtype=f32) * (h - ch)
    left = torch.as_tensor(u_left, dtype=f32) * (w - cw)
    return top, left, ch, cw


def _draw_photometric(device_gen: torch.Generator, b: int, dev) -> dict:
    """The per-sample draws of the ops after the warp (PCA to tone curve)."""
    params = {"pca_gate": _gate(device_gen, 0.3, b, dev),
              "pca_alpha": torch.randn((b, 3), generator=device_gen, device=dev),
              "shuffle_gate": _gate(device_gen, 0.5, b, dev),
              "shuffle_idx": torch.randint(0, 6, (b,), generator=device_gen, device=dev),
              "gray_gate": _gate(device_gen, 0.3, b, dev),
              "hsv_gate": _gate(device_gen, 0.4, b, dev)}
    params["hsv_dh"] = _uniform(device_gen, (b, 1, 1), -60.0, 60.0, dev) / 180.0
    params["hsv_ds"] = _uniform(device_gen, (b, 1, 1), -60.0, 60.0, dev) / 255.0
    params["hsv_dv"] = _uniform(device_gen, (b, 1, 1), -30.0, 30.0, dev) / 255.0
    params["clahe_gate"] = _gate(device_gen, 0.7, b, dev)
    params["clahe_clip"] = _uniform(device_gen, (b,), 1.0, 4.0, dev)
    params["tone_gate"] = _gate(device_gen, 0.5, b, dev)
    params["tone_z"] = torch.randn((b, 1, 1, 1), generator=device_gen, device=dev)
    return params


def draw_augment_params(host_gen: torch.Generator, device_gen: torch.Generator,
                        b: int, h: int, w: int) -> dict:
    """Every random value of one :func:`apply_augment` call.  Batch-uniform
    values are Python numbers drawn from ``host_gen`` (a CPU generator);
    per-sample values are tensors on ``device_gen``'s device."""
    dev = device_gen.device

    def host_u(lo=0.0, hi=1.0):
        return float(_uniform(host_gen, (), lo, hi, "cpu"))

    def u_bf16(lo, hi):
        return _uniform(device_gen, (b, 1, 1, 1), lo, hi, dev).to(torch.bfloat16)

    params = {"outer": _gate(device_gen, 0.7, b, dev)}
    for block, ops in (("blur", _BLUR_OPS), ("color", _COLOR_OPS)):
        params[f"{block}_gate"] = _gate(device_gen, 0.4, b, dev)
        choice = int(torch.randint(0, len(ops), (), generator=host_gen))
        name, _, spec = ops[choice]
        params[f"{block}_op"] = name
        params[block] = {k: u_bf16(lo, hi) for k, lo, hi in spec}
    if params["blur_op"] == "fog":
        params["blur"]["field"] = _uniform(
            device_gen, (b, max(h // 16, 1), max(w // 16, 1), 1), 0.0, 1.0, dev)
    if params["color_op"] == "color_jitter":
        params["color"]["hshift"] = _uniform(device_gen, (b, 1, 1), -0.4, 0.4, dev)

    scale = host_u(0.08, 1.0)
    log_ratio = host_u(math.log(0.75), math.log(4 / 3))
    box = _crop_box(h, w, scale, log_ratio, host_u(), host_u())
    params["crop_box"] = tuple(float(v) for v in box)
    params["crop_gate"] = host_u() < 0.7 * 0.3
    params["flip_gate"] = host_u() < 0.7 * 0.5
    degree = float(torch.randint(0, 90, (), generator=host_gen))
    params["degree"] = 0.0 if host_u() < 0.2 else degree
    params["rot_gate"] = host_u() < 0.4
    params.update(_draw_photometric(device_gen, b, dev))
    return params


def draw_augment_params_per_sample(host_gen: torch.Generator, device_gen: torch.Generator,
                                   b: int, h: int, w: int) -> dict:
    """Every random value of one :func:`apply_augment_per_sample` call, each
    drawn per sample.  The OneOf choices are (B,) int64 tensors on the host
    from ``host_gen``, so the batch splits by op without a read from the
    device; every other value is a tensor on ``device_gen``'s device: the
    gates, each op's parameters for every sample (``params[block][op]``),
    the crop box as four (B,) float32 tensors, and the (B,) flip and
    rotation gates and degrees."""
    dev = device_gen.device

    def u(shape, lo=0.0, hi=1.0):
        return _uniform(device_gen, shape, lo, hi, dev)

    params = {"outer": _gate(device_gen, 0.7, b, dev)}
    for block, ops in (("blur", _BLUR_OPS), ("color", _COLOR_OPS)):
        params[f"{block}_gate"] = _gate(device_gen, 0.4, b, dev)
        params[f"{block}_choice"] = torch.randint(0, len(ops), (b,), generator=host_gen)
        params[block] = {name: {k: u((b, 1, 1, 1), lo, hi).to(torch.bfloat16)
                                for k, lo, hi in spec} for name, _, spec in ops}
    params["blur"]["fog"]["field"] = u((b, max(h // 16, 1), max(w // 16, 1), 1))
    params["color"]["color_jitter"]["hshift"] = u((b, 1, 1), -0.4, 0.4)

    params["crop_box"] = _crop_box(h, w, u((b,), 0.08, 1.0),
                                   u((b,), math.log(0.75), math.log(4 / 3)), u((b,)), u((b,)))
    params["crop_gate"] = u((b,)) < 0.7 * 0.3
    params["flip_gate"] = u((b,)) < 0.7 * 0.5
    degree = torch.randint(0, 90, (b,), generator=device_gen, device=dev).float()
    params["degree"] = torch.where(u((b,)) < 0.2, 0.0, degree)
    params["rot_gate"] = u((b,)) < 0.4
    params.update(_draw_photometric(device_gen, b, dev))
    return params


def sample_augment_params(params: dict, i: int) -> dict:
    """Sample ``i`` of per-sample draws (:func:`draw_augment_params_per_sample`)
    as the batch-uniform draws of the singleton batch ``[i]``
    (:func:`draw_augment_params`'s format)."""
    one = slice(i, i + 1)
    out = {}
    for block, names in (("blur", BLUR_NAMES), ("color", COLOR_NAMES)):
        name = names[int(params[f"{block}_choice"][i])]
        out[f"{block}_op"] = name
        out[f"{block}_gate"] = params[f"{block}_gate"][one]
        out[block] = {k: v[one] for k, v in params[block][name].items()}
    out["crop_box"] = tuple(float(v[i]) for v in params["crop_box"])
    for k in ("crop_gate", "flip_gate", "rot_gate"):
        out[k] = bool(params[k][i])
    out["degree"] = float(params["degree"][i])
    out.update({k: params[k][one] for k in _TAIL_KEYS})
    return out


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of (..., 3, 3) matrices, each entry summed k = 0, 1, 2 in
    order, as the JAX dot of the 3x3 affines."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _affines(h: int, w: int, top, left, ch, cw, degree, device, batch=()):
    """The crop, hflip and rotate affines (output coords -> input coords)
    in float32 on ``device``, (*batch, 3, 3): each entry computed with the
    same float32 operations from 0-d or (B,) tensors."""
    f32 = torch.float32

    def entry(v):
        # A number is filled on the device: a copy of it from pageable host
        # memory would wait for the device's queue.
        if isinstance(v, torch.Tensor):
            return v.expand(batch)
        return torch.full(batch, v, dtype=f32, device=device)

    def mat(rows):
        return torch.stack([torch.stack([entry(v) for v in row], -1) for row in rows], -2)

    theta = torch.as_tensor(degree, dtype=f32, device=device) * (np.pi / 180)  # jnp.deg2rad
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    m_rot = mat([[cos, sin, cy - cos * cy - sin * cx],
                 [-sin, cos, cx + sin * cy - cos * cx],
                 [0.0, 0.0, 1.0]])
    m_flip = mat([[1.0, 0.0, 0.0], [0.0, -1.0, w - 1.0], [0.0, 0.0, 1.0]])
    top, left, ch, cw = (torch.as_tensor(v, dtype=f32, device=device)
                         for v in (top, left, ch, cw))
    m_crop = mat([[ch / h, 0.0, top + 0.5 * ch / h - 0.5],
                  [0.0, cw / w, left + 0.5 * cw / w - 0.5],
                  [0.0, 0.0, 1.0]])
    return m_crop, m_flip, m_rot


def _coords(m, h: int, w: int, device):
    """Source coordinates ``m @ (y, x, 1)`` of every output pixel: ``m`` is
    a list of the rows of one affine (an (H, W) field) or a (B, 3, 3)
    tensor (a (B, H, W) field)."""
    f32 = torch.float32
    yy = torch.arange(h, dtype=f32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=f32, device=device)[None, :].expand(h, w)
    if isinstance(m, torch.Tensor):
        m = m[:, :, :, None, None]
        return (m[:, 0, 0] * yy + m[:, 0, 1] * xx + m[:, 0, 2],
                m[:, 1, 0] * yy + m[:, 1, 1] * xx + m[:, 1, 2])
    return m[0][0] * yy + m[0][1] * xx + m[0][2], m[1][0] * yy + m[1][1] * xx + m[1][2]


def _composed_warp_coords(h, w, crop_gate, crop_box, flip_gate, rot_gate, degree, device):
    """Crop -> hflip -> rotate as ONE affine source-coordinate field, each
    op's 3x3 matrix gated to the identity.  The matrices are float32 on the
    host, multiplied term by term in the JAX dot's order; the field is
    float32 on ``device``."""
    m_crop, m_flip, m_rot = _affines(h, w, *crop_box, degree, "cpu")
    eye = torch.eye(3, dtype=torch.float32)
    m = _mm3(_mm3(m_crop if crop_gate else eye, m_flip if flip_gate else eye),
             m_rot if rot_gate else eye)
    return _coords(m.tolist(), h, w, device)


def _composed_warp_coords_per_sample(h, w, crop_gate, crop_box, flip_gate, rot_gate, degree):
    """:func:`_composed_warp_coords` with one affine per sample: (B,) gates,
    crop box and degrees on the device -> a (B, H, W) field.  A sample whose
    gates are all off gets the identity, exactly."""
    dev = degree.device
    m_crop, m_flip, m_rot = _affines(h, w, *crop_box, degree, dev, batch=degree.shape)
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    def gated(gate, m):
        return torch.where(gate[:, None, None], m, eye)

    m = _mm3(_mm3(gated(crop_gate, m_crop), gated(flip_gate, m_flip)), gated(rot_gate, m_rot))
    return _coords(m, h, w, dev)


def _one_of(gate, ops, name, params, x):
    fn = {n: f for n, f, _ in ops}[name]
    return torch.where(gate, fn(x, **params).to(x.dtype), x)


def _host_index(select: torch.Tensor, device: torch.device) -> torch.Tensor | None:
    """The indices where the host bool tensor ``select`` holds, on ``device``
    (None if there are none); to a card through pinned memory, without
    waiting for the device."""
    idx = select.nonzero().flatten()
    if idx.numel() == 0:
        return None
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx.to(device)


def _one_of_per_sample(gate, ops, choice, params, x):
    """Each op of the block once, on the samples whose ``choice`` it is
    (index, apply, scatter back); ``params[op]`` holds every sample's."""
    out = torch.empty_like(x)
    for k, (name, fn, _) in enumerate(ops):
        idx = _host_index(choice == k, x.device)
        if idx is None:
            continue
        sub = {p: v.index_select(0, idx) for p, v in params[name].items()}
        out.index_copy_(0, idx, fn(x.index_select(0, idx), **sub).to(x.dtype))
    return torch.where(gate, out, x)


def _photometric_tail(img: torch.Tensor, params: dict, tiled_clahe: bool) -> torch.Tensor:
    """The per-sample ops after the warp, then the clip to [0, 1]."""
    outer = params["outer"]
    img = torch.where(outer & params["pca_gate"], _fancy_pca(img, params["pca_alpha"]), img)
    img = torch.where(outer & params["shuffle_gate"],
                      _channel_shuffle(img, params["shuffle_idx"]), img)
    img = torch.where(outer & params["gray_gate"], _to_gray(img), img)

    img = torch.where(params["hsv_gate"],
                      _hsv_shift(img, params["hsv_dh"], params["hsv_ds"], params["hsv_dv"]), img)
    clahe = _clahe_tiled if tiled_clahe else _clahe
    img = torch.where(params["clahe_gate"], clahe(img, params["clahe_clip"]), img)
    img = torch.where(params["tone_gate"], _tone_curve(img, params["tone_z"]), img)
    return img.clamp(0.0, 1.0)


@torch.no_grad()
def apply_augment(images: torch.Tensor, masks: torch.Tensor, params: dict,
                  tiled_clahe: bool | None = None):
    """Augment an NHWC batch (images in [0, 1]) and its masks with the
    values of ``params`` (:func:`draw_augment_params`).  Returns bfloat16
    images clipped to [0, 1] and bfloat16 masks.  ``tiled_clahe`` defaults
    to ``AUGMENT_TILED_CLAHE``."""
    if tiled_clahe is None:
        tiled_clahe = TILED_CLAHE
    _, h, w, _ = images.shape
    img, mask = images.to(torch.bfloat16), masks.to(torch.bfloat16)

    x = _one_of(params["blur_gate"], _BLUR_OPS, params["blur_op"], params["blur"], img)
    x = _one_of(params["color_gate"], _COLOR_OPS, params["color_op"], params["color"], x)
    img = torch.where(params["outer"], x, img)

    if params["crop_gate"] or params["rot_gate"]:
        ys, xs = _composed_warp_coords(h, w, params["crop_gate"], params["crop_box"],
                                       params["flip_gate"], params["rot_gate"],
                                       params["degree"], img.device)
        img, mask = _bilinear_warp(img, ys, xs), _nearest_warp(mask, ys, xs)
    elif params["flip_gate"]:
        # flip-only steps: a reversal, not a 4-gather warp
        img, mask = img.flip(2), mask.flip(2)
    return _photometric_tail(img, params, tiled_clahe), mask


@torch.no_grad()
def apply_augment_per_sample(images: torch.Tensor, masks: torch.Tensor, params: dict,
                             tiled_clahe: bool | None = None):
    """:func:`apply_augment` with per-sample values
    (:func:`draw_augment_params_per_sample`): the OneOf blocks split the
    batch by op, and one (B, H, W) coordinate field warps every sample,
    the identity where its gates are off (integer coordinates give a
    fraction of 0, so an identity warp changes nothing).  Sample ``i``
    equals :func:`apply_augment` of the singleton batch ``[i]`` with
    ``sample_augment_params(params, i)``."""
    if tiled_clahe is None:
        tiled_clahe = TILED_CLAHE
    _, h, w, _ = images.shape
    img, mask = images.to(torch.bfloat16), masks.to(torch.bfloat16)

    x = _one_of_per_sample(params["blur_gate"], _BLUR_OPS, params["blur_choice"],
                           params["blur"], img)
    x = _one_of_per_sample(params["color_gate"], _COLOR_OPS, params["color_choice"],
                           params["color"], x)
    img = torch.where(params["outer"], x, img)

    ys, xs = _composed_warp_coords_per_sample(h, w, params["crop_gate"], params["crop_box"],
                                              params["flip_gate"], params["rot_gate"],
                                              params["degree"])
    img, mask = _bilinear_warp(img, ys, xs), _nearest_warp(mask, ys, xs)
    return _photometric_tail(img, params, tiled_clahe), mask


def augment_batch(gens, images: torch.Tensor, masks: torch.Tensor):
    """:func:`draw_augment_params` then :func:`apply_augment`.  ``gens`` is
    ``(host_gen, device_gen)``: a CPU generator for the batch-uniform draws
    and a generator on the images' device for the per-sample draws."""
    host_gen, device_gen = gens
    b, h, w, _ = images.shape
    return apply_augment(images, masks, draw_augment_params(host_gen, device_gen, b, h, w))


def augment_sample(gens, img: torch.Tensor, mask: torch.Tensor):
    """Single-sample convenience wrapper of :func:`augment_batch`: HWC in,
    HWC float32 out."""
    imgs, masks = augment_batch(gens, img[None], mask[None])
    return imgs[0].float(), masks[0].float()


def augment_batch_per_sample(gens, images: torch.Tensor, masks: torch.Tensor):
    """:func:`augment_batch` with per-sample granularity, the reference's:
    :func:`draw_augment_params_per_sample` then
    :func:`apply_augment_per_sample`.  ``gens`` is ``(host_gen,
    device_gen)``: the host generator draws the OneOf choices, the device
    generator everything else."""
    host_gen, device_gen = gens
    b, h, w, _ = images.shape
    params = draw_augment_params_per_sample(host_gen, device_gen, b, h, w)
    return apply_augment_per_sample(images, masks, params)
