"""The port's device augmentation (``ecologysemanticsegmentation_torch/data/augment.py``)
held against the JAX package's ``data/augment.py``.

The two packages cannot share a PRNG stream, so every random value is drawn
by the JAX package's own ``jax.random`` calls and injected into the port:

* each op in float32, with the parameters from the same ``jax.random`` calls
  the JAX op makes, against the JAX op run op by op, at atol 1e-5 (f32
  arithmetic in another order; bf16 parameters are the same bf16 values);
  the CLAHE ops count luminance-bin flips separately (a luminance one f32
  ulp apart can land in the next bin);
* the warps on exact coordinates; masks keep values in {-1, 0, 1};
* the whole bf16 pipeline: a helper rebuilds ``augment_batch``'s split tree
  (``augment.py:595-666``) in JAX to get every draw, feeds them to the
  port's ``apply_augment`` and compares with ``jax.jit(augment_batch)``, for
  both CLAHE forms (one compile of each, module-scoped);
* the port's augmented step equals its unaugmented step applied to its own
  ``augment_batch`` output from the same generators.

Inputs are made with numpy from a seed, B = 2, 32-64 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_tpu.data import augment as ja
from ecologysemanticsegmentation_torch.data import augment as pa
from _torch_parallel_ranks import bound_threads

bound_threads()

ATOL = 1e-5
B = 2


def _img(h=32, w=32, seed=0):
    return np.random.RandomState(seed).rand(B, h, w, 3).astype(np.float32)


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    """A JAX draw as a torch tensor of the same dtype (bf16 stays bf16)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _op_params(name, key, b, h, w):
    """The parameters the JAX op ``name`` draws from ``key``, in the port's
    keyword names (augment.py:235-495)."""
    if name in ("defocus", "gauss_blur", "zoom_blur", "to_gray"):
        return {}
    if name == "fog":
        k1, k2 = jax.random.split(key)
        return {"coef": ja._u(k1, b, 0.3, 1.0),
                "field": jax.random.uniform(k2, (b, max(h // 16, 1), max(w // 16, 1), 1))}
    if name == "color_jitter":
        kb, kc, ks, kh = jax.random.split(key, 4)
        return {"bright": ja._u(kb, b, 0.6, 1.4), "contr": ja._u(kc, b, 0.6, 1.4),
                "sat": ja._u(ks, b, 0.6, 1.4),
                "hshift": jax.random.uniform(kh, (b, 1, 1), minval=-0.4, maxval=0.4)}
    if name == "brightness_contrast":
        kb, kc = jax.random.split(key)
        return {"contrast": ja._u(kc, b, -0.2, 0.2), "brightness": ja._u(kb, b, -0.2, 0.2)}
    if name == "gamma":
        return {"g": ja._u(key, b, 0.8, 1.2)}
    if name == "emboss":
        ka, ks = jax.random.split(key)
        return {"alpha": ja._u(ka, b, 0.3, 0.6), "strength": ja._u(ks, b, 0.3, 0.7)}
    if name == "fancy_pca":
        return {"alphas": jax.random.normal(key, (b, 3))}
    if name == "channel_shuffle":
        return {"idx": jax.random.randint(key, (b,), 0, 6)}
    if name == "hsv_shift":
        kh, ks, kv = jax.random.split(key, 3)
        return {"dh": jax.random.uniform(kh, (b, 1, 1), minval=-60, maxval=60) / 180.0,
                "ds": jax.random.uniform(ks, (b, 1, 1), minval=-60, maxval=60) / 255.0,
                "dv": jax.random.uniform(kv, (b, 1, 1), minval=-30, maxval=30) / 255.0}
    if name in ("clahe", "clahe_tiled"):
        return {"clip_limit": jax.random.uniform(key, (b,), minval=1.0, maxval=4.0)}
    if name == "tone_curve":
        return {"z": jax.random.normal(key, (b, 1, 1, 1))}
    raise KeyError(name)


def _run_both(name, x, seed):
    """The JAX op on (key, x) and the port's op on x and the JAX draws."""
    key = jax.random.PRNGKey(seed)
    b, h, w, _ = x.shape
    want = _np(getattr(ja, f"_{name}")(key, jnp.asarray(x)))
    params = {k: _t(v) for k, v in _op_params(name, key, b, h, w).items()}
    got = getattr(pa, f"_{name}")(torch.from_numpy(x), **params)
    assert got.dtype == torch.float32, name
    return got.numpy(), want


@pytest.mark.parametrize("name", [
    "defocus", "gauss_blur", "zoom_blur", "fog", "color_jitter", "brightness_contrast",
    "gamma", "emboss", "fancy_pca", "channel_shuffle", "to_gray", "hsv_shift", "tone_curve",
])
def test_op_f32(name):
    x = _img(32, 48, seed=1)
    # the colour ops see out-of-range values too, as after an earlier op
    x = x * 1.2 - 0.1 if name in ("color_jitter", "hsv_shift", "tone_curve", "gamma") else x
    got, want = _run_both(name, x.astype(np.float32), seed=7)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name,h,w", [
    ("clahe", 32, 48), ("clahe_tiled", 32, 64), ("clahe_tiled", 40, 48),  # 40: global fallback
])
def test_clahe_f32(name, h, w):
    """CLAHE at atol 1e-5 on every pixel whose luminance falls in the same
    bin in both packages.  A luminance one f32 ulp apart on a bin edge moves
    its pixel to the next bin (and its histogram count with it): such bin
    flips are counted, and must stay below 0.1% of the pixels."""
    x = _img(h, w, seed=2)
    got, want = _run_both(name, x, seed=11)
    bins = 64 if name == "clahe_tiled" and not (h % 16 or w % 16) else 32

    def bin_of(luma):
        return np.floor(np.clip(np.asarray(luma), 0, 1) * (bins - 1))

    same = bin_of(pa._luma(torch.from_numpy(x).clamp(0, 1)).numpy()) == bin_of(
        ja._luma(jnp.clip(jnp.asarray(x), 0, 1)))
    assert 1 - same.mean() < 1e-3, 1 - same.mean()
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=ATOL)


def test_helpers_f32():
    """RGB<->HSV, luma, reflect101 and the 3x3 eigendecomposition."""
    x = _img(16, 16, seed=3) * 1.2 - 0.1
    xt = torch.from_numpy(x)
    hsv = _np(ja._rgb_to_hsv(jnp.asarray(x)))
    np.testing.assert_allclose(pa._rgb_to_hsv(xt).numpy(), hsv, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pa._hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               _np(ja._hsv_to_rgb(jnp.asarray(hsv))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pa._luma(xt).numpy(), _np(ja._luma(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    idx = np.arange(-70, 70, dtype=np.int32)
    for n in (1, 2, 7, 32):
        np.testing.assert_array_equal(pa._reflect101(torch.from_numpy(idx), n).numpy(),
                                      np.asarray(ja._reflect101(jnp.asarray(idx), n)))
    rs = np.random.RandomState(4)
    a = rs.randn(5, 3, 3).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(3, dtype=np.float32)
    val, vec = pa._eigh3x3(torch.from_numpy(a))
    jval, jvec = ja._eigh3x3(jnp.asarray(a))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=0, atol=1e-4)


# (crop_g, flip_g, rot_g, degree) of the composed-warp cases
_WARPS = {
    "crop": (True, False, False, 0.0),
    "flip": (False, True, False, 0.0),
    "rot37": (False, False, True, 37.0),
    "crop-flip-rot": (True, True, True, 33.0),
    "none": (False, False, False, 0.0),
}


@pytest.mark.parametrize("case", list(_WARPS))
def test_composed_warp(case):
    """Coordinates, the bilinear image warp and the nearest mask warp in
    f32 against the JAX functions on the same crop box; masks stay in
    {-1, 0, 1} and agree except at round-half ties of coordinates one f32
    ulp apart."""
    crop_g, flip_g, rot_g, degree = _WARPS[case]
    h, w = 32, 48
    top, left, ch, cw = 3.25, 5.5, 20.0, 30.75
    ys, xs = ja._composed_warp_coords(
        h, w, jnp.bool_(crop_g), jnp.float32(top), jnp.float32(left), jnp.float32(ch),
        jnp.float32(cw), jnp.bool_(flip_g), jnp.bool_(rot_g), jnp.float32(degree))
    pys, pxs = pa._composed_warp_coords(h, w, crop_g, (top, left, ch, cw), flip_g, rot_g,
                                        degree, torch.device("cpu"))
    np.testing.assert_allclose(pys.numpy(), np.asarray(ys), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pxs.numpy(), np.asarray(xs), rtol=0, atol=1e-5)
    rs = np.random.RandomState(5)
    img = rs.rand(B, h, w, 3).astype(np.float32)
    mask = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(B, h, w, 3))
    np.testing.assert_allclose(
        pa._bilinear_warp(torch.from_numpy(img), pys, pxs).numpy(),
        np.asarray(ja._bilinear_warp(jnp.asarray(img), ys, xs)), rtol=0, atol=ATOL)
    got_m = pa._nearest_warp(torch.from_numpy(mask), pys, pxs).numpy()
    want_m = np.asarray(ja._nearest_warp(jnp.asarray(mask), ys, xs))
    assert set(np.unique(got_m)) <= {-1.0, 0.0, 1.0}
    assert (got_m != want_m).mean() < 0.01


# ---------------------------------------------------------------- pipeline


def _jax_pipeline_params(key, b, h, w):
    """Every draw of ``augment_batch(key, ...)`` (augment.py:595-666), taken
    with the same jax.random calls, in the port's ``params`` format."""
    (k_outer, k_blur, k_color, k_crop_p, k_crop, k_flip, k_pca, k_shuf, k_gray,
     k_hsv, k_clahe, k_rot, k_tone, _) = jax.random.split(key, 14)
    p = {"outer": ja._gate(k_outer, 0.7, b)}
    for block, names, k in (("blur", pa.BLUR_NAMES, k_blur), ("color", pa.COLOR_NAMES, k_color)):
        kg, kc, kf = jax.random.split(k, 3)
        p[f"{block}_gate"] = ja._gate(kg, 0.4, b)
        p[f"{block}_op"] = names[int(jax.random.randint(kc, (), 0, len(names)))]
        p[block] = _op_params(p[f"{block}_op"], kf, b, h, w)
    ks1, ks2, ks3, ks4 = jax.random.split(k_crop, 4)
    scale = jax.random.uniform(ks1, (), minval=0.08, maxval=1.0)
    log_ratio = jax.random.uniform(ks2, (), minval=np.log(0.75), maxval=np.log(4 / 3))
    area = scale * h * w
    cw = jnp.clip(jnp.sqrt(area * jnp.exp(log_ratio)), 8.0, w)
    ch = jnp.clip(jnp.sqrt(area / jnp.exp(log_ratio)), 8.0, h)
    top = jax.random.uniform(ks3, ()) * (h - ch)
    left = jax.random.uniform(ks4, ()) * (w - cw)
    p["crop_box"] = tuple(float(v) for v in (top, left, ch, cw))
    p["crop_gate"] = bool(jax.random.bernoulli(k_crop_p, 0.7 * 0.3))
    p["flip_gate"] = bool(jax.random.bernoulli(k_flip, 0.7 * 0.5))
    kd1, kd2, kg = jax.random.split(k_rot, 3)
    degree = float(jax.random.randint(kd1, (), 0, 90))
    p["degree"] = 0.0 if bool(jax.random.bernoulli(kd2, 0.2)) else degree
    p["rot_gate"] = bool(jax.random.bernoulli(kg, 0.4))
    kp1, kp2 = jax.random.split(k_pca)
    p["pca_gate"], p["pca_alpha"] = ja._gate(kp1, 0.3, b), jax.random.normal(kp2, (b, 3))
    ksh1, ksh2 = jax.random.split(k_shuf)
    p["shuffle_gate"] = ja._gate(ksh1, 0.5, b)
    p["shuffle_idx"] = jax.random.randint(ksh2, (b,), 0, 6)
    p["gray_gate"] = ja._gate(k_gray, 0.3, b)
    kh1, kh2 = jax.random.split(k_hsv)
    p["hsv_gate"] = ja._gate(kh1, 0.4, b)
    for k, v in _op_params("hsv_shift", kh2, b, h, w).items():
        p[f"hsv_{k}"] = v
    kc1, kc2 = jax.random.split(k_clahe)
    p["clahe_gate"] = ja._gate(kc1, 0.7, b)
    p["clahe_clip"] = _op_params("clahe", kc2, b, h, w)["clip_limit"]
    kt1, kt2 = jax.random.split(k_tone)
    p["tone_gate"], p["tone_z"] = ja._gate(kt1, 0.5, b), jax.random.normal(kt2, (b, 1, 1, 1))
    return {k: (v if isinstance(v, (bool, float, str, tuple)) else
                {kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v))
            for k, v in p.items()}


def _fired(p):
    """The OneOf branches that fired on some sample, and the warp."""
    names = [p[f"{blk}_op"] for blk in ("blur", "color")
             if bool((p[f"{blk}_gate"] & p["outer"]).any())]
    warp = "+".join(n for n in ("crop", "flip", "rot") if p[f"{n}_gate"]) or "nowarp"
    return "-".join(names + [warp])


# Keys whose draws, over the set, fire every OneOf branch on at least one
# sample and run the warp composed, flip-only and not at all; the id names
# the OneOf branches that fired and the warp, and the test checks it.
PIPELINE_KEYS = {
    1: "brightness_contrast-crop+flip+rot",
    3: "fog-gamma-nowarp",
    5: "color_jitter-crop+flip",
    14: "gauss_blur-gamma-rot",
    18: "zoom_blur-flip",
    22: "defocus-emboss-nowarp",
}
PIPE_H, PIPE_W = 32, 48
# bf16 tolerance: every value within 2 bf16 ulps of the reference (XLA keeps
# f32 between fused ops where the port rounds after each), except on at most
# 1% of the pixels, where one rounding difference moved the pixel across a
# CLAHE luminance bin or an HSV hue sector; those stay within 1/16.
ULPS, FLIP_FRAC, FLIP_MAX = 2, 0.01, 1 / 16


@pytest.fixture(scope="module")
def jax_pipelines():
    """``jax.jit(augment_batch)`` compiled once for each CLAHE form.  The
    module flag is read at trace time, and jit caches traces by function,
    so each form traces a function object of its own."""
    compiled = {}
    x = jnp.zeros((B, PIPE_H, PIPE_W, 3), jnp.float32)
    for tiled in (False, True):
        saved = ja.TILED_CLAHE
        ja.TILED_CLAHE = tiled
        try:
            fn = functools.partial(ja.augment_batch.__wrapped__)
            compiled[tiled] = jax.jit(fn).lower(jax.random.PRNGKey(0), x, x).compile()
        finally:
            ja.TILED_CLAHE = saved
    return compiled


def _bf16_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("tiled", [False, True], ids=["global", "tiled"])
@pytest.mark.parametrize("seed", list(PIPELINE_KEYS),
                         ids=[f"key{k}-{v}" for k, v in PIPELINE_KEYS.items()])
def test_pipeline_bf16(jax_pipelines, seed, tiled):
    rs = np.random.RandomState(100 + seed)
    images = rs.rand(B, PIPE_H, PIPE_W, 3).astype(np.float32)
    masks = rs.choice(np.array([-1.0, 0.0, 1.0, 2.0], np.float32), size=(B, PIPE_H, PIPE_W, 3))
    key = jax.random.PRNGKey(seed)
    jimg, jmask = jax_pipelines[tiled](key, jnp.asarray(images), jnp.asarray(masks))
    params = _jax_pipeline_params(key, B, PIPE_H, PIPE_W)
    assert _fired(params) == PIPELINE_KEYS[seed]
    img, mask = pa.apply_augment(torch.from_numpy(images), torch.from_numpy(masks), params,
                                 tiled_clahe=tiled)
    assert img.dtype == mask.dtype == torch.bfloat16
    assert tuple(img.shape) == tuple(mask.shape) == images.shape
    got, want = img.float().numpy(), _np(jimg)
    got_m, want_m = mask.float().numpy(), _np(jmask)
    assert set(np.unique(got_m)) <= {-1.0, 0.0, 1.0, 2.0}
    assert (got_m != want_m).mean() < 0.01
    assert got.min() >= 0.0 and got.max() <= 1.0
    err = np.abs(got - want)
    flipped = (err > ULPS * _bf16_ulp(want)).any(-1)
    assert flipped.mean() <= FLIP_FRAC, (flipped.mean(), err.max())
    assert err.max() <= FLIP_MAX, err.max()


# --------------------------------------------------------------------- step


def test_augmented_step_is_step_of_augmented_batch():
    from ecologysemanticsegmentation_torch.models import DeepLabV3Plus
    from ecologysemanticsegmentation_torch.train import create_train_state, make_optimizer
    from ecologysemanticsegmentation_torch.train import make_train_step

    rs = np.random.RandomState(6)
    batch = {"image": torch.from_numpy(rs.rand(B, 32, 32, 3).astype(np.float32)),
             "label": torch.from_numpy(
                 rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(B, 32, 32, 3)))}
    runs = []
    for augment in (True, False):
        model = DeepLabV3Plus(num_classes=3, decoder_features=16, aspp_dropout=0.5,
                              upsample_head=False).to(memory_format=torch.channels_last)
        tx = make_optimizer(1e-3)
        state = create_train_state(model, torch.Generator().manual_seed(0), tx)
        step = make_train_step(model, tx, augment=augment, lowres_head=True)
        host, dev = torch.Generator().manual_seed(2), torch.Generator().manual_seed(3)
        if augment:
            state, met = step(state, batch, (host, dev), 0.0, [1.0, 1.0, 1.0], 1e-3, None)
        else:
            images, labels = pa.augment_batch((host, dev), batch["image"], batch["label"])
            state, met = step(state, {"image": images, "label": labels}, dev, 0.0,
                              [1.0, 1.0, 1.0], 1e-3, None)
        runs.append((met, [p.detach().clone() for p in model.parameters()]))
    (met_a, par_a), (met_b, par_b) = runs
    for k in met_a:
        assert torch.equal(met_a[k], met_b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(par_a, par_b))
    with pytest.raises(TypeError, match="host_gen"):
        step_a = make_train_step(model, make_optimizer(), augment=True, lowres_head=True)
        step_a(state, batch, torch.Generator(), 0.0, [1.0, 1.0, 1.0], 1e-3, None)
