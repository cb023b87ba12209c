"""Package-level checks of the PyTorch port (ecologysemanticsegmentation_torch).

* The port and chip_smoke.py import neither JAX nor the JAX package.
* Entry points run on CUDA by default and raise without a card unless the
  caller passes ``device="cpu"``.
* The head-loss wrapper rejects what its kernel does not take.
* ``-m gpu`` (on the H100): the CUDA kernels (head loss, its per-shard
  form, loss sums, tiled-CLAHE apply) build and agree with their plain
  versions.  Here,
  without a card, those tests skip.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ecologysemanticsegmentation_torch as est
from ecologysemanticsegmentation_torch.ops import clahe_tiled as ct
from ecologysemanticsegmentation_torch.ops import head_loss as hl
from ecologysemanticsegmentation_torch.ops import loss_sums as tls
from _torch_parallel_ranks import bound_threads

bound_threads()

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "ecologysemanticsegmentation_torch").rglob("*.py"))
    # The host data layer, the checkpoints and the CLI are among them, and
    # none names JAX, flax, optax, the JAX package or msgpack in an import.
    for new in ("config", "data.loaders", "data.native", "data.pipeline", "data.synthetic",
                "data.fish_dataset", "data.imops", "train.schedules", "train.checkpoint",
                "train._msgpack", "utils.profiling", "train_multiclass", "train.__main__"):
        assert f"ecologysemanticsegmentation_torch.{new}" in mods, new
    banned = ("jax", "jaxlib", "flax", "optax", "ecologysemanticsegmentation_tpu", "msgpack")
    for path in [ROOT / "chip_smoke.py",
                 *(ROOT / "ecologysemanticsegmentation_torch").rglob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not [n for n in names if n.split(".")[0] in banned], (path, names)
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'ecologysemanticsegmentation_tpu', 'msgpack'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 10


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.build_model(num_classes=3)
    assert est.resolve_device("cpu") == torch.device("cpu")
    model = est.build_model(num_classes=3, upsample_head=False, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert model.head.weight.is_contiguous(memory_format=torch.channels_last)


def test_build_model_names():
    """Every model of the JAX package's ``build_model`` builds, with its
    arguments; ``depthwise`` wins over the name."""
    from ecologysemanticsegmentation_torch import models

    kinds = {"deeplabv3plus": models.DeepLabV3Plus,
             "deeplabv3plus_depthwise": models.DeepLabV3PlusDepthwise, "unet": models.UNet,
             "vgg_unet": models.VGGUNet, "efficientnet_v2s_unet": models.EfficientNetV2SUNet}
    assert set(kinds) == set(models.MODEL_NAMES)
    for name, kind in kinds.items():
        assert type(est.build_model(name, num_classes=2, device="cpu")) is kind
    assert type(est.build_model("unet", depthwise=True, device="cpu")) \
        is models.DeepLabV3PlusDepthwise
    unet = est.build_model("unet", encoder_name="resnet50", device="cpu")
    assert unet.encoder.layer1_block0.conv3.weight.shape == (256, 64, 1, 1)
    vgg = est.build_model("vgg_unet", max_channels=512, deepsupervision=True, remat=True,
                          device="cpu")
    assert vgg.encoder.remat and len(vgg.ds_heads) == 5
    with pytest.raises(ValueError):
        est.build_model("no_such_model", device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        est.build_model("unet", encoder_name="resnet18", device="cpu")


def test_train_step_scope():
    """Augmentation, the full-resolution loss path, deep supervision and the
    spatial mesh are ported; the multi-step scan is not, nor a model other
    than DeepLabV3+ on a mesh."""
    model = est.build_model(num_classes=3, device="cpu")
    tx = est.make_optimizer()
    assert callable(est.make_train_step(model, tx, augment=True, lowres_head=True))
    for mode in ("none", "sequential", "general"):
        assert callable(est.make_train_step(model, tx, composite_mode=mode, lowres_head=False))
    assert callable(est.make_train_step(model, tx, deepsupervision=True))
    with pytest.raises(ValueError, match="deepsupervision"):
        est.make_train_step(model, tx, deepsupervision=True, lowres_head=True)
    with pytest.raises(NotImplementedError, match="on purpose"):
        est.make_train_step(model, tx, k_steps=2)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        est.make_train_step(model, tx, spatial_mesh=object())
    with pytest.raises(ValueError, match="lowres_head"):
        est.make_train_step(model, tx, composite_mode="sequential", lowres_head=True)
    with pytest.raises(ValueError, match="composite_mode"):
        est.make_train_step(model, tx, composite_mode="other")


def _ok():
    return torch.zeros(2, 4, 4, 3), torch.zeros(2, 16, 16, 3, dtype=torch.bfloat16)


@pytest.mark.parametrize("bad,err", [
    (lambda x, g: (x.half(), g), TypeError),                     # logits not f32
    (lambda x, g: (x, g.float()), TypeError),                    # labels not bf16
    (lambda x, g: (x[:1], g), ValueError),                       # batch differs
    (lambda x, g: (x[..., :2], g), ValueError),                  # channels differ
    (lambda x, g: (x[0], g[0]), ValueError),                     # not NHWC
    (lambda x, g: (torch.zeros(1, 4, 4, 17),
                   torch.zeros(1, 16, 16, 17, dtype=torch.bfloat16)), ValueError),  # C > 16
    (lambda x, g: (x.to("meta"), g.to("meta")), RuntimeError),   # no implementation
    (lambda x, g: (x.transpose(1, 2), g), ValueError),           # not contiguous
])
def test_head_loss_wrapper_rejects(bad, err):
    with pytest.raises(err):
        hl.fused_head_loss_sums(*bad(*_ok()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,scale,c,align_corners", [
    (2, 16, 4, 3, True), (3, 16, 4, 1, True), (1, 16, 4, 11, False), (1, 32, 4, 16, True),
    (2, 12, 3, 2, False), (2, 13, 4, 3, False),
])
def test_cuda_kernels_match_plain(cuda, b, h, scale, c, align_corners):
    """Forward sums at rtol 1e-4 (f32 sums in another order) against the
    plain version, the count row exactly; dlogits element by element at
    rtol 1e-4 / atol 1e-5 of max |dlogits| against the plain version in
    float64 (the kernel forms 1 - p without cancellation, which the f32
    plain version loses where p nears 1); a second launch bitwise equal."""
    rs = np.random.RandomState(0)
    logits = torch.tensor(rs.randn(b, h, h, c) * 3.0, dtype=torch.float32, device=cuda)
    labels = (rs.rand(b, h * scale, h * scale, c) > 0.5).astype(np.float32)
    labels[rs.rand(*labels.shape) < 0.05] = -1.0
    labels = torch.tensor(labels, device=cuda).to(torch.bfloat16)
    cot = torch.tensor(rs.randn(8, c), dtype=torch.float32, device=cuda)
    before = dict(hl.launches)
    x = logits.clone().requires_grad_()
    sums = hl.fused_head_loss_sums(x, labels, align_corners)
    (sums * cot).sum().backward()
    torch.cuda.synchronize()
    assert hl.launches["head_loss_fwd"] == before["head_loss_fwd"] + 1
    assert hl.launches["head_loss_bwd"] == before["head_loss_bwd"] + 1
    ref = hl.head_sums_reference(logits, labels, align_corners)
    dref = hl.head_sums_bwd_reference(logits.double(), labels, cot.double(), align_corners)
    torch.testing.assert_close(sums, ref, rtol=1e-4, atol=1e-3)
    assert torch.equal(sums[7], (labels >= 0).sum((0, 1, 2)).float())
    torch.testing.assert_close(x.grad.double(), dref, rtol=1e-4,
                               atol=1e-5 * dref.abs().max().item())
    assert torch.equal(hl.head_sums_cuda(logits, labels, align_corners), sums.detach())
    assert torch.equal(hl.head_sums_bwd_cuda(logits, labels, cot, align_corners), x.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", [(2, 3), (4, 3), (2, 1), (4, 11)])
def test_cuda_shard_kernels_match_plain(cuda, n, c):
    """Every row block of an n-way split (64 -> 256 rows, 4 images): the
    block's sums at rtol 1e-4 with the count row exact, its dlogits element
    by element at rtol 1e-4 / atol 1e-5 of max |dlogits| against the plain
    version in float64; the blocks' sums and dlogits added together equal
    the unsharded kernel's at the same bounds."""
    rs = np.random.RandomState(n * 16 + c)
    logits = torch.tensor(rs.randn(4, 64, 64, c), dtype=torch.float32, device=cuda)
    labels = (rs.rand(4, 256, 256, c) > 0.5).astype(np.float32)
    labels[rs.rand(*labels.shape) < 0.05] = -1.0
    labels = torch.tensor(labels, device=cuda).to(torch.bfloat16)
    cot = torch.tensor(rs.randn(8, c), dtype=torch.float32, device=cuda)
    rows = 256 // n
    total, dtotal = 0.0, 0.0
    for k in range(n):
        block = labels[:, k * rows:(k + 1) * rows].contiguous()
        before = dict(hl.launches)
        x = logits.clone().requires_grad_()
        sums = hl.fused_head_loss_sums_shard(x, block, 256, k * rows)
        (sums * cot).sum().backward()
        torch.cuda.synchronize()
        assert hl.launches["head_loss_shard_fwd"] == before["head_loss_shard_fwd"] + 1
        assert hl.launches["head_loss_shard_bwd"] == before["head_loss_shard_bwd"] + 1
        ref = hl.head_sums_shard_reference(logits, block, 256, k * rows)
        dref = hl.head_sums_shard_bwd_reference(logits.double(), block, cot.double(), 256,
                                                k * rows)
        torch.testing.assert_close(sums, ref, rtol=1e-4, atol=1e-3)
        assert torch.equal(sums[7], (block >= 0).sum((0, 1, 2)).float())
        torch.testing.assert_close(x.grad.double(), dref, rtol=1e-4,
                                   atol=1e-5 * dref.abs().max().item())
        total, dtotal = total + sums.detach(), dtotal + x.grad
    full = hl.head_sums_cuda(logits, labels)
    dfull = hl.head_sums_bwd_cuda(logits, labels, cot)
    torch.testing.assert_close(total, full, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dtotal, dfull, rtol=1e-4, atol=1e-5 * dfull.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,bins,tiles", [
    (2, 64, 64, 32, 8), (2, 64, 64, 64, 8), (1, 48, 80, 64, 8), (3, 256, 256, 64, 8),
    (1, 32, 32, 32, 4), (1, 512, 512, 64, 8), (2, 97, 101, 64, 8), (3, 40, 54, 32, 8),
])
def test_cuda_clahe_kernel_matches_plain(cuda, b, h, w, bins, tiles):
    """One launch from the deltas against the plain version (the x
    contraction, then the gated per-bin planes): the same f32 terms in
    another order, within 1e-5 (values <= 1).  Every 7th pixel is an edge
    luminance (0, exactly 1, just above 1, 1.1, just below 0, NaN, the bin
    edges k / (K - 1)); below bin 0 and NaN give 0.  Widths 101 and 54 take
    the kernel's scalar path.  A second launch is bitwise equal."""
    rs = np.random.RandomState(0)
    luma = rs.rand(b, h, w).astype(np.float32)
    edges = [0.0, 1.0, 1 + 1e-3, 1.1, -1e-3, np.nan] + [k / (bins - 1) for k in range(bins)]
    flat = luma.reshape(-1)
    flat[::7] = np.resize(np.asarray(edges, np.float32), flat[::7].shape)
    luma = torch.tensor(luma, device=cuda)
    hist = rs.rand(b, tiles, tiles, bins) + 0.1
    cdf = np.cumsum(hist, axis=-1)
    cdf /= cdf[..., -1:]
    deltas = torch.tensor(np.diff(cdf, axis=-1, prepend=0.0), dtype=torch.float32, device=cuda)
    before = ct.launches["clahe_tiled"]
    got = ct.tiled_clahe_new_luma(luma, deltas, tiles)
    torch.cuda.synchronize()
    assert ct.launches["clahe_tiled"] == before + 1
    want = ct.tiled_clahe_new_luma(luma.cpu(), deltas.cpu(), tiles)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    gated = torch.isnan(luma) | (torch.floor(luma * (bins - 1)) < 0)
    assert gated.any() and (got[gated] == 0).all()
    assert torch.equal(ct.tiled_clahe_new_luma(luma, deltas, tiles), got)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits, for equality that holds NaN equal to itself."""
    return t.contiguous().view(torch.int32)


def _grad_leaf(a: np.ndarray, device, offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A leaf that requires grad and a view of ``a``'s values in it,
    ``offset`` elements into its storage (1: not 16-byte aligned)."""
    base = torch.zeros(a.size + offset, dtype=torch.float32, device=device)
    base[offset:] = torch.from_numpy(a.reshape(-1)).to(device)
    base.requires_grad_()
    return base, base[offset:].view(a.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sl,swapped,variant", [
    ((2, 16, 16, 3), None, False, None), ((3, 9, 11, 1), None, False, None),
    ((1, 33, 35, 11), None, False, None), ((2, 8, 8, 3), slice(1, 2), False, None),
    ((1, 64, 64, 16), None, False, None), ((3, 9, 11, 1), None, True, None),
    ((2, 16, 16, 3), None, False, "edges"),     # p exactly 0 and 1 under labels 0 and 1
    ((3, 9, 11, 1), None, True, "edges"),       # the same in the swapped call's g slot
    ((2, 16, 17, 3), None, False, "offset"),    # storage offset: not 16-byte aligned
    ((2, 16, 16, 1), None, True, "offset"),
    ((3, 9, 11, 3), None, False, None),         # N * C not a multiple of the vector group
    ((1, 37, 29, 16), None, False, None),       # the same at C = 16
    ((8, 512, 512, 3), None, False, None),      # more than one pass of the one-wave grid
    ((4, 512, 512, 1), None, True, None),
])
def test_cuda_loss_sums_kernels_match_plain(cuda, shape, sl, swapped, variant):
    """Sums at rtol 1e-4 (f32 sums in another order), the count row
    exactly; dp and dg element by element at rtol 1e-4, atol 1e-5 (the same
    function per element, the kernel's FMAs and approximate transcendentals
    a few ulps apart).  ``swapped`` is the single-organ call: {-1, 0, 1}
    labels in the p slot, so rows 4-5 and dp are NaN at a -1 label in both,
    and dg stays finite.  Contiguous aligned inputs take the flat stream,
    the others the pixel stride; each kernel's second launch is bitwise
    equal to its first."""
    rs = np.random.RandomState(0)
    g = (rs.rand(*shape) > 0.5).astype(np.float32)
    g[rs.rand(*shape) < 0.05] = -1.0
    p = rs.rand(*shape).astype(np.float32)
    if variant == "edges":
        p.reshape(-1)[::5] = 0.0
        p.reshape(-1)[1::5] = 1.0
    if swapped:
        p, g = g, p
    offset = 1 if variant == "offset" else 0
    pbase, pf = _grad_leaf(p, cuda, offset)
    gbase, gf = _grad_leaf(g, cuda, offset)
    sl = slice(None) if sl is None else sl
    p, g = pf[..., sl], gf[..., sl]  # a slice is read in place, through its pixel stride
    c = p.shape[-1]
    rows = [tls._rows(t.detach().reshape(-1, c)) for t in (p, g)]
    assert tls._vector_path(rows[0][0], rows[1][0], rows[0][1], rows[1][1]) == (
        variant != "offset" and sl == slice(None))
    cot = torch.tensor(rs.randn(8, c), dtype=torch.float32, device=cuda)
    before = dict(tls.launches)
    sums = tls.loss_sums_nhwc(p, g)
    (sums * cot).sum().backward()
    torch.cuda.synchronize()
    p, g = p.detach(), g.detach()
    assert tls.launches["loss_sums_fwd"] == before["loss_sums_fwd"] + 1
    assert tls.launches["loss_sums_bwd"] == before["loss_sums_bwd"] + 1
    p2, g2 = p.reshape(-1, c).T, g.reshape(-1, c).T
    ref = tls._sums_reference(p2, g2)
    dref, gref = tls.loss_sums_bwd_reference(p2, g2, cot)
    torch.testing.assert_close(sums, ref, rtol=1e-4, atol=1e-3, equal_nan=swapped)
    assert torch.equal(sums[7], (g >= 0).reshape(-1, c).sum(0).float())
    assert torch.isnan(ref[4:6]).all() == swapped and torch.isfinite(ref[[0, 1, 2, 3, 6, 7]]).all()
    assert torch.equal(torch.isnan(sums), torch.isnan(ref))
    dp = pbase.grad[offset:].view(pf.shape)[..., sl].reshape(-1, c).T
    dg = gbase.grad[offset:].view(gf.shape)[..., sl].reshape(-1, c).T
    torch.testing.assert_close(dp, dref, rtol=1e-4, atol=1e-5, equal_nan=swapped)
    torch.testing.assert_close(dg, gref, rtol=1e-4, atol=1e-5)
    assert torch.equal(torch.isnan(dp), torch.isnan(dref))
    assert torch.isfinite(gbase.grad).all()
    # repeat launches are bitwise equal, NaN included
    assert torch.equal(_bits(tls.loss_sums_nhwc(p, g)), _bits(sums))
    dp1, dg1 = tls.loss_sums_bwd_cuda(p.reshape(-1, c), g.reshape(-1, c), cot)
    dp2, dg2 = tls.loss_sums_bwd_cuda(p.reshape(-1, c), g.reshape(-1, c), cot)
    assert torch.equal(_bits(dp1), _bits(dp2)) and torch.equal(_bits(dg1), _bits(dg2))
    assert torch.equal(_bits(dp1.T), _bits(dp))
