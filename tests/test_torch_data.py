"""The port's host data layer against the JAX package's, on the CPU.

* ``config``: ``EnvConfig`` over a table of env cases, the registry and the
  constants;
* ``data.synthetic``: samples bitwise equal for several seeds and indices;
* ``data.loaders``: the four scanners on the JAX package's own
  ``materialize_to_disk`` fixture (plus a readable and an unreadable
  ``.arw``): the same items, arrays and skipped RAW files;
* ``data.fish_dataset``: the splits, their items and ``get_relative_ratios``;
* ``data.pipeline``: ``Batcher`` batches, ``n_real`` and drop-single equal;
  ``cuda_prefetch`` on the CPU;
* ``data.native``: the binding's functions equal the JAX binding's;
* ``data.imops`` without cv2 and PIL: ``imwrite_bgr`` writes a PNG that
  cv2 reads back exactly; the readers return None.

Both packages draw with cv2 here, so the arrays compare bitwise.
"""

import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from ecologysemanticsegmentation_torch import config as tconfig
from ecologysemanticsegmentation_torch import data as tdata
from ecologysemanticsegmentation_torch.data import imops as timops
from ecologysemanticsegmentation_torch.data import loaders as tloaders
from ecologysemanticsegmentation_torch.data import native as tnative
from ecologysemanticsegmentation_tpu import config as jconfig
from ecologysemanticsegmentation_tpu import data as jdata
from ecologysemanticsegmentation_tpu.data import loaders as jloaders
from ecologysemanticsegmentation_tpu.data import native as jnative
from ecologysemanticsegmentation_tpu.data import pipeline as jpipeline
from _torch_parallel_ranks import bound_threads

bound_threads()


@pytest.fixture(autouse=True, scope="module")
def _jax_binding_on_the_ports_library():
    """The JAX binding loads the library the port built (under a temporary
    name, renamed into place) instead of compiling ``native/libhostops.so``
    in place, which a JAX test in another worker may be loading meanwhile.
    Both are built from the same ``native/hostops.cpp``."""
    tnative.native_available()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(tnative.library_path()))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        yield


ORGANS3 = ("whole_body", "ventral_side", "dorsal_side")
ENV_KEYS = ("SAMPLE", "IMGSIZE", "IMG_SIZE", "MAXCHANNELS", "ORGANS", "EXPTNAME", "BBOX_DIR")


def _same(a, b) -> bool:
    """Deep equality of nested lists/tuples/dicts of arrays and scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


# ------------------------------------------------------------------ config

ENV_CASES = [
    {},
    {"IMG_SIZE": "128"},
    {"IMGSIZE": "64", "IMG_SIZE": "128"},
    {"SAMPLE": "0"},
    {"SAMPLE": "1"},
    {"SAMPLE": ""},
    {"SAMPLE": "false"},
    {"ORGANS": "whole_body,,"},
    {"ORGANS": "whole_body,ventral_side,dorsal_side", "MAXCHANNELS": "64",
     "EXPTNAME": "expt", "BBOX_DIR": "repaired"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=[",".join(f"{k}={v}" for k, v in e.items())
                                                or "defaults" for e in ENV_CASES])
def test_env_config_matches(env, monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tconfig.EnvConfig.from_env(), jconfig.EnvConfig.from_env()
    assert tconfig.asdict(t) == jconfig.asdict(j)
    assert t.num_classes == j.num_classes
    assert t.checkpoint_dir("m") == j.checkpoint_dir("m")
    assert tconfig.describe(t) == jconfig.describe(j)


def test_registry_and_constants_match():
    assert tconfig.datasets_metadata is not None
    assert tconfig.datasets_metadata == jconfig.datasets_metadata
    for name in ("DATASET_SPLITS", "CPARTS", "DATASET_TYPES", "MIN_SEGMENT_POSITIVITY_RATIO"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name


# --------------------------------------------------------------- synthetic

@pytest.mark.parametrize("seed,organs,size,indices", [
    (0, ORGANS3, 64, (0, 5, 31)),
    (3, ORGANS3, 48, (1, 2)),
    (11, ("whole_body",), 64, (0, 7)),
])
def test_synthetic_samples_bitwise(seed, organs, size, indices):
    t = tdata.get_synthetic_data(img_shape=size, organs=organs, num_samples=32, seed=seed)
    j = jdata.get_synthetic_data(img_shape=size, organs=organs, num_samples=32, seed=seed)
    assert len(t) == len(j)
    for i in indices:
        assert _same(t[i], j[i]), i


def test_synthetic_sample_flag_and_split_views(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SAMPLE", "1")
    monkeypatch.setenv("IMGSIZE", "32")
    monkeypatch.setenv("ORGANS", ",".join(ORGANS3))
    t = tdata.get_split_datasets(synthetic=True)
    j = jdata.get_split_datasets(synthetic=True)
    assert [len(s) for s in t] == [len(s) for s in j] == [27, 1, 4]
    for ts, js in zip(t, j):
        for i in range(len(ts)):
            assert _same(ts[i], js[i])


# ----------------------------------------------------------------- loaders

def _write_arw(path: Path, img_bgr: np.ndarray) -> None:
    """A TIFF whose IFD0 carries the JPEG preview tag pair (0x0201/0x0202)."""
    ok, jpg = cv2.imencode(".jpg", img_bgr)
    assert ok
    jpg = jpg.tobytes()
    buf = struct.pack("<2sHI", b"II", 42, 8) + struct.pack("<H", 2)
    buf += struct.pack("<HHII", 0x0201, 4, 1, 8 + 2 + 24 + 4)
    buf += struct.pack("<HHII", 0x0202, 4, 1, len(jpg))
    buf += struct.pack("<I", 0) + jpg
    path.write_bytes(buf)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fishdata")
    registry = jdata.materialize_to_disk(str(root), num_samples=6, size=64)
    # ml_training_set: a RAW original with a JPEG preview, and one without
    # (skipped and recorded by both packages).
    mlts = root / "mlts" / "batch1"
    img = np.zeros((40, 48, 3), np.uint8)
    img[10:30, 12:36] = (20, 180, 240)
    _write_arw(mlts / "original image" / "raw_ok.arw", img)
    (mlts / "original image" / "raw_bad.arw").write_bytes(b"II*\x00garbage")
    for stem in ("raw_ok", "raw_bad"):
        cv2.imwrite(str(mlts / "whole body" / f"{stem}.png"), 255 - img)
    return str(root), registry


@pytest.mark.parametrize("name,folder,dtype", [
    ("alvaradolab", "coco", "segmentation/composite"),
    ("ml_training_set", "mlts", "segmentation/composite"),
    ("suim", "suim", "segmentation"),
    ("deepfish_segclsloc", "deepfish", "segmentation"),
])
def test_loaders_match(fixture_root, name, folder, dtype):
    root, _ = fixture_root
    t = tloaders.LOADERS[name](dtype, folder, root, 64, 0.0075, organs=ORGANS3)
    j = jloaders.LOADERS[name](dtype, folder, root, 64, 0.0075, organs=ORGANS3)
    assert t.name == j.name and t.organs == j.organs
    assert len(t) == len(j) > 0
    assert _same(t.items, j.items)
    for i in range(len(t)):
        assert _same(t[i], j[i]), (name, i)
    # Each package's module-wide list; other tests in this process add theirs.
    skipped = [[p for p in lst if p.startswith(root)]
               for lst in (tloaders.SKIPPED_RAW_FILES, jloaders.SKIPPED_RAW_FILES)]
    assert skipped[0] == skipped[1]
    if name == "ml_training_set":
        paths = [item[0] for item in t.items]
        assert any(p.endswith("raw_ok.arw") for p in paths)
        assert [os.path.basename(p) for p in skipped[0]] == ["raw_bad.arw"]


def test_sample_limits_match():
    assert (tloaders.SAMPLE_LIMIT, tloaders.SAMPLE_LIMIT_FOLDERS) == \
        (jloaders.SAMPLE_LIMIT, jloaders.SAMPLE_LIMIT_FOLDERS)
    assert set(tloaders.LOADERS) == set(jloaders.LOADERS)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_fish_dataset_splits_match(fixture_root, split):
    root, registry = fixture_root
    types = ("segmentation/composite",)
    t = tdata.FishDataset(types, 64, organs=ORGANS3, split=split, registry=registry)
    j = jdata.FishDataset(types, 64, organs=ORGANS3, split=split, registry=registry)
    assert len(t) == len(j) and t.cumsum == j.cumsum
    assert [(s.start, s.stop) for s in t.slices] == [(s.start, s.stop) for s in j.slices]
    for i in range(len(t)):
        assert _same(t[i], j[i]), i
    if len(t):
        for ignore in (None, [0]):
            assert _same(t.get_relative_ratios(ignore), j.get_relative_ratios(ignore))


# ---------------------------------------------------------------- pipeline

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((4, 4, 3), i, np.float32)
        return img, np.full((4, 4, 2), -i, np.float32), f"item{i}"


@pytest.mark.parametrize("n,batch,shuffle,pad_final", [
    (9, 4, True, False),    # a final batch of one: dropped
    (9, 4, True, True),     # padded to 4 instead
    (10, 4, False, True),
    (3, 8, True, True),     # smaller than one batch: tiled
    (8, 1, False, False),
])
def test_batcher_matches(n, batch, shuffle, pad_final):
    ds = _Items(n)
    t = tdata.Batcher(ds, batch, shuffle=shuffle, seed=5, pad_final=pad_final)
    j = jpipeline.Batcher(ds, batch, shuffle=shuffle, seed=5, pad_final=pad_final)
    assert len(t) == len(j)
    for _epoch in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            assert x["paths"] == y["paths"] and x["n_real"] == y["n_real"]
            assert _same(x["image"], y["image"]) and _same(x["label"], y["label"])


def test_cuda_prefetch_on_cpu_gives_tensors():
    batches = list(tdata.Batcher(_Items(5), 2, shuffle=False))
    got = list(tdata.cuda_prefetch(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert isinstance(g["image"], torch.Tensor) and g["image"].device.type == "cpu"
        assert np.array_equal(g["image"].numpy(), b["image"])
        assert np.array_equal(g["label"].numpy(), b["label"])
        assert g["paths"] == b["paths"] and g["n_real"] == b["n_real"]


# ------------------------------------------------------------------ native

def test_native_builds_its_own_library():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert "native" not in path.parent.parts[-3:]


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    img = (rng.rand(70, 90, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(d / "a.jpg"), img)
    cv2.imwrite(str(d / "a.png"), img)
    return d


def test_native_compute_ops_match():
    rng = np.random.RandomState(1)
    poly = np.array([[5, 3], [40, 10], [30, 45], [8, 30]], np.int32)
    a, b = np.zeros((50, 50), np.uint8), np.zeros((50, 50), np.uint8)
    assert np.array_equal(tnative.fill_polygon(a, poly), jnative.fill_polygon(b, poly))
    src = (rng.rand(63, 81) * 255).astype(np.uint8)
    assert np.array_equal(tnative.resize_area(src, (20, 27)), jnative.resize_area(src, (20, 27)))
    m = (rng.rand(30, 30) * 255).astype(np.uint8)
    ma, mb = m.copy(), m.copy()
    assert tnative.binarize_count(ma, 100) == jnative.binarize_count(mb, 100)
    assert np.array_equal(ma, mb)
    u8 = (rng.rand(4, 5, 3) * 255).astype(np.uint8)
    assert np.array_equal(tnative.u8_to_f32(u8), jnative.u8_to_f32(u8))


def test_native_image_ops_match(image_files):
    assert tnative.jpeg_available() == jnative.jpeg_available()
    assert tnative.png_available() == jnative.png_available()
    assert tnative.ring_extensions() == jnative.ring_extensions()
    jpg, png = str(image_files / "a.jpg"), str(image_files / "a.png")
    for fast in (0, 32):
        assert _same(tnative.jpeg_read_resize(jpg, (33, 41), fast),
                     jnative.jpeg_read_resize(jpg, (33, 41), fast))
    buf = Path(jpg).read_bytes()
    assert _same(tnative.jpeg_decode_resize(buf, (33, 41)), jnative.jpeg_decode_resize(buf, (33, 41)))
    assert _same(tnative.image_read_resize(png, (33, 41)), jnative.image_read_resize(png, (33, 41)))


def test_native_fallbacks_without_library(monkeypatch):
    """With no library and no cv2 the binding's numpy forms run."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "cv2", None)
    poly = np.array([[5, 3], [40, 10], [30, 45], [8, 30]], np.int32)
    got = tnative.fill_polygon(np.zeros((50, 50), np.uint8), poly)
    want = jnative.fill_polygon(np.zeros((50, 50), np.uint8), poly)
    assert (got != want).mean() < 0.03  # boundary pixels only
    src = np.kron(np.arange(12, dtype=np.uint8).reshape(3, 4) * 20, np.ones((4, 4), np.uint8))
    assert np.array_equal(tnative.resize_area(src, (3, 4)), src[::4, ::4])
    assert tnative.image_read_resize("missing.jpg", (8, 8)) is None


# ------------------------------------------------------------------- imops

@pytest.fixture
def no_cv2_no_pil(monkeypatch):
    monkeypatch.setattr(timops, "cv2", None)
    monkeypatch.setattr(timops, "_pil_image", lambda: None)


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3), (1, 1, 3), (64, 48, 1)])
def test_imwrite_png_without_cv2_or_pil(tmp_path, no_cv2_no_pil, shape):
    rng = np.random.RandomState(2)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    assert timops.imwrite_bgr(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back is not None
    assert np.array_equal(back, img.reshape(back.shape))
    assert timops.imread_bgr(path) is None
    assert timops.imdecode_bgr(np.frombuffer(Path(path).read_bytes(), np.uint8)) is None
    with pytest.raises(RuntimeError, match="PNG"):
        timops.imwrite_bgr(str(tmp_path / "x.jpg"), img)
    with pytest.raises(RuntimeError, match="cv2"):
        timops._MissingCv2().VideoCapture


def test_imops_fallback_draws_match_jax(monkeypatch):
    """Without cv2 both packages' numpy draws (and the port's native fill)
    paint the same fish."""
    from ecologysemanticsegmentation_tpu.data import imops as jimops

    monkeypatch.setattr(timops, "cv2", None)
    monkeypatch.setattr(jimops, "cv2", None)
    t = tdata.get_synthetic_data(img_shape=48, organs=ORGANS3, num_samples=4, seed=2)
    j = jdata.get_synthetic_data(img_shape=48, organs=ORGANS3, num_samples=4, seed=2)
    for i in range(2):
        assert _same(t[i], j[i])
