"""The port's overlay and edge utilities (``ecologysemanticsegmentation_torch/utils``:
``colors``, ``visualize``, ``edges``) held against the JAX package's, bitwise,
on seeded arrays: the colour table and its seeded shuffle, the composite
overlays in every mode (an ignored organ included), and the three edge
detectors, the inner-edge analysis and its PNGs.  These are numpy and cv2
code; nothing here needs JAX to compile.
"""

import os

import numpy as np
import pytest

from ecologysemanticsegmentation_tpu import utils as ju
from ecologysemanticsegmentation_tpu.utils import colors as jcolors
from ecologysemanticsegmentation_torch import utils as pu
from ecologysemanticsegmentation_torch.utils import colors as pcolors
from _torch_parallel_ranks import bound_threads

bound_threads()

ORGANS = ["whole_body", "ventral_side", "dorsal_side"]


def _image_and_masks(seed=0, h=40, w=48):
    rs = np.random.RandomState(seed)
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    masks = np.zeros((h, w, 3), np.float32)
    masks[5:35, 4:44, 0] = 1.0
    masks[20:35, 10:40, 1] = 1.0
    masks[5:18, 8:30, 2] = 1.0
    masks += (rs.rand(h, w, 3) < 0.05)
    return img, (np.clip(masks, 0, 1) * 255).astype(np.uint8)


def test_colors_equal_jax():
    assert pcolors.COLOR_NAMES == jcolors.COLOR_NAMES and len(pcolors.COLOR_NAMES) == 551
    assert pu.COLORS == ju.COLORS


def _assert_same_overlays(got, want):
    assert [list(d) for d in got] == [list(d) for d in want]
    for g, w in zip(got, want):
        (k, a), = g.items()
        assert a.dtype == np.uint8 and np.array_equal(a, w[k]), k


@pytest.mark.parametrize("kwargs", [
    {}, {"return_image": False}, {"return_image": False, "show_composite_parts": False},
    {"hide_whole_body_segment": True, "min_positivity_ratio": 0.2, "return_image": False},
], ids=["return_image", "parts", "all_parts", "hide_whole_body"])
def test_display_composite_annotations_equals_jax(kwargs, capsys):
    img, masks = _image_and_masks()
    got = pu.display_composite_annotations(img, masks, ORGANS, **kwargs)
    got_out = capsys.readouterr().out
    want = ju.display_composite_annotations(img, masks, ORGANS, **kwargs)
    assert got_out == capsys.readouterr().out
    _assert_same_overlays(got, want)
    assert got


def test_display_composite_annotations_ignored_organ(capsys):
    img, masks = _image_and_masks(seed=1)
    masks = masks.astype(np.int16)
    masks[0, 0, 1] = -1
    got = pu.display_composite_annotations(img, masks, ORGANS, verbose=False)
    assert "ventral_side will not be learnt" in capsys.readouterr().out
    _assert_same_overlays(got, ju.display_composite_annotations(img, masks, ORGANS,
                                                                verbose=False))
    assert [list(d)[0] for d in got] == ["whole_body", "dorsal_side", "all_parts"]


@pytest.mark.parametrize("method", ["sobel", "canny", "DoG"])
def test_detect_edges_equals_jax(method):
    img, _ = _image_and_masks(seed=2)
    got = pu.detect_edges(img, method=method)
    want = ju.detect_edges(img, method=method)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    gray = img[..., 0].copy()
    assert np.array_equal(pu.detect_edges(gray, method=method), ju.detect_edges(gray, method))


def test_detect_inner_edges_equals_jax(tmp_path):
    rs = np.random.RandomState(3)
    pred = rs.rand(2, 32, 40, 3).astype(np.float32)
    gt = (rs.rand(2, 32, 40, 3) > 0.5).astype(np.float32)
    img = rs.rand(2, 32, 40, 3).astype(np.float32)
    got = pu.detect_inner_edges(pred, gt, img=img, out_dir=str(tmp_path / "port"))
    want = ju.detect_inner_edges(pred, gt, img=img, out_dir=str(tmp_path / "jax"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["pair"] == w["pair"] and g["batch"] == w["batch"]
        for k in g:
            if k not in ("pair", "batch"):
                assert np.array_equal(g[k], w[k]), k
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 12
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    edges = pu.detect_edges((img[0] * 255).astype(np.uint8))
    mask = (got[0]["edge_inside_gt_subset"] * 255).astype(np.uint8)
    assert np.array_equal(pu.detect_edge_pred_overlap(edges, mask),
                          ju.detect_edge_pred_overlap(edges, mask))
    no_img = pu.detect_inner_edges(pred, gt)
    assert "edge_overlap_inner" not in no_img[0]
