"""Synthetic fish fixture dataset of the port: procedural images with
nested organ masks (counterpart of
``ecologysemanticsegmentation_tpu/data/synthetic.py``; for the same seed the
arrays are bitwise the JAX package's under the same :mod:`.imops` backend).

Each sample is a drawn fish on a noisy background with nested organs,
whole_body ⊇ ventral_side ⊇ dorsal_side, the subset the composite losses
assume.  ``--dataset synthetic`` trains on it with no data directory.
``materialize_to_disk`` writes the same samples in all four on-disk loader
formats, so the scanners get real end-to-end coverage.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import imops
from .loaders import IndexedDataset


def _draw_fish(rng: np.random.RandomState, size: int, n_organs: int):
    """Return (image u8 HWC RGB, mask f32 HW x organs in {0,1})."""
    img = (rng.rand(size, size, 3) * 60 + 40).astype(np.uint8)
    # water-ish gradient
    grad = np.linspace(0, 60, size, dtype=np.uint8)[:, None, None]
    img = np.clip(img.astype(np.int32) + grad, 0, 255).astype(np.uint8)

    cx = rng.randint(size // 3, 2 * size // 3)
    cy = rng.randint(size // 3, 2 * size // 3)
    ax = rng.randint(size // 6, size // 3)
    ay = max(ax // 2, 4)
    angle = rng.randint(0, 180)
    color = tuple(int(c) for c in rng.randint(90, 255, 3))

    mask = np.zeros((size, size, n_organs), np.float32)
    body = np.zeros((size, size), np.uint8)
    imops.ellipse_filled(body, (cx, cy), (ax, ay), angle, 255)
    # tail fin triangle
    theta = np.deg2rad(angle)
    tx = int(cx - 1.2 * ax * np.cos(theta))
    ty = int(cy - 1.2 * ax * np.sin(theta))
    pts = np.array([[tx, ty], [cx - int(0.7 * ax * np.cos(theta)) - 6, cy - 8],
                    [cx - int(0.7 * ax * np.cos(theta)) + 6, cy + 8]], np.int32)
    imops.fill_poly(body, pts, 255)

    imops.ellipse_filled(img, (cx, cy), (ax, ay), angle, color)
    imops.fill_poly(img, pts, color)
    eye = (int(cx + 0.6 * ax * np.cos(theta)), int(cy + 0.6 * ax * np.sin(theta)))
    imops.circle_filled(img, eye, max(2, ay // 4), (0, 0, 0))

    mask[..., 0] = body / 255.0
    # nested sub-organs: successively smaller co-centered ellipses
    for oi in range(1, n_organs):
        sub = np.zeros((size, size), np.uint8)
        f = 1.0 - 0.3 * oi
        imops.ellipse_filled(sub, (cx, cy),
                             (max(int(ax * f), 2), max(int(ay * f), 2)),
                             angle, 255)
        mask[..., oi] = (sub / 255.0) * mask[..., oi - 1]  # enforce nesting
    return img, mask


def _shoelace_area(pts: "np.ndarray") -> float:
    """Polygon area (shoelace) — cv2.contourArea equivalent for int contours."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def get_synthetic_data(
    dtype: str = "synthetic",
    path: str = "",
    folder_path: str = "",
    img_shape: int = 256,
    min_segment_positivity_ratio: float = 0.0075,
    organs=("whole_body",),
    sample_dataset: bool = False,
    bbox_dir=None,
    augment_flag: bool = True,
    num_samples: int = 128,
    seed: int = 0,
) -> IndexedDataset:
    """In-memory synthetic dataset in the standard loader interface."""
    del dtype, path, folder_path, min_segment_positivity_ratio, bbox_dir
    n = 32 if sample_dataset else num_samples
    organs = tuple(organs)
    items = list(range(n))
    # Decoded samples are cached: drawing one costs milliseconds and would
    # otherwise be redone every epoch (augmentation runs on the device, so
    # the cached host arrays stay correct).
    cache: dict[int, tuple] = {}

    def decode(i: int):
        if i not in cache:
            rng = np.random.RandomState(seed * 100003 + i)
            img, mask = _draw_fish(rng, img_shape, len(organs))
            cache[i] = (img.astype(np.float32) / 255.0, mask, f"synthetic/{i}.jpg")
        return cache[i]

    return IndexedDataset("synthetic", items, decode, organs, augment_flag)


def materialize_to_disk(root: str, num_samples: int = 8, size: int = 128, seed: int = 7):
    """Write synthetic samples in all four on-disk loader formats.

    Layout mirrors the registry folders so FishDataset can scan ``root`` as a
    ``folder_path``.  Returns the registry dict to use.
    """
    organs = ("whole_body", "ventral_side", "dorsal_side")

    coco_dir = os.path.join(root, "coco")
    mlts_dir = os.path.join(root, "mlts", "batch1")
    suim_img = os.path.join(root, "suim", "images")
    suim_msk = os.path.join(root, "suim", "masks")
    df_dir = os.path.join(root, "deepfish")
    df_json = os.path.join(df_dir, "json")
    for d in [coco_dir, suim_img, suim_msk, df_json,
              os.path.join(mlts_dir, "original image")] + [
        os.path.join(mlts_dir, o.replace("_", " ")) for o in organs
    ]:
        os.makedirs(d, exist_ok=True)

    for i in range(num_samples):
        rng = np.random.RandomState(seed * 1009 + i)
        img, mask = _draw_fish(rng, size, len(organs))
        bgr = np.ascontiguousarray(img[..., ::-1])

        # --- COCO-txt format (polygon per organ).
        imops.imwrite_bgr(os.path.join(coco_dir, f"s{i}.jpg"), bgr)
        lines = []
        polys = []
        for oi, organ in enumerate(organs):
            m8 = (mask[..., oi] * 255).astype(np.uint8)
            cnt = imops.largest_contour(m8)
            if cnt is None:
                continue
            area = _shoelace_area(cnt)
            if area < 4:
                continue
            flat = " ".join(str(int(v)) for v in cnt.reshape(-1))
            polys.append((organ, area, flat))
        lines.append(str(len(polys)))
        lines.append("")
        lines.append(f"{size} {size}")
        lines.append("")
        for organ, area, flat in polys:
            lines += [organ, str(area), flat, ""]
        with open(os.path.join(coco_dir, f"s{i}.txt"), "w") as f:
            f.write("\n".join(lines))

        # --- ml_training_set format (organ folders, inverted grayscale masks).
        imops.imwrite_bgr(os.path.join(mlts_dir, "original image", f"s{i}.png"), bgr)
        for oi, organ in enumerate(organs):
            m8 = (mask[..., oi] * 255).astype(np.uint8)
            inverted = imops.invert_u8(m8)  # loader re-inverts
            imops.imwrite_bgr(
                os.path.join(mlts_dir, organ.replace("_", " "), f"s{i}.png"), inverted
            )

        # --- SUIM format (yellow = fish in the mask image).
        imops.imwrite_bgr(os.path.join(suim_img, f"s{i}.jpg"), bgr)
        m8 = (mask[..., 0] * 255).astype(np.uint8)
        suim = np.zeros((size, size, 3), np.uint8)
        suim[m8 > 0] = (0, 255, 255)  # BGR yellow -> HSV hue 30ish
        imops.imwrite_bgr(os.path.join(suim_msk, f"s{i}.bmp"), suim)

        # --- DeepFish format (.jpg + json/<stem>__labels.json polygons).
        imops.imwrite_bgr(os.path.join(df_dir, f"s{i}.jpg"), bgr)
        cnt = imops.largest_contour((mask[..., 0] * 255).astype(np.uint8))
        regions = (
            [[{"x": int(x), "y": int(y)} for x, y in cnt]] 
            if cnt is not None and len(cnt) > 5 else []
        )
        with open(os.path.join(df_json, f"s{i}__labels.json"), "w") as f:
            json.dump({"labels": [{"regions": regions}]}, f)

    return {
        "folder_path": root,
        "datasets": [
            {"folder": "coco", "name": "alvaradolab", "type": "segmentation/composite"},
            {"folder": "mlts", "name": "ml_training_set", "type": "segmentation/composite"},
            {"folder": "suim", "name": "suim", "type": "segmentation"},
            {"folder": "deepfish", "name": "deepfish_segclsloc", "type": "segmentation"},
        ],
    }
