"""Edge analysis of predictions (port of the JAX package's
``utils/edges.py``): ``detect_edges``, ``detect_inner_edges`` and
``detect_edge_pred_overlap`` as headless functions that return arrays; an
``out_dir`` writes PNGs.  cv2 through :data:`..data.imops.cv2_or_stub`,
which raises when cv2 is absent.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.imops import cv2_or_stub as cv2


def detect_edges(img: np.ndarray, method: str = "DoG") -> np.ndarray:
    """Edge map of an HWC uint8 image by sobel, canny or a difference of
    Gaussians (DoG, isolated pixels pruned)."""
    assert method in ("sobel", "canny", "DoG")
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
    blur = cv2.GaussianBlur(gray, (3, 3), sigmaX=0, sigmaY=0)

    if method == "sobel":
        return cv2.Sobel(
            src=blur, ddepth=cv2.CV_8U, dx=1, dy=1, ksize=5,
            borderType=cv2.BORDER_ISOLATED, scale=2, delta=-1,
        )
    if method == "DoG":
        blur1 = cv2.GaussianBlur(gray, (5, 5), 2.5)
        blur2 = cv2.GaussianBlur(gray, (5, 5), 2.15)
        edges = cv2.subtract(blur2, blur1)
        # prune pixels with no 8-connected neighbour
        nonzero = (edges > 0).astype(np.uint8)
        neighbor_count = cv2.filter2D(nonzero, -1, np.ones((3, 3), np.uint8)) - nonzero
        edges[(nonzero == 1) & (neighbor_count == 0)] = 0
        return edges
    return cv2.Canny(image=blur, threshold1=30, threshold2=150, apertureSize=3)


def detect_edge_pred_overlap(edges: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Elementwise overlap of an edge map with prediction-error pixels."""
    return edges * preds


def detect_inner_edges(
    pred: np.ndarray,
    gt: np.ndarray,
    img: np.ndarray | None = None,
    edge_detection_method: str = "DoG",
    out_dir: str | None = None,
) -> list[dict]:
    """Where the predicted pixels of an organ outside its ground truth fall
    against the next nested organ set: inside it or outside.

    ``pred``/``gt``: (B, H, W, C) in [0, 1], already union-reverse
    transformed.  Returns one dict of maps per (image, adjacent organ
    pair); with ``img`` (B, H, W, 3) in [0, 1] also their overlap with the
    image's edges; with ``out_dir``, writes the three maps as PNGs."""
    results = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for b in range(pred.shape[0]):
        edges = None
        if img is not None:
            u8 = (np.asarray(img[b]) * 255).astype(np.uint8)
            edges = detect_edges(u8, method=edge_detection_method)
        for idx in range(pred.shape[-1] - 1):
            set1, set1_gt = pred[b, ..., idx], gt[b, ..., idx]
            set2_gt = gt[b, ..., idx + 1]
            edge_preds = set1 * (1 - set1_gt)
            inner = edge_preds * set2_gt
            outer = edge_preds * (1 - set2_gt)
            entry = {
                "batch": b,
                "pair": (idx, idx + 1),
                "pred_sub_gt_edges": edge_preds,
                "edge_inside_gt_subset": inner,
                "edge_outside_gt_subset": outer,
            }
            if edges is not None:
                entry["edge_overlap_inner"] = detect_edge_pred_overlap(
                    edges, (inner * 255).astype(np.uint8))
                entry["edge_overlap_outer"] = detect_edge_pred_overlap(
                    edges, (outer * 255).astype(np.uint8))
            results.append(entry)
            if out_dir:
                for k in ("pred_sub_gt_edges", "edge_inside_gt_subset", "edge_outside_gt_subset"):
                    cv2.imwrite(
                        os.path.join(out_dir, f"b{b}_pair{idx}_{k}.png"),
                        (np.asarray(entry[k]) * 255).astype(np.uint8),
                    )
    return results
