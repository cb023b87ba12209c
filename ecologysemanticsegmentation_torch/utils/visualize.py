"""Composite-label overlays (port of the JAX package's
``utils/visualize.py``): each organ mask alpha-blended (0.75) in its own
colour over the image, in the form the eval CLIs write as PNGs.

Inputs are HWC uint8 (image) and HWC masks, values 0-255 (or -1 for an
ignored label); numpy, with cv2 through :mod:`..data.imops` where present.
"""

from __future__ import annotations

import numpy as np

from ..config import CPARTS
from .colors import COLORS


def display_composite_annotations(
    image: np.ndarray,
    labels_map: np.ndarray,
    composite_labels,
    verbose: bool = True,
    min_positivity_ratio: float = 0.009,
    hide_whole_body_segment: bool = False,
    show_composite_parts: bool = True,
    return_image: bool = True,
    show: bool = False,
):
    """Overlay organ masks; returns a list of ``{name: image}`` dicts, one
    per organ drawn (``return_image``) and one of all of them.  A mask with
    a -1 pixel is reported ("will not be learnt") and not drawn.  Without
    ``return_image`` and with ``show_composite_parts``, one canvas per
    ``CPARTS`` group, of its organs above ``min_positivity_ratio``.
    ``show=True`` also opens cv2 windows (the reference's interactive
    default)."""
    from ..data import imops

    alpha = 0.75
    image = np.ascontiguousarray(image).astype(np.uint8)
    labels_map = np.ascontiguousarray(labels_map).astype(np.int16)

    if hide_whole_body_segment and verbose:
        largest = int(np.argmax(labels_map.clip(0).sum(axis=(0, 1))))
        if composite_labels[largest] == "whole_body":
            print(f"\nIgnoring largest segment {composite_labels[largest]}!")
        else:
            print("\nCannot find whole body segment!")

    outer_loop_times = (
        len(CPARTS)
        if not return_image
        and show_composite_parts
        and any(x in composite_labels for grp in CPARTS for x in grp)
        else 1
    )

    return_images = []
    for outer_idx in range(outer_loop_times):
        canvas = image.copy()
        for seg_id in range(labels_map.shape[-1]):
            chan = labels_map[..., seg_id]
            if (chan < 0).any():
                print(
                    "Label %s will not be learnt by gradient descent algorithm!"
                    % composite_labels[seg_id]
                )
                continue
            if outer_loop_times > 1:
                if composite_labels[seg_id] not in CPARTS[outer_idx]:
                    continue
                ratio = chan.sum() / (255.0 * np.prod(chan.shape))
                if verbose:
                    print(f"{composite_labels[seg_id]} mask ratio wrt image: {ratio:f}")
                if ratio <= min_positivity_ratio:
                    continue
            color = np.array(COLORS[seg_id % len(COLORS)], np.uint8)
            seg_img = (chan.clip(0, 255).astype(np.uint8)[..., None] // 255) * color
            canvas = imops.add_weighted(canvas, 1 - alpha, seg_img, alpha, 1.0)
            if show:
                import cv2

                cv2.imshow(f"fish_{composite_labels[seg_id]}", chan.clip(0, 255).astype(np.uint8))
            if return_image:
                return_images.append({composite_labels[seg_id]: canvas.copy()})

        ann_type = "all_parts" if outer_loop_times == 1 else ", ".join(CPARTS[outer_idx])
        if show:
            import cv2

            cv2.imshow(f"fish_{ann_type}", canvas)
            cv2.waitKey()
        return_images.append({ann_type: canvas})
    return return_images
