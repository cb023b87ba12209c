"""FishDataset of the port: multi-source concatenation and the 85/5/10
split bookkeeping (counterpart of
``ecologysemanticsegmentation_tpu/data/fish_dataset.py``).

* Filters the registry by dataset type, calls ``get_<name>_data`` per
  entry, and skips a failing loader with its traceback.
* Slices each source 85/5/10 into contiguous train/val/test ranges, with
  cumulative lengths across sources.
* ``__getitem__`` binarizes positive mask values and passes the -1 ignore
  labels through, returning ``(image, mask, path)`` scaled to [0, 1].
"""

from __future__ import annotations

import bisect
import traceback
from typing import Sequence

import numpy as np

from ..config import DATASET_SPLITS, DATASET_TYPES, MIN_SEGMENT_POSITIVITY_RATIO, datasets_metadata
from .loaders import LOADERS, IndexedDataset


class _Slice:
    """A contiguous view over an IndexedDataset (torch Subset equivalent)."""

    def __init__(self, dataset: IndexedDataset, start: int, stop: int):
        self.dataset = dataset
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, i: int):
        return self.dataset[self.start + i]


class FishDataset:
    """Concatenated multi-source dataset with split bookkeeping.

    ``split`` chooses which 85/5/10 slice this view exposes.  The reference
    exposes train via ``FishDataset`` and val/test via ``FishSubsetDataset``;
    here one class covers all three (see :func:`get_split_datasets`).
    """

    def __init__(
        self,
        dataset_type: Sequence[str] = ("segmentation/composite",),
        img_shape: int = 256,
        min_segment_positivity_ratio: float = MIN_SEGMENT_POSITIVITY_RATIO,
        organs: Sequence[str] = ("whole_body",),
        sample_dataset: bool = False,
        split: str = "train",
        registry: dict | None = None,
        extra_loaders: dict | None = None,
        bbox_dir: str | None = None,
    ):
        assert all(t in DATASET_TYPES + ["synthetic"] for t in dataset_type), dataset_type
        assert split in ("train", "val", "test")
        registry = registry if registry is not None else datasets_metadata
        self.organs = tuple(organs)
        self.img_shape = img_shape
        self.split = split
        self.min_segment_positivity_ratio = min_segment_positivity_ratio

        loaders = dict(LOADERS)
        if extra_loaders:
            loaders.update(extra_loaders)

        folder_path = registry["folder_path"]
        entries = [d for d in registry["datasets"] if d["type"] in dataset_type]

        self.slices: list[_Slice] = []
        self.cumsum: list[int] = []
        self.sources: list[IndexedDataset] = []
        for entry in entries:
            loader = loaders.get(entry["name"])
            if loader is None:
                continue
            try:
                ds = loader(
                    entry["type"],
                    entry["folder"],
                    folder_path,
                    img_shape,
                    min_segment_positivity_ratio,
                    organs=self.organs,
                    sample_dataset=sample_dataset,
                    # GT-repair consumption: a registry entry's "bbox_dir"
                    # field (or the BBOX_DIR env via get_split_datasets)
                    # appends the rebuild_bbox_dataset output folder
                    # (reference fish_segmentation.py:148-149 consuming
                    # bbox_to_segmentation_gt/).
                    bbox_dir=entry.get("bbox_dir", bbox_dir),
                    augment_flag=split == "train",
                )
            except Exception:
                traceback.print_exc()
                print(f"Write generator function for dataset: get_{entry['name']}_data ;")
                continue
            n = len(ds)
            if n == 0:
                continue
            n_train = int(n * DATASET_SPLITS["train"])
            n_val = int(n * DATASET_SPLITS["val"])
            bounds = {
                "train": (0, n_train),
                "val": (n_train, n_train + n_val),
                "test": (n_train + n_val, n),
            }[split]
            sl = _Slice(ds, *bounds)
            if len(sl) == 0:
                continue
            self.sources.append(ds)
            self.slices.append(sl)
            prev = self.cumsum[-1] if self.cumsum else 0
            self.cumsum.append(prev + len(sl))

    def __len__(self) -> int:
        return self.cumsum[-1] if self.cumsum else 0

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        ds_id = bisect.bisect_right(self.cumsum, idx)
        local = idx - (self.cumsum[ds_id - 1] if ds_id else 0)
        image, segment, path = self.slices[ds_id][local]
        segment = np.where(segment > 0, 1.0, segment).astype(np.float32)
        if image.max() > 1:
            image = image / 255.0
        return image, segment, path

    def set_augment_flag(self, flag: bool) -> None:
        for ds in self.sources:
            ds.set_augment_flag(flag)

    def get_relative_ratios(self, ignore_superset: Sequence[int] | None = None):
        """Per-organ positive-pixel ratios (reference
        ``fish_dataset.py:117-141``) — the measured source of the hardcoded
        loss weights.  Returns ratios normalized so the max organ is 1; with
        ``ignore_superset`` also returns the union-form ratios."""
        n_organs = len(self.organs)
        ratios = np.zeros(n_organs)
        ratios_union = np.zeros(n_organs)
        for i in range(len(self)):
            _, segment, _ = self[i]
            pos = np.clip(segment, 0, 1)
            ratios += pos.sum(axis=(0, 1))
            if ignore_superset is not None:
                for oi in range(n_organs):
                    if oi in ignore_superset or oi == n_organs - 1:
                        union = pos[..., oi]
                    else:
                        union = np.clip(pos[..., oi:].sum(axis=-1), 0, 1)
                    ratios_union[oi] += union.sum()
        denom = max(len(self), 1)
        ratios = ratios / denom
        ratios = ratios / max(ratios.max(), 1e-9)
        if ignore_superset is not None:
            ratios_union = ratios_union / denom
            ratios_union = ratios_union / max(ratios_union.max(), 1e-9)
            return ratios, ratios_union
        return ratios


def _main():  # pragma: no cover - inspection entry
    """Dataset inspection (``python -m
    ecologysemanticsegmentation_torch.data.fish_dataset``): builds the splits,
    prints per-organ relative ratios, and writes union-transformed sample
    visualizations to ``--out_dir``."""
    import argparse
    import os

    from . import imops
    from ..config import EnvConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--visualize", default="alvaradolab")
    ap.add_argument("--out_dir", default="dataset_inspect")
    ap.add_argument("--limit", type=int, default=8)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args()

    cfg = EnvConfig.from_env()
    from . import get_split_datasets

    train, val, test = get_split_datasets(cfg, synthetic=args.synthetic)
    print("train dataset: %d images" % len(train))
    print("val dataset: %d images" % len(val))
    print("relative ratios:", train.get_relative_ratios(ignore_superset=[0]))

    import torch

    from ..losses import return_union_sets_descending_order

    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(args.limit, len(train))):
        img, seg, fname = train[i]
        seg_u = return_union_sets_descending_order(torch.from_numpy(seg)[None])[0].numpy()
        imops.imwrite_bgr(
            os.path.join(args.out_dir, f"{i}_img.png"),
            (img[..., ::-1] * 255).astype(np.uint8),
        )
        for c in range(seg_u.shape[-1]):
            imops.imwrite_bgr(
                os.path.join(args.out_dir, f"{i}_union_organ{c}.png"),
                (np.clip(seg_u[..., c], 0, 1) * 255).astype(np.uint8),
            )
        print(fname)
    print("test dataset: %d images" % len(test))


if __name__ == "__main__":  # pragma: no cover
    _main()
