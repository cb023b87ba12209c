"""Data side of the port: the host data layer (registry loaders, the
synthetic fixture, the split bookkeeping, the batcher and the CUDA
prefetch) and device augmentation (``augment``).

As in the JAX package, the splits are built on request by
:func:`get_split_datasets`, not scanned at import.
"""

from __future__ import annotations

from ..config import EnvConfig
from .augment import augment_batch, augment_batch_per_sample, augment_sample
from .fish_dataset import FishDataset
from .loaders import (
    LOADERS,
    IndexedDataset,
    get_alvaradolab_data,
    get_deepfish_segclsloc_data,
    get_ml_training_set_data,
    get_suim_data,
)
from .pipeline import Batcher, cuda_prefetch
from .synthetic import get_synthetic_data, materialize_to_disk


def get_split_datasets(
    cfg: EnvConfig | None = None,
    dataset_type=("segmentation/composite",),
    registry: dict | None = None,
    synthetic: bool = False,
):
    """(train, val, test) :class:`FishDataset` views of the registry's
    datasets, or with ``synthetic=True`` of the in-memory fixture (no data
    directory needed)."""
    cfg = cfg or EnvConfig.from_env()
    extra = None
    if synthetic:
        extra = {"synthetic": get_synthetic_data}
        registry = {
            "folder_path": ".",
            "datasets": [{"folder": "", "name": "synthetic", "type": "synthetic"}],
        }
        dataset_type = ("synthetic",)
    splits = []
    for split in ("train", "val", "test"):
        ds = FishDataset(
            dataset_type=dataset_type,
            img_shape=cfg.img_size,
            organs=cfg.organs,
            sample_dataset=cfg.sample,
            split=split,
            registry=registry,
            extra_loaders=extra,
            bbox_dir=getattr(cfg, "bbox_dir", None),
        )
        if split != "train":
            ds.set_augment_flag(False)
        print(f"{split} dataset: {len(ds)} images")
        splits.append(ds)
    return tuple(splits)


__all__ = [
    "FishDataset",
    "IndexedDataset",
    "Batcher",
    "cuda_prefetch",
    "augment_batch",
    "augment_batch_per_sample",
    "augment_sample",
    "get_split_datasets",
    "get_synthetic_data",
    "materialize_to_disk",
    "get_alvaradolab_data",
    "get_ml_training_set_data",
    "get_suim_data",
    "get_deepfish_segclsloc_data",
    "LOADERS",
]
