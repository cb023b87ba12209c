"""Configuration layer of the port: env flags and the dataset registry
(counterpart of ``ecologysemanticsegmentation_tpu/config.py``, kept as the
port's own copy).

* The registry is the first ``*.json`` next to this package
  (``fish_metadata.json``, shipped as package data).
* Env flags ``SAMPLE``, ``IMGSIZE`` (or ``IMG_SIZE``, the README's
  spelling; ``IMGSIZE`` wins), ``MAXCHANNELS``, ``ORGANS``, ``EXPTNAME``,
  ``BBOX_DIR``.  ``SAMPLE=0``, ``SAMPLE=false`` and ``SAMPLE=`` are falsy.
* Split ratios train/val/test = 0.85/0.05/0.10.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


def get_env_variable(name: str, default_value):
    """``os.environ[name]``, or ``default_value`` when it is unset."""
    try:
        return os.environ[name]
    except KeyError:
        return default_value


def _env_bool(name: str, default: bool = False) -> bool:
    raw = get_env_variable(name, default)
    if isinstance(raw, bool):
        return raw
    return str(raw).strip().lower() not in ("", "0", "false", "no", "none")


def load_registry(path: str | None = None) -> dict | None:
    """The dataset registry JSON; with no ``path``, the first ``*.json`` next
    to this package.  None when it cannot be read."""
    if path is None:
        pkg_dir = os.path.dirname(__file__)
        candidates = sorted(x for x in os.listdir(pkg_dir) if x.endswith(".json"))
        if not candidates:
            return None
        path = os.path.join(pkg_dir, candidates[0])
    try:
        with open(path, "r") as f:
            return json.load(f)
    except Exception:  # noqa: BLE001 - the registry is optional
        return None


#: Dataset registry (``fish_metadata.json``), loaded at import; the data
#: scan itself waits for :func:`..data.get_split_datasets`.
datasets_metadata: dict | None = load_registry()

DATASET_SPLITS = {"train": 0.85, "val": 0.05, "test": 0.1}

#: Composite-part grouping: whole_body first, then ventral/dorsal/head
#: groups, then independent parts.
CPARTS = [
    ["whole_body"],
    ["ventral_side", "anal_fin", "pectoral_fin"],
    ["dorsal_side", "dorsal_fin"],
    ["head", "eye", "operculum"],
    ["humeral_blotch", "pelvic_fin", "caudal_fin"],
]

DATASET_TYPES = [
    "segmentation",
    "polygons",
    "segmentation/composite",
    "polygons/composite",
]

#: Minimum fraction of positive pixels for an organ mask to count as present.
MIN_SEGMENT_POSITIVITY_RATIO = 0.0075


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Typed snapshot of the environment-variable configuration."""

    sample: bool = False
    img_size: int = 256
    max_channels: int = 256
    organs: tuple[str, ...] = ("whole_body",)
    expt_name: str = "deeplabv3p"
    # Folder (relative to the registry's folder_path) of repaired ground
    # truth, appended to the ml_training_set scan.
    bbox_dir: str | None = None

    @staticmethod
    def from_env() -> "EnvConfig":
        img_size = get_env_variable("IMGSIZE", None)
        if img_size is None:
            img_size = get_env_variable("IMG_SIZE", 256)
        # Empty entries are kept: ``ORGANS=whole_body,,`` is a 3-channel
        # model scoring only channel 0 (empty names match no masks, so those
        # channels come back all -1 and are not learnt).
        organs = tuple(str(get_env_variable("ORGANS", "whole_body")).split(","))
        bbox_dir = get_env_variable("BBOX_DIR", None)
        return EnvConfig(
            sample=_env_bool("SAMPLE", False),
            img_size=int(img_size),
            max_channels=int(get_env_variable("MAXCHANNELS", 256)),
            organs=organs,
            expt_name=str(get_env_variable("EXPTNAME", "deeplabv3p")),
            bbox_dir=str(bbox_dir) if bbox_dir else None,
        )

    @property
    def num_classes(self) -> int:
        return len(self.organs)

    def checkpoint_dir(self, models_root: str = "models") -> str:
        """``models/<EXPTNAME>/channels<MAXCHANNELS>/img<IMGSIZE>/``."""
        return os.path.join(
            models_root,
            self.expt_name,
            "channels%d" % self.max_channels,
            "img%d" % self.img_size,
        )


def describe(cfg: EnvConfig) -> str:
    return (
        f"organs={list(cfg.organs)} img_size={cfg.img_size} "
        f"max_channels={cfg.max_channels} sample={cfg.sample} expt={cfg.expt_name}"
    )


def asdict(cfg: EnvConfig) -> dict[str, Any]:
    return dataclasses.asdict(cfg)
