"""Host-side dataset loaders of the port: index-building scanners and
per-item decoders (counterpart of
``ecologysemanticsegmentation_tpu/data/loaders.py``, the same four formats,
items, skips and arrays).

All dirtiness (missing files, unreadable images, zero-area polygons) is
handled when the index is built; ``__getitem__`` returns dense float32 HWC
arrays only.

Formats:

* ``alvaradolab``: COCO-Dataset-Generator ``.txt`` polygons next to
  ``.jpg`` images (line 0 the object count, line 2 "H W", then 4-line
  records ``organ / area / flat-xy-polygon / _`` from line 4).
* ``ml_training_set``: folder-per-organ grayscale masks (resize, grayscale,
  bitwise_not, binarize, area-threshold zero-fill).
* ``suim``: ``images/`` paired with mask dirs by stem; fish by the HSV
  yellow range (20,100,100)-(30,255,255).
* ``deepfish_segclsloc``: ``*.jpg`` + ``json/<stem>__labels.json`` polygon
  regions, polygons of 5 points or fewer dropped.

Masks are {0, 1} float32 with ``-1`` for missing or unavailable organs.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import imops, native

SAMPLE_LIMIT = 60  # reference SAMPLE truncation (fish_coco_annotator.py:32-33)
SAMPLE_LIMIT_FOLDERS = 20  # ml_training_set variant (fish_segmentation.py:159-160)


@dataclass
class IndexedDataset:
    """A scanned dataset: an index of items plus a decode function.

    ``decode(i) -> (image_f32_HWC_01, mask_f32_HWC, path)``; masks are
    ``(H, W, num_organs)`` in {0, 1, -1}.
    """

    name: str
    items: list
    decode_fn: Callable[[int], tuple[np.ndarray, np.ndarray, str]]
    organs: tuple[str, ...] = ("whole_body",)
    augment_flag: bool = True

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.decode_fn(idx)

    def set_augment_flag(self, flag: bool) -> None:
        """Reference API parity (``fish_coco_annotator.py:94-95``); augmentation runs
        on the device, but the flag still gates it per split."""
        self.augment_flag = flag


SKIPPED_RAW_FILES: list[str] = []


def _arw_preview_decode(path: str) -> np.ndarray | None:
    """Decode a Sony ``.arw`` RAW by extracting its embedded JPEG preview.

    ARW is a TIFF container; every camera-written file carries at least one
    full-scene JPEG preview addressed by the classic TIFF tag pair
    JPEGInterchangeFormat (0x0201) / JPEGInterchangeFormatLength (0x0202) in
    an IFD (IFD0, a chained IFD, or a SubIFD via tag 0x014A).  Walking those
    IFDs and decoding the LARGEST preview gives a demosaiced, white-balanced
    RGB image without a RAW-processing dependency — the same pixels rawpy's
    ``postprocess`` approximates (reference ``fish_segmentation.py:17-24``
    feeds the decode straight into a resize, so preview resolution is ample).
    Returns BGR uint8 or None when the file has no parseable preview.
    """
    try:
        with open(path, "rb") as f:
            buf = f.read()
        if len(buf) < 16 or buf[:2] not in (b"II", b"MM"):
            return None
        import struct

        endian = "<" if buf[:2] == b"II" else ">"
        if struct.unpack(endian + "H", buf[2:4])[0] != 42:
            return None

        best: tuple[int, int] | None = None  # (offset, length)
        seen: set[int] = set()

        def walk(ifd_off: int, depth: int = 0) -> None:
            nonlocal best
            if depth > 8 or ifd_off in seen or ifd_off <= 0:
                return
            seen.add(ifd_off)
            if ifd_off + 2 > len(buf):
                return
            (n,) = struct.unpack_from(endian + "H", buf, ifd_off)
            jpeg_off = jpeg_len = None
            subifds: list[int] = []
            for i in range(n):
                e = ifd_off + 2 + 12 * i
                if e + 12 > len(buf):
                    return
                tag, typ, cnt = struct.unpack_from(endian + "HHI", buf, e)
                (val,) = struct.unpack_from(endian + "I", buf, e + 8)
                if tag == 0x0201:
                    jpeg_off = val
                elif tag == 0x0202:
                    jpeg_len = val
                elif tag == 0x014A:  # SubIFDs: LONG offsets, inline or pointed
                    if cnt == 1:
                        subifds.append(val)
                    elif cnt > 1:  # cnt==0 carries no offsets
                        # multi-entry values don't fit the 4-byte field, so
                        # ``val`` is a pointer to the offset array
                        for j in range(min(cnt, 8)):
                            off = val + 4 * j
                            if off + 4 <= len(buf):
                                subifds.append(
                                    struct.unpack_from(endian + "I", buf, off)[0]
                                )
            if (
                jpeg_off is not None
                and jpeg_len is not None
                and jpeg_off + jpeg_len <= len(buf)
                and buf[jpeg_off : jpeg_off + 2] == b"\xff\xd8"
                and (best is None or jpeg_len > best[1])
            ):
                best = (jpeg_off, jpeg_len)
            # chained next-IFD pointer
            nxt_off = ifd_off + 2 + 12 * n
            if nxt_off + 4 <= len(buf):
                walk(struct.unpack_from(endian + "I", buf, nxt_off)[0], depth + 1)
            for s in subifds:
                walk(s, depth + 1)

        walk(struct.unpack_from(endian + "I", buf, 4)[0])
        if best is None:
            return None
        jpg = np.frombuffer(buf, np.uint8, count=best[1], offset=best[0])
        img = imops.imdecode_bgr(jpg)
        return img  # BGR, as cv2.imread returns
    except Exception:
        return None


def _imread(path: str) -> np.ndarray | None:
    """RAW-aware imread (reference ``fish_segmentation.py:17-24`` decodes
    ``.arw`` via rawpy).  When rawpy is importable the RAW path decodes; when
    it is not, each skipped file is WARNED about and recorded in
    ``SKIPPED_RAW_FILES`` so a dataset with RAW originals never silently
    shrinks."""
    if path.lower().endswith(".arw"):
        try:
            import rawpy  # optional: present only where RAW data lives
        except ImportError:
            preview = _arw_preview_decode(path)
            if preview is not None:
                return preview
            if path not in SKIPPED_RAW_FILES:
                SKIPPED_RAW_FILES.append(path)
                warnings.warn(
                    f"RAW file skipped (rawpy unavailable, no embedded JPEG "
                    f"preview): {path} "
                    f"({len(SKIPPED_RAW_FILES)} RAW file(s) skipped so far)",
                    stacklevel=2,
                )
            return None
        with rawpy.imread(path) as raw:
            rgb = raw.postprocess()
        return np.ascontiguousarray(rgb[..., ::-1])  # RGB -> BGR
    img = imops.imread_bgr(path)
    return img


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    return imops.resize_linear(img, (size, size))


def _read_resized(path: str, size: int) -> np.ndarray | None:
    """imread + square resize."""
    img = _imread(path)
    if img is None:
        return None
    return _resize(img, size)


# ---------------------------------------------------------------- alvaradolab

def _parse_coco_txt(path: str) -> list[tuple[str, float, np.ndarray]] | None:
    """Parse one COCO-Dataset-Generator txt: [(organ, area, poly_xy), ...]."""
    try:
        with open(path) as f:
            lines = [x.strip() for x in f.readlines()]
        records = []
        for idx in range(4, len(lines), 4):
            organ = lines[idx].replace(" ", "_")
            area = float(lines[idx + 1])
            coords = [int(float(x)) for x in lines[idx + 2].split(" ")]
            poly = np.array(
                [(coords[i], coords[i + 1]) for i in range(0, len(coords) - 1, 2)],
                dtype=np.float64,
            )
            records.append((organ, area, poly))
        return records
    except Exception:
        return None


def get_alvaradolab_data(
    dtype: str,
    path: str,
    folder_path: str,
    img_shape: int,
    min_segment_positivity_ratio: float,
    organs: tuple[str, ...] = ("whole_body",),
    sample_dataset: bool = False,
    bbox_dir: str | None = None,
    augment_flag: bool = True,
) -> IndexedDataset:
    assert "segmentation/composite" in dtype
    del bbox_dir
    images = sorted(glob.glob(os.path.join(folder_path, path, "*.jpg")))
    if sample_dataset:
        images = images[:SAMPLE_LIMIT]

    items: list[tuple[str, list]] = []
    for img_path in images:
        txt_path = img_path[: -len(".jpg")] + ".txt"
        if not os.path.exists(txt_path):
            continue
        probe = imops.imread_bgr(img_path)
        if probe is None:
            continue
        oh, ow = probe.shape[:2]
        records = _parse_coco_txt(txt_path)
        if not records:
            continue
        polys = []
        for organ, area, poly in records:
            if organs is not None and organ not in organs:
                continue
            if area == 0:
                continue
            scale = np.array([img_shape / ow, img_shape / oh])
            polys.append((organ, (poly * scale).astype(np.int32)))
        if not polys:
            continue
        items.append((img_path, polys))

    num_organs = len(organs)

    def decode(i: int):
        img_path, polys = items[i]
        image = _read_resized(img_path, img_shape)
        mask = np.zeros((img_shape, img_shape, num_organs), np.float32)
        seen = set()
        for organ, poly in polys:
            oi = organs.index(organ)
            seen.add(oi)
            chan = np.zeros((img_shape, img_shape), np.uint8)
            native.fill_polygon(chan, poly)  # C++ scanline fill (cv2 fallback)
            if chan.sum() / 255.0 < min_segment_positivity_ratio * img_shape * img_shape:
                mask[:, :, oi] = -1.0  # too-small organ -> ignore
            else:
                mask[:, :, oi] = chan / 255.0
        for oi in range(num_organs):
            if oi not in seen:
                mask[:, :, oi] = -1.0  # absent organ -> ignore
        return image.astype(np.float32) / 255.0, mask, img_path

    return IndexedDataset("alvaradolab", items, decode, tuple(organs), augment_flag)


# ------------------------------------------------------------ ml_training_set

def get_ml_training_set_data(
    dtype: str,
    path: str,
    folder_path: str,
    img_shape: int,
    min_segment_positivity_ratio: float,
    organs: tuple[str, ...] | None = None,
    sample_dataset: bool = False,
    bbox_dir: str | None = None,
    augment_flag: bool = True,
) -> IndexedDataset:
    assert dtype == "segmentation/composite"
    folders = [
        x for x in sorted(glob.glob(os.path.join(folder_path, path, "*"))) if os.path.isdir(x)
    ]
    if bbox_dir is not None:
        # reference fish_segmentation.py:148-149 APPENDS the repaired folder
        folders = folders + [os.path.join(folder_path, bbox_dir)]

    organs = tuple(organs) if organs is not None else ("whole_body",)
    items: list[tuple[str, dict[str, str]]] = []
    for directory in folders:
        images = sorted(glob.glob(os.path.join(directory, "original image", "*")))
        if sample_dataset:
            images = images[:SAMPLE_LIMIT_FOLDERS]
        for image_path in images:
            stem = ".".join(os.path.basename(image_path).split(".")[:-1])
            segment_paths: dict[str, str] = {}
            for ann_path in sorted(glob.glob(os.path.join(directory, "*", stem + "*"))):
                organ_dir = os.path.basename(os.path.dirname(ann_path))
                if organ_dir == "original image":
                    continue
                organ = organ_dir.replace(" ", "_")
                if organ in organs:
                    segment_paths.setdefault(organ, ann_path)
            if not segment_paths:
                continue
            if _imread(image_path) is None:  # RAW-aware: warns+counts .arw
                continue
            # Prune entries with zero readable organ masks (reference
            # fish_segmentation.py:40-55).
            if not any(_imread(p) is not None for p in segment_paths.values()):
                continue
            items.append((image_path, segment_paths))

    def decode(i: int):
        image_path, segment_paths = items[i]
        image = _read_resized(image_path, img_shape)
        mask = np.full((img_shape, img_shape, len(organs)), -1.0, np.float32)
        for oi, organ in enumerate(organs):
            seg_path = segment_paths.get(organ)
            if seg_path is None:
                continue
            seg = _imread(seg_path)
            if seg is None:
                continue
            seg = _resize(seg, img_shape)
            seg = imops.bgr2gray(seg)
            seg = imops.invert_u8(seg)
            seg = np.where(seg > 0, 255, 0).astype(np.uint8)
            if seg.sum() / 255.0 < min_segment_positivity_ratio * img_shape * img_shape:
                seg[:] = 0  # area threshold zero-fill (fish_segmentation.py:120-122)
            mask[:, :, oi] = seg / 255.0
        return image.astype(np.float32) / 255.0, mask, image_path

    return IndexedDataset("ml_training_set", items, decode, organs, augment_flag)


# ----------------------------------------------------------------------- suim

def get_suim_data(
    dtype: str,
    path: str,
    folder_path: str,
    img_shape: int,
    min_segment_positivity_ratio: float,
    organs: tuple[str, ...] = ("whole_body",),
    sample_dataset: bool = False,
    bbox_dir: str | None = None,
    augment_flag: bool = True,
) -> IndexedDataset:
    assert dtype == "segmentation"
    del bbox_dir, min_segment_positivity_ratio
    pairs: dict[str, dict] = {}
    for p in sorted(glob.glob(os.path.join(folder_path, path, "*", "*"))):
        stem = ".".join(os.path.basename(p).split(".")[:-1])
        entry = pairs.setdefault(stem, {"image": None, "segments": []})
        if f"{os.sep}images{os.sep}" in p:
            entry["image"] = p
        else:
            entry["segments"].append(p)

    items = []
    for stem, entry in pairs.items():
        if entry["image"] is None or len(entry["segments"]) != 1:
            continue
        if imops.imread_bgr(entry["image"]) is None or imops.imread_bgr(entry["segments"][0]) is None:
            continue
        items.append((entry["image"], entry["segments"][0]))
    if sample_dataset:
        items = items[:SAMPLE_LIMIT]

    def decode(i: int):
        image_path, seg_path = items[i]
        image = _read_resized(image_path, img_shape)
        seg = imops.imread_bgr(seg_path)
        seg = imops.hsv_inrange_bgr(seg, (20, 100, 100), (30, 255, 255))
        seg = _resize(seg, img_shape)
        mask = (seg[..., None] / 255.0).astype(np.float32)
        return image.astype(np.float32) / 255.0, mask, image_path

    return IndexedDataset("suim", items, decode, tuple(organs), augment_flag)


# ------------------------------------------------------------------- deepfish

def get_deepfish_segclsloc_data(
    dtype: str,
    path: str,
    folder_path: str,
    img_shape: int,
    min_segment_positivity_ratio: float,
    organs: tuple[str, ...] = ("whole_body",),
    sample_dataset: bool = False,
    bbox_dir: str | None = None,
    augment_flag: bool = True,
) -> IndexedDataset:
    assert dtype == "segmentation"
    del bbox_dir, min_segment_positivity_ratio
    images = [
        x
        for x in sorted(glob.glob(os.path.join(folder_path, path, "*")))
        if not os.path.isdir(x)
    ]
    if sample_dataset:
        images = images[:SAMPLE_LIMIT]

    items = []
    for img_path in images:
        ann = os.path.join(
            os.path.dirname(img_path),
            "json",
            os.path.basename(img_path).replace(".jpg", "__labels.json"),
        )
        if not os.path.exists(ann):
            continue
        # Dirtiness contract (module docstring): EVERYTHING that can fail is
        # checked at index-build time — a corrupt/unparseable labels json,
        # malformed region structure, or an unreadable image must be skipped
        # here, never crash __getitem__ mid-epoch.  Polygons are parsed to
        # arrays now so decode re-reads nothing.
        try:
            with open(ann) as f:
                data = json.load(f)
            label_polys = []
            for label in data.get("labels", []):
                pts = [
                    np.array([(p["x"], p["y"]) for p in region], np.int32)
                    for region in label.get("regions", [])
                ]
                label_polys.append([p for p in pts if len(p) > 5])
        except (OSError, ValueError, TypeError, KeyError):
            continue
        if imops.imread_bgr(img_path) is None:
            continue
        items.append((img_path, label_polys))

    def decode(i: int):
        img_path, label_polys = items[i]
        raw = imops.imread_bgr(img_path)
        image = _resize(raw, img_shape)
        seg = np.zeros(raw.shape[:2], np.uint8)
        for pts in label_polys:
            if pts:
                # ONE multi-polygon call per label: cv2's even-odd rule
                # applies across that label's regions (holes/overlaps
                # cancel), matching the reference's cv2.fillPoly(seg, pts=pts)
                imops.fill_poly(seg, pts, 255)
        seg = _resize(seg, img_shape)
        mask = (seg[..., None] / 255.0).astype(np.float32)
        return image.astype(np.float32) / 255.0, mask, img_path

    return IndexedDataset("deepfish_segclsloc", items, decode, tuple(organs), augment_flag)


LOADERS = {
    "alvaradolab": get_alvaradolab_data,
    "ml_training_set": get_ml_training_set_data,
    "suim": get_suim_data,
    "deepfish_segclsloc": get_deepfish_segclsloc_data,
}
