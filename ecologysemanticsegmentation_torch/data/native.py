"""ctypes binding of the port to the native host-ops library
(``native/hostops.cpp``), with the functions of
``ecologysemanticsegmentation_tpu/data/native.py`` (all but its threaded
decode ring) and their fallbacks.

The port compiles its own copy of the library with ``g++`` at first use,
into ``data/build/libhostops_<source hash>.so`` (listed in ``.gitignore``):
it never writes ``native/libhostops.so``.  Each process builds under a
name of its own and ``os.replace``-s the result into place, so two
processes never load a half-written library.  The build degrades as the
JAX binding's does: without libpng's headers it builds JPEG-only, without
libjpeg's the compute ops alone (the JPEG/PNG paths then return None and
callers fall back to :mod:`.imops`).  Without ``g++`` every function runs
its fallback: cv2 where it is installed, else numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

SOURCE = Path(__file__).resolve().parents[2] / "native" / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_VARIANTS = (["-ljpeg", "-lpng"],
             ["-ljpeg", "-DHOSTOPS_NO_PNG"],
             ["-DHOSTOPS_NO_JPEG", "-DHOSTOPS_NO_PNG"])
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path | None:
    """Where the library of the current source lives (None without source)."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhostops_{digest}.so"


def _build(out: Path) -> bool:
    """Compile the fullest variant that builds into ``out``; False when none
    does (no compiler, or a compile error)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        for extra in _VARIANTS:
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), *extra]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except Exception:  # noqa: BLE001 - the toolchain is optional
                continue
            os.replace(tmp, out)
            return True
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if path is None or (not path.exists() and not _build(path)):
                return None
            lib = ctypes.CDLL(str(path))
            lib.fill_polygon_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.resize_area_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.binarize_count_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8]
            lib.binarize_count_u8.restype = ctypes.c_int64
            lib.u8_to_f32_norm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            # The JPEG/PNG entry points exist only in a build that linked
            # libjpeg; absent symbols raise AttributeError on first touch.
            try:
                lib.jpeg_decode_resize_bgr.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.jpeg_decode_resize_bgr.restype = ctypes.c_int64
                lib.jpeg_read_resize_bgr.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.jpeg_read_resize_bgr.restype = ctypes.c_int64
                lib.image_read_resize_bgr.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.image_read_resize_bgr.restype = ctypes.c_int64
                lib.hostops_has_png.restype = ctypes.c_int64
                lib._has_jpeg = True
                lib._has_png = bool(lib.hostops_has_png())
            except AttributeError:
                lib._has_jpeg = False
                lib._has_png = False
            _lib = lib
        except Exception:  # noqa: BLE001 - toolchain optional
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def fill_polygon(mask: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Rasterize an (N, 2) int32 xy polygon into a uint8 HxW mask (255 fill).

    Native scanline fill; cv2.fillPoly, else a numpy scanline, as fallback.
    The rasterizers differ by under a pixel on boundary pixels; loaders
    treat either as ground truth.
    """
    assert mask.dtype == np.uint8 and mask.flags.c_contiguous
    lib = _load()
    poly = np.ascontiguousarray(polygon, np.int32)
    if lib is None:
        if cv2 is not None:
            cv2.fillPoly(mask, [poly.reshape(-1, 1, 2)], 255)
        else:
            from .imops import _scanline_fill

            _scanline_fill(mask, poly.astype(np.int64))
        return mask
    xs = np.ascontiguousarray(poly[:, 0])
    ys = np.ascontiguousarray(poly[:, 1])
    lib.fill_polygon_u8(
        mask.ctypes.data, mask.shape[0], mask.shape[1],
        xs.ctypes.data, ys.ctypes.data, len(poly),
    )
    return mask


def resize_area(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Box-filter uint8 resize (mask downscale)."""
    lib = _load()
    if lib is None:
        if cv2 is not None:
            return cv2.resize(src, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_AREA)
        return _resize_area_numpy(np.asarray(src, np.uint8), out_hw)
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(out_hw, np.uint8)
    lib.resize_area_u8(src.ctypes.data, src.shape[0], src.shape[1],
                       dst.ctypes.data, out_hw[0], out_hw[1])
    return dst


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) overlap of each output cell with each input cell,
    rows normalized: the box filter of an area resize along one axis."""
    edges = np.arange(n_out + 1) * (n_in / n_out)
    lo, hi = edges[:-1, None], edges[1:, None]
    cells = np.arange(n_in)[None, :]
    w = np.clip(np.minimum(hi, cells + 1) - np.maximum(lo, cells), 0.0, None)
    return w / w.sum(axis=1, keepdims=True)


def _resize_area_numpy(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    wy = _area_weights(src.shape[0], out_hw[0])
    wx = _area_weights(src.shape[1], out_hw[1])
    out = np.einsum("ab,bc...,dc->ad...", wy, src.astype(np.float64), wx)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def binarize_count(mask: np.ndarray, threshold: int = 0) -> int:
    """In-place binarize (>threshold -> 255) returning the positive count."""
    lib = _load()
    if lib is None:
        pos = mask > threshold
        mask[:] = np.where(pos, 255, 0)
        return int(pos.sum())
    mask = np.ascontiguousarray(mask, np.uint8)
    return int(lib.binarize_count_u8(mask.ctypes.data, mask.size, threshold))


def u8_to_f32(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 / 255 (native single pass)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if lib is None:
        return img.astype(np.float32) / 255.0
    out = np.empty(img.shape, np.float32)
    lib.u8_to_f32_norm(img.ctypes.data, out.ctypes.data, img.size)
    return out


# ------------------------------------------------------------- JPEG fast path


def jpeg_available() -> bool:
    """True when the native lib linked against libjpeg(-turbo)."""
    lib = _load()
    return lib is not None and getattr(lib, "_has_jpeg", False)


def png_available() -> bool:
    """True when the native lib also linked libpng (PNG rides the same
    fused read+decode+resize path)."""
    lib = _load()
    return lib is not None and getattr(lib, "_has_png", False)


_ring_exts: tuple[str, ...] | None = None


def ring_extensions() -> tuple[str, ...]:
    """File extensions the native decode path handles.
    Cached — hot loader paths call this per image, and the lib's
    capabilities are fixed after the one-shot ``_load``."""
    global _ring_exts
    if _ring_exts is None:
        if not jpeg_available():
            _ring_exts = ()
        else:
            _ring_exts = (".jpg", ".jpeg") + (
                (".png",) if png_available() else ())
    return _ring_exts


def image_read_resize(path: str, out_hw: tuple[int, int],
                      fast_scale_to: int = 0) -> np.ndarray | None:
    """Fused file read + decode + bilinear resize for ANY supported format
    (magic-byte sniffed: JPEG, and PNG when libpng linked) to (h, w, 3)
    BGR u8.  Returns None when unavailable or decode fails (callers fall
    back to imops).  ``fast_scale_to`` applies to JPEGs only."""
    lib = _load()
    if lib is None or not lib._has_jpeg:
        return None
    out = np.empty((out_hw[0], out_hw[1], 3), np.uint8)
    rc = lib.image_read_resize_bgr(path.encode(), out.ctypes.data,
                                   out_hw[0], out_hw[1], fast_scale_to)
    return out if rc == 0 else None


def jpeg_read_resize(path: str, out_hw: tuple[int, int],
                     fast_scale_to: int = 0) -> np.ndarray | None:
    """Fused JPEG file read + decode + bilinear resize to (h, w, 3) BGR u8.

    One native call replaces the reference's ``cv2.imread`` + ``cv2.resize``
    pair (``fish_segmentation.py:60-61`` semantics): no full-resolution
    intermediate crosses the Python boundary, and with ``fast_scale_to > 0``
    libjpeg prescales in the DCT domain (M/8 IDCT scaling) before the
    bilinear tap — the decode itself shrinks with the target size.

    Pixels agree with the cv2 pair within 1-2 LSB, the tolerance class of
    the PIL fallback (:mod:`.imops`).  Returns None when
    the native path is unavailable or decode fails (callers fall back to
    imops).
    """
    lib = _load()
    if lib is None or not lib._has_jpeg:
        return None
    out = np.empty((out_hw[0], out_hw[1], 3), np.uint8)
    rc = lib.jpeg_read_resize_bgr(path.encode(), out.ctypes.data,
                                  out_hw[0], out_hw[1], fast_scale_to)
    return out if rc == 0 else None


def jpeg_decode_resize(buf: bytes | np.ndarray, out_hw: tuple[int, int],
                       fast_scale_to: int = 0) -> np.ndarray | None:
    """As :func:`jpeg_read_resize` but from an in-memory JPEG byte buffer."""
    lib = _load()
    if lib is None or not lib._has_jpeg:
        return None
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) else \
        np.ascontiguousarray(buf, np.uint8)
    out = np.empty((out_hw[0], out_hw[1], 3), np.uint8)
    rc = lib.jpeg_decode_resize_bgr(arr.ctypes.data, arr.size, out.ctypes.data,
                                    out_hw[0], out_hw[1], fast_scale_to)
    return out if rc == 0 else None
