"""Host-side image primitives of the port: cv2 when importable, else PIL,
else numpy (counterpart of ``ecologysemanticsegmentation_tpu/data/imops.py``,
the same functions tried in the same order).

Where neither cv2 nor PIL is installed:

* ``imwrite_bgr`` writes PNG itself (``zlib`` and ``struct``), as an 8-bit
  grayscale or RGB image; other formats raise;
* the readers (``imread_bgr``, ``imdecode_bgr``) return None, and
  ``cv2_or_stub`` raises when a cv2-only operation is called;
* colour and draw operations run their numpy forms, and ``fill_poly`` the
  native scanline fill (:mod:`.native`) or a numpy one.

Fallback fidelity: PIL reads and writes are exact; PIL's bilinear resize is
within 1-2 LSB of cv2's; the numpy colour conversions reproduce cv2's uint8
formulas up to rounding ties; the draw fallbacks paint the analytic point
set (boundary pixels differ from cv2's rasterizer by under a pixel);
``largest_contour`` without cv2 is a 72-ray star polygon.
"""

from __future__ import annotations

import functools
import io
import os
import struct
import warnings
import zlib

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

HAS_CV2 = cv2 is not None


class _MissingCv2:
    """Attribute trampoline: raises only when a cv2-required operation is
    actually invoked (video capture/encode, Sobel/matchTemplate analysis
    tools) — importing the modules stays legal without OpenCV."""

    def __getattr__(self, name):
        raise RuntimeError(
            f"OpenCV (cv2) is required for this operation (cv2.{name}); "
            "the core training/serving paths run without it (data.imops)")


#: ``cv2`` when importable, else a call-time-error stub.  Modules whose
#: algorithms have no PIL/numpy equivalent import THIS as their ``cv2``.
cv2_or_stub = cv2 if cv2 is not None else _MissingCv2()


@functools.lru_cache(maxsize=None)
def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


# ------------------------------------------------------------------------ IO


def imread_bgr(path: str) -> np.ndarray | None:
    """cv2.imread semantics: BGR uint8 HxWx3, or None on any failure."""
    if cv2 is not None:
        return cv2.imread(path)
    if _pil_image() is None:
        return None
    try:
        with _pil_image().open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        return np.ascontiguousarray(rgb[..., ::-1])
    except Exception:
        return None


def imdecode_bgr(buf: np.ndarray) -> np.ndarray | None:
    """cv2.imdecode(..., IMREAD_COLOR) semantics on an encoded uint8 buffer."""
    if cv2 is not None:
        return cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if _pil_image() is None:
        return None
    try:
        with _pil_image().open(io.BytesIO(buf.tobytes())) as im:
            rgb = np.asarray(im.convert("RGB"))
        return np.ascontiguousarray(rgb[..., ::-1])
    except Exception:
        return None


def imwrite_bgr(path: str, img: np.ndarray) -> bool:
    """cv2.imwrite semantics (BGR uint8 in; format from the extension).
    Without cv2 and PIL it writes PNG only, itself."""
    if cv2 is not None:
        return bool(cv2.imwrite(path, img))
    arr = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if _pil_image() is None:
        if ext != ".png":
            raise RuntimeError(f"without cv2 or PIL only PNG can be written, not {path!r}")
        with open(path, "wb") as f:
            f.write(_encode_png(arr))
        return True
    if arr.ndim == 2:
        pil = _pil_image().fromarray(arr.astype(np.uint8), "L")
    else:
        pil = _pil_image().fromarray(
            np.ascontiguousarray(arr[..., ::-1].astype(np.uint8)), "RGB"
        )
    kwargs = {"quality": 95} if ext in (".jpg", ".jpeg") else {}
    pil.save(path, **kwargs)
    return True


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode_png(img: np.ndarray) -> bytes:
    """An 8-bit grayscale (H, W) or RGB PNG of a BGR (H, W, 3) image; every
    row with filter type 0."""
    arr = np.asarray(img).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        arr, color = arr[..., ::-1], 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3) images, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def resize_linear(img: np.ndarray, wh: tuple[int, int]) -> np.ndarray:
    """cv2.resize default (INTER_LINEAR) semantics; ``wh`` is (width, height)."""
    if cv2 is not None:
        return cv2.resize(img, wh)
    im = _pil_image().fromarray(img)
    out = np.asarray(im.resize(wh, _pil_image().BILINEAR))
    return np.ascontiguousarray(out)


# --------------------------------------------------------------------- color


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2 BGR2GRAY: round(0.299 R + 0.587 G + 0.114 B) as uint8."""
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    b, g, r = img[..., 0].astype(np.float64), img[..., 1].astype(np.float64), \
        img[..., 2].astype(np.float64)
    return np.clip(np.rint(0.299 * r + 0.587 * g + 0.114 * b), 0, 255).astype(np.uint8)


def bgr2hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2 BGR2HSV uint8 semantics: H in [0, 180), S/V in [0, 255]."""
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    b = img[..., 0].astype(np.float64)
    g = img[..., 1].astype(np.float64)
    r = img[..., 2].astype(np.float64)
    v = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    diff = v - mn
    s = np.where(v > 0, 255.0 * diff / np.maximum(v, 1e-12), 0.0)
    safe = np.maximum(diff, 1e-12)
    h = np.where(
        v == r, 60.0 * (g - b) / safe,
        np.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                 240.0 + 60.0 * (r - g) / safe),
    )
    h = np.where(diff == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h) / 2.0
    out = np.stack([np.rint(h), np.rint(s), np.rint(v)], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def hsv_inrange_bgr(img_bgr: np.ndarray, lo: tuple, hi: tuple) -> np.ndarray:
    """``cv2.inRange(cv2.cvtColor(img, BGR2HSV), lo, hi)``: uint8 {0, 255}."""
    if cv2 is not None:
        return cv2.inRange(cv2.cvtColor(img_bgr, cv2.COLOR_BGR2HSV), lo, hi)
    hsv = bgr2hsv_u8(img_bgr)
    ok = np.all((hsv >= np.asarray(lo)) & (hsv <= np.asarray(hi)), axis=-1)
    return np.where(ok, 255, 0).astype(np.uint8)


def invert_u8(img: np.ndarray) -> np.ndarray:
    """cv2.bitwise_not on uint8."""
    if cv2 is not None:
        return cv2.bitwise_not(img)
    return (255 - img.astype(np.uint8)).astype(np.uint8)


def hsv2bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2 HSV2BGR uint8 semantics (H in [0, 180))."""
    if cv2 is not None:
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    h = hsv[..., 0].astype(np.float64) * 2.0  # degrees
    s = hsv[..., 1].astype(np.float64) / 255.0
    v = hsv[..., 2].astype(np.float64)
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    z = np.zeros_like(c)
    conds = [(hp < 1), (hp < 2), (hp < 3), (hp < 4), (hp < 5)]
    r = np.select(conds, [c, x, z, z, x], default=c)
    g = np.select(conds, [x, c, c, x, z], default=z)
    b = np.select(conds, [z, z, x, c, c], default=x)
    m = v - c
    out = np.stack([b + m, g + m, r + m], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def add_weighted(a: np.ndarray, wa: float, b: np.ndarray, wb: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted on uint8: saturate(round(a*wa + b*wb + gamma))."""
    if cv2 is not None:
        return cv2.addWeighted(a, wa, b, wb, gamma)
    out = a.astype(np.float64) * wa + b.astype(np.float64) * wb + gamma
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- draw


def _paint(img: np.ndarray, region: np.ndarray, color) -> None:
    if img.ndim == 2:
        img[region] = color if np.isscalar(color) else color[0]
    else:
        img[region] = np.asarray(color, img.dtype)


def ellipse_filled(img: np.ndarray, center: tuple[int, int],
                   axes: tuple[int, int], angle_deg: float, color) -> None:
    """Filled rotated ellipse (cv2.ellipse(..., 0, 360, color, -1)); paints
    in place.  Fallback paints the analytic quadratic-form point set."""
    if cv2 is not None:
        cv2.ellipse(img, center, axes, angle_deg, 0, 360, color, -1)
        return
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = center
    ax, ay = max(int(axes[0]), 1), max(int(axes[1]), 1)
    t = np.deg2rad(angle_deg)
    xr = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
    yr = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
    _paint(img, (xr / ax) ** 2 + (yr / ay) ** 2 <= 1.0, color)


def circle_filled(img: np.ndarray, center: tuple[int, int], radius: int,
                  color) -> None:
    """Filled circle (cv2.circle(..., -1)); paints in place."""
    if cv2 is not None:
        cv2.circle(img, center, radius, color, -1)
        return
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    _paint(img, (xx - center[0]) ** 2 + (yy - center[1]) ** 2 <= radius ** 2, color)


def fill_poly(img: np.ndarray, pts, color) -> None:
    """Filled polygon(s) (cv2.fillPoly); paints in place.  ``pts`` is one
    (N, 2) array or a LIST of them — a multi-polygon call keeps cv2's
    even-odd semantics ACROSS polygons (overlaps/holes cancel), exactly like
    a single ``cv2.fillPoly(img, [p1, p2, ...])`` call.  Fallback rasterizes
    each polygon through the native scanline fill (native/hostops.cpp) or a
    numpy even-odd scanline, then XORs the per-polygon regions (equivalent
    for non-self-intersecting polygons)."""
    polys = pts if isinstance(pts, (list, tuple)) else [pts]
    polys = [np.asarray(p, np.int64).reshape(-1, 2) for p in polys]
    if cv2 is not None:
        cv2.fillPoly(img, [p.astype(np.int32).reshape(-1, 1, 2) for p in polys],
                     color)
        return
    from . import native

    parity = np.zeros(img.shape[:2], bool)
    for poly in polys:
        mask = np.zeros(img.shape[:2], np.uint8)
        if native.native_available():
            native.fill_polygon(mask, poly.astype(np.int32))
        else:
            _scanline_fill(mask, poly)
        parity ^= mask > 0
    _paint(img, parity, color)


def _scanline_fill(mask: np.ndarray, poly: np.ndarray) -> None:
    """Even-odd scanline polygon fill (numpy, pure-Python row loop)."""
    h, w = mask.shape
    ys = poly[:, 1].astype(np.float64)
    xs = poly[:, 0].astype(np.float64)
    n = len(poly)
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    for y in range(y0, y1 + 1):
        yc = y + 0.0
        crossings = []
        for i in range(n):
            x1p, y1p = xs[i], ys[i]
            x2p, y2p = xs[(i + 1) % n], ys[(i + 1) % n]
            if (y1p <= yc < y2p) or (y2p <= yc < y1p):
                tpar = (yc - y1p) / (y2p - y1p)
                crossings.append(x1p + tpar * (x2p - x1p))
        crossings.sort()
        for a, b in zip(crossings[0::2], crossings[1::2]):
            lo = max(int(np.ceil(a)), 0)
            hi = min(int(np.floor(b)), w - 1)
            if hi >= lo:
                mask[y, lo:hi + 1] = 255
    # vertices themselves (degenerate thin polygons)
    for xpt, ypt in poly:
        if 0 <= ypt < h and 0 <= xpt < w:
            mask[int(ypt), int(xpt)] = 255


def largest_contour(mask_u8: np.ndarray) -> np.ndarray | None:
    """Largest external contour of a {0,255} mask as an (N, 2) int32 xy array
    (cv2.findContours + max-by-contourArea).  Fallback: a 72-ray star polygon
    from the region centroid — an APPROXIMATION adequate for the star-convex
    synthetic fixture's COCO materialization (documented in the module
    docstring), not a general contour tracer."""
    if cv2 is not None:
        contours, _ = cv2.findContours(mask_u8, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        if not contours:
            return None
        cnt = max(contours, key=cv2.contourArea)
        return cnt.reshape(-1, 2).astype(np.int32)
    ys, xs = np.nonzero(mask_u8)
    if len(xs) == 0:
        return None
    warnings.warn("largest_contour without cv2: star-polygon approximation",
                  stacklevel=2)
    cx, cy = float(xs.mean()), float(ys.mean())
    h, w = mask_u8.shape
    pts = []
    for ang in np.linspace(0.0, 2 * np.pi, 72, endpoint=False):
        dx, dy = np.cos(ang), np.sin(ang)
        best = None
        for r in range(0, int(np.hypot(h, w)) + 1):
            x = int(round(cx + r * dx))
            y = int(round(cy + r * dy))
            if not (0 <= x < w and 0 <= y < h):
                break
            if mask_u8[y, x] > 0:
                best = (x, y)
        if best is not None:
            pts.append(best)
    if len(pts) < 3:
        return None
    return np.asarray(pts, np.int32)
