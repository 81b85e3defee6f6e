"""Host-side image utilities for the NOCS data pipeline (numpy + cv2).

A copy of ``hspose_tpu/data/image_utils.py``, which the port cannot import,
with cv2 imported inside the functions that call it: the machine with the
card has no opencv, and the harness imports this module there.  The eval
path's functions only (the train loader's DZI jitter and mask noise come
with the training loop).  Covers the reference's ``tools/eval_utils.py``
(``load_depth`` :143-156, ``get_bbox`` :159-187) and
``tools/dataset_utils.py`` (coordinate maps :4-22, CenterNet-style
warp-affine crop :80-136).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def png_color_valid(path: str) -> Tuple[int, int] | None:
    """Full structural + CRC integrity validation of a PNG, without decoding.

    The reference fully cv2-decodes the color PNG only to read its shape and
    retry-walks on ANY unreadable file (load_data.py:219-227).  This walks
    every chunk to IEND and CRC-checks the critical ones (IHDR/PLTE/IDAT/IEND)
    — the set libpng hard-fails on (ancillary-chunk CRC errors are warnings in
    libpng's default config, so cv2 accepts those too).  Catches truncation,
    a missing IEND, and any bit corruption of the compressed image data, at
    crc32 speed (~0.1 ms for a VGA color PNG) instead of the ~3 ms inflate +
    defilter of a full decode.  Returns (height, width) or None.
    """
    import zlib

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    n = len(data)
    # signature + first chunk must be IHDR (libpng errors otherwise)
    if n < 45 or data[:8] != _PNG_SIG or data[12:16] != b"IHDR":
        return None
    pos = 8
    dims = None
    saw_idat = saw_iend = False
    while pos + 12 <= n:
        length = int.from_bytes(data[pos:pos + 4], "big")
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if length > 0x7FFFFFFF or end + 4 > n:
            return None  # truncated chunk
        if (ctype[0] & 0x20) == 0:  # critical chunk: CRC must hold
            crc = int.from_bytes(data[end:end + 4], "big")
            if (zlib.crc32(data[pos + 4:end]) & 0xFFFFFFFF) != crc:
                return None
        if ctype == b"IHDR":
            if length != 13 or dims is not None:
                return None
            w = int.from_bytes(data[pos + 8:pos + 12], "big")
            h = int.from_bytes(data[pos + 12:pos + 16], "big")
            if w <= 0 or h <= 0:
                return None
            dims = (h, w)
        elif ctype == b"IDAT":
            saw_idat = True
        elif ctype == b"IEND":
            saw_iend = True
            break
        pos = end + 4
    if dims is None or not saw_idat or not saw_iend:
        return None
    return dims


def load_depth(depth_path: str) -> np.ndarray:
    """Decode a NOCS depth PNG: plain uint16, or RGB-encoded 256*G + B."""
    import cv2

    depth = cv2.imread(depth_path, -1)
    if depth is None:
        raise FileNotFoundError(depth_path)
    if depth.ndim == 3:
        depth16 = depth[:, :, 1].astype(np.int32) * 256 + depth[:, :, 2].astype(np.int32)
        depth16 = np.where(depth16 == 32001, 0, depth16).astype(np.uint16)
        return depth16
    if depth.ndim == 2 and depth.dtype == np.uint16:
        return depth
    raise ValueError(f"unsupported depth format in {depth_path}")


def get_bbox(bbox, img_h: int = 480, img_w: int = 640) -> Tuple[int, int, int, int]:
    """Square crop window snapped to the 40px grid, max 440, clamped to the image
    (tools/eval_utils.py:159-187).  bbox: (y1, x1, y2, x2)."""
    y1, x1, y2, x2 = bbox
    window_size = (max(y2 - y1, x2 - x1) // 40 + 1) * 40
    window_size = min(window_size, 440)
    center = [(y1 + y2) // 2, (x1 + x2) // 2]
    rmin = center[0] - int(window_size / 2)
    rmax = center[0] + int(window_size / 2)
    cmin = center[1] - int(window_size / 2)
    cmax = center[1] + int(window_size / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return rmin, rmax, cmin, cmax


@functools.lru_cache(maxsize=8)
def _get_2d_coord_cached(width: int, height: int) -> np.ndarray:
    x = np.linspace(0, width - 1, width, dtype=np.float32)
    y = np.linspace(0, height - 1, height, dtype=np.float32)
    arr = np.asarray(np.meshgrid(x, y))
    # the cached array is shared by every caller in the process: freeze it so an
    # accidental in-place write raises instead of corrupting the map globally
    arr.setflags(write=False)
    return arr


def get_2d_coord(width: int, height: int) -> np.ndarray:
    """(2, H, W) pixel coordinate map (tools/dataset_utils.py:4-22); static per
    image size, so cached (it was ~5% of the per-sample host cost)."""
    return _get_2d_coord_cached(int(width), int(height))


def bbox_center_scale_eval(bbox_xyxy: np.ndarray, im_h: int, im_w: int):
    """Deterministic eval crop (evaluation/load_data_eval.py:222-228)."""
    x1, y1, x2, y2 = [float(v) for v in bbox_xyxy]
    center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
    scale = min(max(y2 - y1, x2 - x1), max(im_h, im_w)) * 1.0
    return center, scale


def _get_affine_transform(center, scale, output_size: int) -> np.ndarray:
    """CenterNet-style source→destination affine (tools/dataset_utils.py:98-136,
    rot=0 specialisation)."""
    center = np.asarray(center, np.float32)
    scale = np.array([scale, scale], np.float32)
    src_dir = np.array([0, scale[0] * -0.5], np.float32)
    dst_dir = np.array([0, output_size * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [output_size * 0.5, output_size * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = third(src[0], src[1])
    dst[2] = third(dst[0], dst[1])
    import cv2

    return cv2.getAffineTransform(src, dst)


def crop_resize_by_warp_affine(img: np.ndarray, center, scale, output_size: int,
                               interpolation=None) -> np.ndarray:
    """Square ROI crop via warp-affine (tools/dataset_utils.py:80-96);
    ``interpolation`` defaults to cv2.INTER_NEAREST."""
    import cv2

    trans = _get_affine_transform(center, scale, output_size)
    flags = cv2.INTER_NEAREST if interpolation is None else interpolation
    return cv2.warpAffine(img, trans, (output_size, output_size), flags=flags)
