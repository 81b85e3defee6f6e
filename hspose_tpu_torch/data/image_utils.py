"""Host-side image utilities for the NOCS data pipeline, in numpy and zlib.

A copy of ``hspose_tpu/data/image_utils.py``, which the port cannot import,
without OpenCV: the machine with the card has neither opencv nor libpng.
Covers the reference's ``tools/eval_utils.py`` (``load_depth`` :143-156,
``get_bbox`` :159-187), ``tools/dataset_utils.py`` (coordinate maps :4-22,
DZI crop augmentation :24-61, CenterNet-style warp-affine crop :80-136) and
``datasets/data_augmentation.defor_2D`` (:9-32).

Where the JAX package calls cv2, this module has a numpy counterpart with
the same bits (``tests/test_torch_port_train_data.py`` holds each to cv2):

* ``read_png`` decodes 8- and 16-bit non-interlaced PNGs (gray, RGB, RGBA)
  with ``zlib``: ``load_depth`` is ``cv2.imread(path, -1)``'s depth and
  ``load_mask`` is ``cv2.imread(path)[:, :, 2]``;
* ``fused_crop`` is the three INTER_NEAREST ``cv2.warpAffine`` crops of a
  sample (depth, mask, coordinate map), in cv2's arithmetic from
  ``getAffineTransform``'s LU solve on;
* ``defor_2d_mask`` erodes and dilates with cv2's 2x2 ellipse by shifted
  minima and maxima;
* ``write_png`` writes what ``cv2.imwrite`` writes, pixel for pixel.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type: gray, RGB, RGBA (palette, gray+alpha not read)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def png_header_dims(path: str) -> Tuple[int, int] | None:
    """(height, width) from a PNG's IHDR header, or None if the file is
    missing/not a PNG/truncated before the header.  Pure-Python analog of the
    native hsp_png_dims — used to validate files whose pixels are never read
    (the color PNG contributes only existence + shape, load_data.py:219-227)
    without paying a full decode."""
    try:
        with open(path, "rb") as f:
            head = f.read(33)
    except OSError:
        return None
    if len(head) < 33 or head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        return None
    w = int.from_bytes(head[16:20], "big")
    h = int.from_bytes(head[20:24], "big")
    if w <= 0 or h <= 0:
        return None
    return h, w


def _png_chunks(path: str):
    """(IHDR body, concatenated IDAT bodies) of a PNG whose chunks all hold
    together up to IEND and whose critical chunks' CRCs hold (the set libpng
    hard-fails on; ancillary CRC errors are warnings there), else None."""
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
    ihdr = None
    idat = []
    saw_iend = False
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
            if length != 13 or ihdr is not None:
                return None
            ihdr = data[pos + 8:end]
        elif ctype == b"IDAT":
            idat.append(data[pos + 8:end])
        elif ctype == b"IEND":
            saw_iend = True
            break
        pos = end + 4
    if ihdr is None or not idat or not saw_iend:
        return None
    return ihdr, b"".join(idat)


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
    chunks = _png_chunks(path)
    if chunks is None:
        return None
    w, h = struct.unpack(">II", chunks[0][:8])
    if w <= 0 or h <= 0:
        return None
    return h, w


def _unfilter_rows(kinds: np.ndarray, data: np.ndarray, prev: np.ndarray,
                   w: int, bpp: int) -> np.ndarray:
    """Rows filtered by None (0), Sub (1) or Up (2) under the row ``prev``: a
    run of None / Sub rows at once (each depends on itself only), an Up row
    at once."""
    h = len(kinds)
    out = np.empty((h, w * bpp), np.uint8)
    y = 0
    while y < h:
        if kinds[y] <= 1:
            z = y + 1
            while z < h and kinds[z] <= 1:
                z += 1
            block = data[y:z].reshape(z - y, w, bpp).copy()
            sub = kinds[y:z] == 1
            block[sub] = np.cumsum(block[sub], axis=1, dtype=np.uint8)
            out[y:z] = block.reshape(z - y, w * bpp)
            y = z
        else:
            out[y] = data[y] + prev
            y += 1
        prev = out[y - 1]
    return out


@functools.lru_cache(maxsize=1)
def _predictions() -> np.ndarray:
    """Each filter's prediction less c, for kind (0 None .. 4 Paeth), a - c
    and b - c (a the byte to the left, b the one above, c above-left), flat
    at ``(kind * 511 + a - c + 255) * 511 + b - c + 255``.  Average and Paeth
    depend on a, b and c only through the two differences:
    (a + b) >> 1 = c + ((a - c) + (b - c)) >> 1."""
    da = np.arange(-255, 256, dtype=np.int32)[:, None]
    db = np.arange(-255, 256, dtype=np.int32)[None, :]
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    zero = np.zeros_like(paeth)
    return np.stack([zero, da + zero, db + zero, (da + db) >> 1, paeth]).ravel()


def _unfilter_diagonals(kinds: np.ndarray, data: np.ndarray, prev: np.ndarray,
                        w: int, bpp: int) -> np.ndarray:
    """Rows of any filter under the row ``prev``, by anti-diagonals.

    Pixel x of row i (row 0 is ``prev``) needs pixels x - 1 of rows i and
    i - 1 and pixel x of row i - 1 only.  Stored at ``t[i + x + 1, i]``, it
    needs column j - 1 and j - 2 of ``t`` only, so each column is one vector
    step over the rows: len(kinds) + w - 1 steps, where Average and Paeth
    taken row by row are a Python step per byte."""
    r = len(kinds)
    t = np.zeros((r + w + 1, r + 1, bpp), np.int32)
    f = np.zeros_like(t)
    rows = np.arange(r + 1)
    cols = rows[None, :] + np.arange(w)[:, None] + 1  # (w, r + 1)
    t[cols[:, 0], 0] = prev.reshape(w, bpp)
    f[cols[:, 1:], rows[None, 1:]] = data.reshape(r, w, bpp).transpose(1, 0, 2)
    table = _predictions()
    base = (kinds.astype(np.int32) * 511 * 511 + 255 * 511 + 255)[:, None]
    keep_c = (kinds != 0).astype(np.int32)[:, None]  # None predicts 0, not c
    for j in range(2, r + w + 1):
        lo, hi = max(1, j - w), min(r, j - 1)  # rows with a pixel in column j
        a = t[j - 1, lo:hi + 1]
        b = t[j - 1, lo - 1:hi]
        c = t[j - 2, lo - 1:hi]
        pred = table[base[lo - 1:hi] + (a - c) * 511 + (b - c)] + c * keep_c[lo - 1:hi]
        t[j, lo:hi + 1] = (f[j, lo:hi + 1] + pred) & 0xFF
    return t[cols[:, 1:], rows[None, 1:]].transpose(1, 0, 2).astype(np.uint8).reshape(r, w * bpp)


def read_png(path: str) -> Optional[np.ndarray]:
    """Lossless decode of an 8- or 16-bit non-interlaced gray, RGB or RGBA
    PNG: (H, W) for gray, else (H, W, C) in the file's channel order (RGB,
    not cv2's BGR), uint8 or uint16.  None where libpng would fail (a
    missing, truncated or corrupt file) and for the formats it does not
    read (other bit depths, palettes, gray + alpha, interlacing)."""
    chunks = _png_chunks(path)
    if chunks is None:
        return None
    ihdr, idat = chunks
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if (w <= 0 or h <= 0 or depth not in (8, 16) or ctype not in _CHANNELS
            or comp != 0 or filt != 0 or interlace != 0):
        return None
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    try:
        raw = zlib.decompress(idat)
    except zlib.error:
        return None
    if len(raw) < h * (stride + 1):
        return None
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.max() > 4:
        return None
    # rows from the first Average / Paeth row to the last by anti-diagonals,
    # the rows before and after row by row
    slow = np.flatnonzero(kinds >= 3)
    y0, y1 = (int(slow[0]), int(slow[-1]) + 1) if len(slow) else (h, h)
    out = np.empty((h, stride), np.uint8)
    out[:y0] = _unfilter_rows(kinds[:y0], data[:y0], np.zeros(stride, np.uint8), w, bpp)
    if y1 > y0:
        above = out[y0 - 1] if y0 else np.zeros(stride, np.uint8)
        out[y0:y1] = _unfilter_diagonals(kinds[y0:y1], data[y0:y1], above, w, bpp)
    if y1 < h:
        out[y1:] = _unfilter_rows(kinds[y1:], data[y1:], out[y1 - 1], w, bpp)
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def load_depth(depth_path: str) -> np.ndarray:
    """Decode a NOCS depth PNG as ``cv2.imread(path, -1)`` and the JAX
    package's ``load_depth`` do: plain uint16, or RGB-encoded 256*G + R with
    32001 -> 0.  Raises FileNotFoundError where the decode fails and
    ValueError on other formats."""
    depth = read_png(depth_path)
    if depth is None:
        raise FileNotFoundError(depth_path)
    if depth.ndim == 3:
        depth16 = depth[:, :, 1].astype(np.int32) * 256 + depth[:, :, 0].astype(np.int32)
        return np.where(depth16 == 32001, 0, depth16).astype(np.uint16)
    if depth.dtype == np.uint16:
        return depth
    raise ValueError(f"unsupported depth format in {depth_path}")


def load_mask(mask_path: str) -> Optional[np.ndarray]:
    """The mask the loader reads, ``cv2.imread(path)[:, :, 2]``: the red
    channel (or the gray value), 16-bit samples cut to their high byte;
    None where the decode fails."""
    img = read_png(mask_path)
    if img is None:
        return None
    if img.ndim == 3:
        img = img[:, :, 0]
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` as ``cv2.imwrite`` does, pixel for pixel: (H, W) uint8
    or uint16 as gray, (H, W, 3) uint8 as BGR into an RGB file; every row
    Sub-filtered, as libpng filters cv2's rows."""
    if img.ndim == 3:
        if img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"write_png: (H, W, 3) must be uint8, got {img.dtype}")
        px, ctype = img[:, :, ::-1], 2
    elif img.dtype in (np.uint8, np.uint16):
        px, ctype = img, 0
    else:
        raise ValueError(f"write_png: unsupported {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(px.astype(">u2") if depth == 16 else px).view(np.uint8)
    rows = rows.reshape(h, -1)
    bpp = rows.shape[1] // w
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 1  # Sub
    filtered[:, 1:bpp + 1] = rows[:, :bpp]
    filtered[:, bpp + 1:] = rows[:, bpp:] - rows[:, :-bpp]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + chunk(b"IEND", b""))


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


def aug_bbox_dzi(rng: np.random.Generator, bbox_xyxy: np.ndarray, im_h: int, im_w: int,
                 pad_scale: float = 1.5, scale_ratio: float = 0.25,
                 shift_ratio: float = 0.25, dzi_type: str = "uniform"):
    """Dynamic-zoom-in square crop jitter (tools/dataset_utils.py:24-61).
    Returns (center (2,), scale float)."""
    x1, y1, x2, y2 = [float(v) for v in bbox_xyxy]
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bh, bw = y2 - y1, x2 - x1
    if dzi_type.lower() == "uniform":
        s_ratio = 1 + scale_ratio * (2 * rng.random() - 1)
        sh = shift_ratio * (2 * rng.random(2) - 1)
        center = np.array([cx + bw * sh[0], cy + bh * sh[1]])
        scale = max(y2 - y1, x2 - x1) * s_ratio * pad_scale
    elif dzi_type.lower() == "roi10d":
        # shift each box edge by up to ±15% (tools/dataset_utils.py:42-55)
        x1 += bw * rng.uniform(-0.15, 0.15)
        x2 += bw * rng.uniform(-0.15, 0.15)
        y1 += bh * rng.uniform(-0.15, 0.15)
        y2 += bh * rng.uniform(-0.15, 0.15)
        x1 = min(max(x1, 0), im_w)
        x2 = min(max(x2, 0), im_w)
        y1 = min(max(y1, 0), im_h)
        y2 = min(max(y2, 0), im_h)
        center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
        scale = max(y2 - y1, x2 - x1) * pad_scale
    else:
        center = np.array([cx, cy])
        scale = max(y2 - y1, x2 - x1)
    scale = min(scale, max(im_h, im_w)) * 1.0
    return center, scale


def bbox_center_scale_eval(bbox_xyxy: np.ndarray, im_h: int, im_w: int):
    """Deterministic eval crop (evaluation/load_data_eval.py:222-228)."""
    x1, y1, x2, y2 = [float(v) for v in bbox_xyxy]
    center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
    scale = min(max(y2 - y1, x2 - x1), max(im_h, im_w)) * 1.0
    return center, scale


def _affine_transform(center, scale: float, output_size: int) -> list:
    """``cv2.getAffineTransform`` of the CenterNet-style source -> destination
    triangle (tools/dataset_utils.py:98-136, rot = 0), bit for bit: the same
    float32 points and cv2's LU solve of the 6 x 6 system in double (partial
    pivoting, row updates ``a += alpha * pivot_row`` with alpha = a_ji ·
    (-1 / a_ii), back substitution ``s / a_ii``).  Returns its 6 entries."""
    c = np.asarray(center, np.float32)
    half = np.float32(scale) * np.float32(-0.5)
    o = np.float32(output_size)
    src = [(c[0], c[1]), (c[0], c[1] + half)]
    dst = [(o * np.float32(0.5), o * np.float32(0.5))]
    dst.append((dst[0][0], dst[0][1] + o * np.float32(-0.5)))
    for pts in (src, dst):  # the third point: b + (-(a - b)_y, (a - b)_x)
        (ax, ay), (bx, by) = pts
        pts.append((bx - (ay - by), by + (ax - bx)))
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        sx, sy = float(src[i][0]), float(src[i][1])
        a[2 * i][:3] = [sx, sy, 1.0]
        a[2 * i + 1][3:] = [sx, sy, 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i][0]), float(dst[i][1])
    for i in range(6):
        k = max(range(i, 6), key=lambda j: (abs(a[j][i]), -j))
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 6):
            alpha = a[j][i] * d
            for kk in range(i + 1, 6):
                a[j][kk] += alpha * a[i][kk]
            b[j] += alpha * b[i]
    for i in range(5, -1, -1):
        acc = b[i]
        for kk in range(i + 1, 6):
            acc -= a[i][kk] * b[kk]
        b[i] = acc / a[i][i]
    return b


def _invert_affine(m: list) -> list:
    """``cv2.invertAffineTransform``'s arithmetic, as ``warpAffine`` runs it."""
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0.0 else 0.0
    i0, i1, i3, i4 = m[4] * d, m[1] * (-d), m[3] * (-d), m[0] * d
    return [i0, i1, -i0 * m[2] - i1 * m[5], i3, i4, -i3 * m[2] - i4 * m[5]]


def fused_crop(depth: np.ndarray, target: np.ndarray, center, scale: float, o: int):
    """The three INTER_NEAREST ``cv2.warpAffine`` crops of one sample
    (tools/dataset_utils.py:80-136, rot = 0), bit for bit as cv2 makes them.

    depth (H, W) uint16 and target (H, W) bool (the instance's mask) give
    roi_depth and roi_mask (o, o) float32; roi_coord (2, o, o) float32 is the
    crop of ``get_2d_coord``'s map.  cv2 maps the destination pixel (x, y)
    through the inverted affine M two ways.  Its single-channel float crops
    take the source pixel round-half-even of fma(M0, x, M1 y + M2) (and of
    fma(M3, x, M4 y + M5)) in float32; its 2-channel coordinate crop takes
    (rint((M1 y + M2) 1024) + 512 + rint(M0 x 1024)) >> 10 in 10-bit fixed
    point (likewise for y).  The two disagree by a pixel where a coordinate
    lies near k + 0.5, in cv2 and here alike (the native C++ library, which
    keeps the closed-form affine, differs from cv2 5.0 at a few of those
    pixels).  Returns (roi_depth, roi_mask, roi_coord,
    #(roi_depth > 0), #(roi_mask > 0 & roi_depth > 0))."""
    h, w = depth.shape
    m = _invert_affine(_affine_transform(center, scale, o))
    pix = np.arange(o, dtype=np.float64)

    # the coordinate map: cv2's fixed-point remap (AB_BITS = 10, nearest)
    x0 = np.rint((m[1] * pix + m[2]) * 1024).astype(np.int64) + 512
    y0 = np.rint((m[4] * pix + m[5]) * 1024).astype(np.int64) + 512
    sx = np.clip((x0[:, None] + np.rint(m[0] * pix * 1024).astype(np.int64)[None, :]) >> 10,
                 -32768, 32767)
    sy = np.clip((y0[:, None] + np.rint(m[3] * pix * 1024).astype(np.int64)[None, :]) >> 10,
                 -32768, 32767)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    roi_coord = np.stack([np.where(inside, sx, 0), np.where(inside, sy, 0)]).astype(np.float32)

    # the float crops: float32 coordinates, fused multiply-add, rounded half
    # to even (float64 holds each fma's exact value at these magnitudes)
    m32 = np.asarray(m, np.float32)
    pix32 = pix.astype(np.float32)

    def coord(a: int) -> np.ndarray:
        row = (m32[a + 1] * pix32 + m32[a + 2]).astype(np.float64)
        fma = (np.float64(m32[a]) * pix[None, :] + row[:, None]).astype(np.float32)
        return np.rint(fma).astype(np.int64)

    sx, sy = coord(0), coord(3)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    rows, cols = np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)
    roi_depth = np.where(inside, depth[rows, cols], 0).astype(np.float32)
    roi_mask = (inside & target[rows, cols]).astype(np.float32)
    pos = roi_depth > 0
    return roi_depth, roi_mask, roi_coord, int(pos.sum()), int((pos & (roi_mask > 0)).sum())


def _shifted(m: np.ndarray, fill: float, dy: int, dx: int) -> np.ndarray:
    """m moved by (dy, dx) >= 0, the uncovered border set to ``fill``."""
    out = np.full_like(m, fill)
    out[dy:, dx:] = m[:m.shape[0] - dy, :m.shape[1] - dx]
    return out


def defor_2d_mask(rng: np.random.Generator, roi_mask: np.ndarray, rand_r: int = 3,
                  rand_pro: float = 0.5) -> np.ndarray:
    """Mask boundary noise (datasets/data_augmentation.defor_2D :9-32): with
    probability ``rand_pro``, randomly keep/drop half of the pixels in the
    erode-dilate boundary band.

    The reference calls ``cv2.erode(mask, kernel, rand_r)`` with the 2x2
    ellipse ``[[0, 1], [1, 1]]``; that third argument is ``dst``, not
    ``iterations``, so it is one erosion and one dilation, each over the
    pixel, the one above and the one to the left (cv2's anchor (1, 1); the
    border takes part in neither).  ``rand_r`` is read for that reason only."""
    roi_mask = np.squeeze(roi_mask.copy())
    if rng.random() > rand_pro:
        return roi_mask
    # cv2 takes a 1-D array (a mask squeezed from one row or column) as a column
    mask = roi_mask.reshape(roi_mask.shape[0], -1)
    mask_erode = np.minimum(np.minimum(_shifted(mask, np.inf, 1, 0),
                                       _shifted(mask, np.inf, 0, 1)), mask)
    mask_dilate = np.maximum(np.maximum(_shifted(mask, -np.inf, 1, 0),
                                        _shifted(mask, -np.inf, 0, 1)), mask)
    band = (mask_erode != mask_dilate).reshape(roi_mask.shape)
    n = int(band.sum())
    if n < 1:
        return roi_mask
    change = np.ones(n, dtype=roi_mask.dtype)
    choose = rng.choice(n, n // 2, replace=False)
    change[choose] = 0.0
    roi_mask[band] = change
    roi_mask[roi_mask > 0.0] = 1.0
    return roi_mask
