"""ctypes bindings for the native host-preprocessing library (native/preproc.cpp).

A copy of ``hspose_tpu/data/native_preproc.py``, which the port cannot
import, that builds the shared source, read and never written, into its own
``build/hspose_tpu_torch/native/libpreproc.so`` under the repository root.

The C++ side fuses what the cv2 path does in five steps (depth-PNG decode,
mask-PNG decode, three INTER_NEAREST ``warpAffine`` crops — reference
``tools/dataset_utils.py:80-136`` / ``tools/eval_utils.py:143-156``) into one
pass that computes each output pixel's source coordinate once.  Its affine is
closed-form, where cv2 5.0 LU-solves ``getAffineTransform``, so at a few
half-pixel source coordinates its crops differ from cv2's and from the numpy
path's (``tests/test_torch_port_train_data.py`` holds this library to the JAX
native path and the numpy path to the JAX cv2 path).

Auto-builds ``libpreproc.so`` with g++ on first use (cached); every entry point
returns ``None`` when the toolchain/library/libpng is missing, so callers fall
back to the numpy path of ``data/image_utils.py`` (the same decoded images;
crops as above) — the native library is never a requirement.  The card's
machine has no libpng, so there the numpy path runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "preproc.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "hspose_tpu_torch", "native", "libpreproc.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)
_f64p = ctypes.POINTER(ctypes.c_double)


def _build() -> bool:
    # Compile to a private temp file and os.replace() it into place: loader
    # worker PROCESSES share _LIB's path and the in-process _lock cannot
    # serialize them, but rename is atomic so a concurrent reader either sees
    # the old complete .so or the new complete .so — never a torn write.
    import tempfile
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC,
                        "-lpng", "-lz", "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.hsp_png_dims.argtypes = [ctypes.c_char_p, _i32p, _i32p]
        lib.hsp_decode_depth.argtypes = [ctypes.c_char_p, _u16p, ctypes.c_long,
                                         _i32p, _i32p]
        lib.hsp_train_sample.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, _f32p, _f32p, _f32p, _i32p]
        lib.hsp_eval_crops.argtypes = [
            _u16p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int, _i32p,
            ctypes.c_int, _f64p, _f64p, ctypes.c_int, _f32p, _f32p, _f32p, _i32p,
            ctypes.c_int]
        lib.hsp_backproject.argtypes = [
            _f32p, _f32p, _f32p, _f32p, ctypes.c_long, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, _f32p, _i32p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def png_dims(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) from the PNG header, without decoding pixels."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.hsp_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_depth(path: str) -> Optional[np.ndarray]:
    """NOCS depth decode (uint16 (H, W); RGB-encoded 256*G+R with 32001->0),
    matching ``image_utils.load_depth``.  None on any failure."""
    lib = get_lib()
    if lib is None:
        return None
    dims = png_dims(path)
    if dims is None:
        return None
    out = np.empty(dims, np.uint16)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.hsp_decode_depth(path.encode(), _ptr(out, ctypes.c_uint16), out.size,
                              ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return out


def train_sample(depth_path: str, mask_path: str, inst_id: int, center,
                 scale: float, out_size: int):
    """Fused decode+crop for one training sample.

    Returns (roi_depth (o,o) f32, roi_mask (o,o) f32, roi_coord (2,o,o) f32,
    n_depth_pos, n_mask_and_depth) or None on any failure (caller falls back
    to the numpy path, which owns the retry semantics)."""
    lib = get_lib()
    if lib is None:
        return None
    o = int(out_size)
    roi_depth = np.empty((o, o), np.float32)
    roi_mask = np.empty((o, o), np.float32)
    roi_coord = np.empty((2, o, o), np.float32)
    counts = np.zeros(2, np.int32)
    rc = lib.hsp_train_sample(
        depth_path.encode(), mask_path.encode(), int(inst_id),
        float(center[0]), float(center[1]), float(scale), o,
        _ptr(roi_depth, ctypes.c_float), _ptr(roi_mask, ctypes.c_float),
        _ptr(roi_coord, ctypes.c_float), _ptr(counts, ctypes.c_int))
    if rc != 0:
        return None
    return roi_depth, roi_mask, roi_coord, int(counts[0]), int(counts[1])


def backproject(roi_depth: np.ndarray, cam_k: np.ndarray, roi_coord: np.ndarray,
                roi_mask: np.ndarray) -> Optional[np.ndarray]:
    """Masked depth back-projection, bit-exact vs the numpy implementation
    (``data.dataset.host_depth_to_pcl`` — f32 coordinate subtract, f64
    multiply/divide, f32 output; reference load_data.py:322-333).  Returns the
    (n, 3) f32 point cloud in mm, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    roi_depth = np.ascontiguousarray(roi_depth, np.float32)
    roi_mask = np.ascontiguousarray(roi_mask, np.float32)
    roi_coord = np.ascontiguousarray(roi_coord, np.float32)
    if roi_mask.shape != roi_depth.shape or roi_coord.shape != (2,) + roi_depth.shape:
        return None
    out = np.empty((roi_depth.size, 3), np.float32)
    count = ctypes.c_int()
    lib.hsp_backproject(
        _ptr(roi_depth, ctypes.c_float), _ptr(roi_mask, ctypes.c_float),
        _ptr(roi_coord[0], ctypes.c_float), _ptr(roi_coord[1], ctypes.c_float),
        roi_depth.size, float(cam_k[0, 0]), float(cam_k[1, 1]),
        float(cam_k[0, 2]), float(cam_k[1, 2]),
        _ptr(out, ctypes.c_float), ctypes.byref(count))
    return out[:count.value]


def eval_crops(depth: np.ndarray, masks: np.ndarray, inst_cols, centers, scales,
               out_size: int, n_threads: Optional[int] = None):
    """Fused crops for the eval harness: one decoded depth image, the
    (H, W, n_inst) bool/uint8 detection-mask stack, one crop per entry of
    ``inst_cols`` (mask column indices).  Threaded across crops.

    Returns (roi_depths (n,o,o), roi_masks (n,o,o), roi_coords (n,2,o,o),
    counts (n,2) int32) or None when the native library is unavailable or the
    mask dtype is unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    if masks.dtype == np.bool_:
        masks = masks.view(np.uint8)
    if masks.dtype != np.uint8 or masks.ndim != 3:
        return None
    masks = np.ascontiguousarray(masks)
    depth = np.ascontiguousarray(depth, np.uint16)
    h, w, n_inst = masks.shape
    if depth.shape != (h, w):  # incoherent inputs: let the numpy path decide
        return None
    n = len(inst_cols)
    o = int(out_size)
    cols = np.ascontiguousarray(inst_cols, np.int32)
    ctr = np.ascontiguousarray(centers, np.float64).reshape(n, 2)
    scl = np.ascontiguousarray(scales, np.float64)
    roi_depths = np.empty((n, o, o), np.float32)
    roi_masks = np.empty((n, o, o), np.float32)
    roi_coords = np.empty((n, 2, o, o), np.float32)
    counts = np.zeros((n, 2), np.int32)
    if n == 0:
        return roi_depths, roi_masks, roi_coords, counts
    nt = n_threads if n_threads is not None else min(n, os.cpu_count() or 1)
    rc = lib.hsp_eval_crops(
        _ptr(depth, ctypes.c_uint16), h, w, _ptr(masks, ctypes.c_uint8), n_inst,
        _ptr(cols, ctypes.c_int), n, _ptr(ctr, ctypes.c_double),
        _ptr(scl, ctypes.c_double), o, _ptr(roi_depths, ctypes.c_float),
        _ptr(roi_masks, ctypes.c_float), _ptr(roi_coords, ctypes.c_float),
        _ptr(counts, ctypes.c_int), int(nt))
    if rc != 0:
        return None
    return roi_depths, roi_masks, roi_coords, counts
