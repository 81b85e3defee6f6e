"""ctypes bindings for the native greedy matchers (``native/matcher.cpp``).

Counterpart of ``hspose_tpu/evaluation/native_matcher.py``.  The shared
source in ``native/`` is read, never written: g++ builds it on first use into
``build/hspose_tpu_torch/native/libmatcher.so`` under the repository root
(kept until the source is newer).  Every entry point returns ``None`` when
the toolchain or the library is missing, and the caller then runs the numpy
matchers, which give the same matches.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "matcher.cpp"
_LIB = _REPO_ROOT / "build" / "hspose_tpu_torch" / "native" / "libmatcher.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # a private name, then a rename: another process never loads a torn file
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _SRC.exists() or not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.greedy_iou_matches.argtypes = [dptr, ctypes.c_int, ctypes.c_int, dptr,
                                           ctypes.c_int, dptr, dptr]
        lib.greedy_pose_matches.argtypes = [dptr, ctypes.c_int, ctypes.c_int, dptr,
                                            ctypes.c_int, dptr, ctypes.c_int, dptr,
                                            dptr]
        _lib = lib
        return _lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def greedy_iou_matches_native(overlaps: np.ndarray, thresholds: np.ndarray
                              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    P, G = overlaps.shape
    T = len(thresholds)
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    thr = np.ascontiguousarray(thresholds, np.float64)
    gt_m = np.empty((T, G), np.float64)
    pred_m = np.empty((T, P), np.float64)
    lib.greedy_iou_matches(_as_c(overlaps), P, G, _as_c(thr), T, _as_c(gt_m),
                           _as_c(pred_m))
    return gt_m, pred_m


def greedy_pose_matches_native(errors: np.ndarray, degree_thresholds: Sequence[float],
                               shift_thresholds: Sequence[float]
                               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    P, G = errors.shape[:2]
    deg = np.ascontiguousarray(degree_thresholds, np.float64)
    cm = np.ascontiguousarray(shift_thresholds, np.float64)
    D, S = len(deg), len(cm)
    errors = np.ascontiguousarray(errors, np.float64)
    gt_m = np.empty((D, S, G), np.float64)
    pred_m = np.empty((D, S, P), np.float64)
    lib.greedy_pose_matches(_as_c(errors), P, G, _as_c(deg), D, _as_c(cm), S,
                            _as_c(gt_m), _as_c(pred_m))
    return gt_m, pred_m
