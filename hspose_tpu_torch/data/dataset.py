"""The slice of ``hspose_tpu/data/dataset.py`` the eval dataset reads
(numpy; a copy, since the port cannot import the JAX package): the image
lists, the camera intrinsics, the host back-projection and fixed-size point
sampling (reference ``datasets/load_data.py:40-71, 307-333``), and the
loader's worker count.  The train dataset comes with the training loop
(ROADMAP Queue 1 item 2)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from hspose_tpu_torch.data import native_preproc as npp

CAMERA_INTRINSICS = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]],
                             dtype=np.float32)
REAL_INTRINSICS = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084],
                            [0, 0, 1]], dtype=np.float32)


@dataclass
class SampleLists:
    img_list: List[str]
    subset_len: List[int]


def _read_img_lists(data_dir: str, source: str, mode: str) -> SampleLists:
    """Aggregate the per-source image lists (load_data.py:40-71)."""
    paths = {
        "train": {
            "CAMERA": ["CAMERA/train_list.txt"],
            "Real": ["Real/train_list.txt"],
            "CAMERA+Real": ["CAMERA/train_list.txt", "Real/train_list.txt"],
        },
        "test": {
            "CAMERA": ["CAMERA/val_list.txt"],
            "Real": ["Real/test_list.txt"],
            "CAMERA+Real": ["Real/test_list.txt"],
        },
    }[mode][source]
    img_list: List[str] = []
    subset_len = []
    for p in paths:
        root = p.split("/")[0]
        with open(os.path.join(data_dir, p)) as f:
            img_list += [os.path.join(root, line.rstrip("\n")) for line in f]
        subset_len.append(len(img_list))
    if len(subset_len) == 2:
        subset_len = [subset_len[0], subset_len[1] - subset_len[0]]
    return SampleLists(img_list, subset_len)


def host_depth_to_pcl(roi_depth, cam_k, roi_coord, roi_mask) -> np.ndarray:
    """Host back-projection (load_data.py:322-333), output in mm.

    The native one-pass implementation (native/preproc.cpp::hsp_backproject) is
    bit-exact against this numpy path and used when available; numpy is the
    fallback and the semantics reference."""
    pcl = npp.backproject(roi_depth, cam_k, roi_coord, roi_mask)
    if pcl is not None:
        return pcl
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]
    depth = roi_depth.reshape(-1).astype(np.float64)
    valid = ((depth > 0) * roi_mask.reshape(-1)) > 0
    depth = depth[valid]
    x_map = roi_coord[0].reshape(-1)[valid]
    y_map = roi_coord[1].reshape(-1)[valid]
    real_x = (x_map - cx) * depth / fx
    real_y = (y_map - cy) * depth / fy
    return np.stack((real_x, real_y, depth), axis=-1).astype(np.float32)


def host_sample_points(rng: np.random.Generator, pcl: np.ndarray, n_pts: int):
    """Random down/up-sampling to a fixed count (load_data.py:307-320)."""
    total = pcl.shape[0]
    if total < n_pts:
        pcl = np.concatenate([np.tile(pcl, (n_pts // total, 1)),
                              pcl[:n_pts % total]], axis=0)
    elif total > n_pts:
        ids = rng.permutation(total)[:n_pts]
        pcl = pcl[ids]
    return pcl


def resolve_num_workers(num_workers: int) -> int:
    """``data.num_workers``: -1 sizes the pool as ``os.cpu_count() - 1``
    (one core stays with the main process), at least 1; any other value is
    taken as it is.  (The JAX package's starvation warning against its TPU
    step rate has no counterpart here.)"""
    if num_workers >= 0:
        return num_workers
    return max((os.cpu_count() or 1) - 1, 1)
