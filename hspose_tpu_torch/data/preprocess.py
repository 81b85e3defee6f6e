"""Device sampling: 256² depth crops to fixed-size point clouds on the
model's device (counterpart of ``hspose_tpu/data/preprocess.py``).

With ``data.sample_mode=device`` (the train loop) or ``eval.sample_mode=
device`` (the eval harness) the host ships each crop's depth, mask, pixel
coordinates and intrinsics, and the train step or the harness forward
back-projects and samples the batch here, on the card, before the model
(the JAX package's fused preprocessing).  Batched tensor code with no loop
over the batch; the only selection is the stable sort of
``ops/sampling.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from hspose_tpu_torch.ops.sampling import batched_sample_points

# XLA turns the JAX package's ``/ 1000.0`` into a multiply by the fp32
# reciprocal; a true division differs by up to an ulp (6e-8 m), so the port
# multiplies by the same constant and its clouds keep JAX's bits
MM_TO_M = float(np.float32(1e-3))

# a device-sampled batch's crops, in roi_to_pointcloud's argument order
CROP_KEYS = ("roi_depth", "roi_mask", "roi_coord", "cam_k")


def backproject_roi(depth: torch.Tensor, mask: torch.Tensor, coord2d: torch.Tensor,
                    cam_k: torch.Tensor):
    """Pinhole back-projection of crops.

    depth (..., H, W) in mm; mask (..., H, W); coord2d (..., 2, H, W), the
    crop's pixel coordinates in the original image; cam_k (..., 3, 3).
    Returns (points (..., H·W, 3) in mm, valid (..., H·W) bool): valid =
    depth > 0 and mask > 0, x = (u - cx) · z / fx, y = (v - cy) · z / fy, in
    fp32 (``hspose_tpu/data/preprocess.py::backproject_roi``)."""
    fx, fy = cam_k[..., 0, 0, None], cam_k[..., 1, 1, None]
    cx, cy = cam_k[..., 0, 2, None], cam_k[..., 1, 2, None]
    z = depth.flatten(-2).float()
    valid = (z > 0) & (mask.flatten(-2) > 0)
    u = coord2d[..., 0, :, :].flatten(-2)
    v = coord2d[..., 1, :, :].flatten(-2)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return torch.stack([x, y, z], dim=-1), valid


def roi_to_pointcloud(scores: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor,
                      coord2d: torch.Tensor, cam_k: torch.Tensor, n_pts: int):
    """A batch of crops to clouds: scores (B, H·W) uniform [0, 1) fp32
    draws (``ops/sampling.py::draw_sample_scores``), depth (B, H, W) mm,
    mask (B, H, W), coord2d (B, 2, H, W), cam_k (B, 3, 3).  Returns (pcl
    (B, n_pts, 3) in metres, n_valid (B,) int32).

    A crop with fewer valid points than ``n_pts`` tiles them, and one with
    none samples its invalid points, as the JAX package does; the reference's
    rule of at least 50 points is the caller's, from n_valid."""
    pts, valid = backproject_roi(depth, mask, coord2d, cam_k)
    pcl = batched_sample_points(scores, pts, valid, n_pts) * MM_TO_M
    return pcl, valid.sum(-1, dtype=torch.int32)
