"""Result visualization: pose-box overlays and the compact mAP figure; a copy
of ``hspose_tpu/evaluation/visualize.py``.  cv2 and matplotlib are imported
inside the functions that draw, so the train and eval paths, which import
this package, never load them (the card's machine has no matplotlib).

Equivalents of the legacy NOCS helpers in ``evaluation/eval_utils.py`` —
``plot_mAP`` (:467-514), ``calculate_2d_projections`` (:517-530),
``align_rotation`` (:533-552), ``draw_bboxes`` (:555-569) and
``draw_detections`` (:572-613) — numpy/cv2 only, no torch.  The corner order of
``geometry.boxes.get_3d_bbox`` matches the edge index lists the reference draws
with (top layer y+, ground layer y−).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from hspose_tpu_torch.geometry.boxes import get_3d_bbox, transform_coordinates_3d

# classes whose y-rotation ambiguity is aligned away before drawing
# (evaluation/eval_utils.py:583,591,601: bottle, bowl, can)
_ALIGN_CLASS_IDS = (1, 2, 4)


def calculate_2d_projections(coordinates_3d: np.ndarray,
                             intrinsics: np.ndarray) -> np.ndarray:
    """Project (3, N) camera-frame points to integer pixels (N, 2)
    (eval_utils.py:517-530)."""
    projected = intrinsics @ coordinates_3d
    projected = (projected[:2] / projected[2]).T
    return projected.astype(np.int32)


def align_rotation(sRT: np.ndarray) -> np.ndarray:
    """Rotate a scaled pose about y so its x-axis lies in the camera xz-plane —
    canonicalizes the free rotation of axis-symmetric objects for display
    (eval_utils.py:533-552)."""
    s = np.cbrt(np.linalg.det(sRT[:3, :3]))
    R = sRT[:3, :3] / s
    T = sRT[:3, 3]
    theta_x = R[0, 0] + R[2, 2]
    theta_y = R[0, 2] - R[2, 0]
    r_norm = np.sqrt(theta_x ** 2 + theta_y ** 2)
    s_map = np.array([[theta_x / r_norm, 0.0, -theta_y / r_norm],
                      [0.0, 1.0, 0.0],
                      [theta_y / r_norm, 0.0, theta_x / r_norm]])
    aligned = np.identity(4, dtype=np.float32)
    aligned[:3, :3] = s * (R @ s_map)
    aligned[:3, 3] = T
    return aligned


def draw_bboxes(img: np.ndarray, img_pts: np.ndarray, color) -> np.ndarray:
    """Wireframe box: ground layer dark, pillars mid, top layer full color
    (eval_utils.py:555-569)."""
    import cv2

    img_pts = np.int32(img_pts).reshape(-1, 2)
    ground = tuple(int(c * 0.3) for c in color)
    pillar = tuple(int(c * 0.6) for c in color)
    for i, j in zip([4, 5, 6, 7], [5, 7, 4, 6]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), ground, 2)
    for i, j in zip(range(4), range(4, 8)):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), pillar, 2)
    for i, j in zip([0, 1, 2, 3], [1, 3, 0, 2]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), color, 2)
    return img


def _draw_set(img, sRTs, sizes, class_ids, intrinsics, color):
    for i in range(sRTs.shape[0]):
        sRT = (align_rotation(sRTs[i]) if class_ids[i] in _ALIGN_CLASS_IDS
               else sRTs[i])
        corners = get_3d_bbox(np.asarray(sizes[i]))  # (3, 8)
        cam = transform_coordinates_3d(corners, sRT)
        img = draw_bboxes(img, calculate_2d_projections(cam, intrinsics), color)
    return img


def draw_detections(img: np.ndarray, out_dir: str, data_name: str, img_id,
                    intrinsics: np.ndarray, pred_sRT, pred_size, pred_class_ids,
                    gt_sRT=None, gt_size=None, gt_class_ids=None,
                    nocs_sRT=None, nocs_size=None, nocs_class_ids=None,
                    draw_gt: bool = True, draw_nocs: bool = False) -> str:
    """Overlay predicted (red) / GT (green) / NOCS (blue) boxes on ``img`` and
    write ``{data_name}_{img_id}_pred.png`` (eval_utils.py:572-613).  Returns
    the output path."""
    import cv2

    out_path = os.path.join(out_dir, f"{data_name}_{img_id}_pred.png")
    if draw_nocs and nocs_sRT is not None:
        img = _draw_set(img, nocs_sRT, nocs_size, nocs_class_ids, intrinsics,
                        (255, 0, 0))
    if draw_gt and gt_sRT is not None:
        img = _draw_set(img, gt_sRT, gt_size, gt_class_ids, intrinsics,
                        (0, 255, 0))
    img = _draw_set(img, pred_sRT, pred_size, pred_class_ids, intrinsics,
                    (0, 0, 255))
    cv2.imwrite(out_path, img)
    return out_path


def plot_mAP(iou_aps: np.ndarray, pose_aps: np.ndarray, out_dir: str,
             iou_thres_list: Sequence[float], degree_thres_list: Sequence[float],
             shift_thres_list: Sequence[float],
             labels: Optional[Sequence[str]] = None) -> str:
    """The compact paper-style 3-panel AP figure (eval_utils.py:467-514):
    IoU / rotation / translation AP curves per class + mean.  Returns the path
    of the written ``mAP.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if labels is None:
        labels = ["bottle", "bowl", "camera", "can", "laptop", "mug", "mean",
                  "nocs"]
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:pink", "tab:olive",
              "tab:purple", "tab:red", "tab:gray"]
    styles = ["-", "-", "-", "-", "-", "-", "--", ":"]

    fig, (ax_iou, ax_deg, ax_shift) = plt.subplots(1, 3, figsize=(8, 3.5))
    ax_iou.set_title("3D IoU", fontsize=10)
    ax_iou.set_ylabel("Average Precision")
    ax_iou.set_ylim(0, 100)
    ax_iou.set_xlabel("Percent")
    ax_iou.set_xlim(0, 100)
    ax_iou.xaxis.set_ticks([0, 25, 50, 75, 100])
    ax_iou.grid()
    for i in range(1, iou_aps.shape[0]):
        ax_iou.plot(100 * np.asarray(iou_thres_list), 100 * iou_aps[i],
                    color=colors[(i - 1) % len(colors)],
                    linestyle=styles[(i - 1) % len(styles)],
                    label=labels[(i - 1) % len(labels)])

    ax_deg.set_title("Rotation", fontsize=10)
    ax_deg.set_ylim(0, 100)
    ax_deg.yaxis.set_ticklabels([])
    ax_deg.set_xlabel("Degree")
    ax_deg.set_xlim(0, 60)
    ax_deg.xaxis.set_ticks([0, 20, 40, 60])
    ax_deg.grid()
    for i in range(1, pose_aps.shape[0]):
        ax_deg.plot(np.asarray(degree_thres_list),
                    100 * pose_aps[i, :len(degree_thres_list), -1],
                    color=colors[(i - 1) % len(colors)],
                    linestyle=styles[(i - 1) % len(styles)],
                    label=labels[(i - 1) % len(labels)])

    ax_shift.set_title("Translation", fontsize=10)
    ax_shift.set_ylim(0, 100)
    ax_shift.yaxis.set_ticklabels([])
    ax_shift.set_xlabel("Centimeter")
    ax_shift.set_xlim(0, 10)
    ax_shift.xaxis.set_ticks([0, 5, 10])
    ax_shift.grid()
    for i in range(1, pose_aps.shape[0]):
        ax_shift.plot(np.asarray(shift_thres_list),
                      100 * pose_aps[i, -1, :len(shift_thres_list)],
                      color=colors[(i - 1) % len(colors)],
                      linestyle=styles[(i - 1) % len(styles)],
                      label=labels[(i - 1) % len(labels)])
    ax_shift.legend(loc="lower right", fontsize="small")
    plt.tight_layout()
    out_path = os.path.join(out_dir, "mAP.png")
    plt.savefig(out_path)
    plt.close(fig)
    return out_path
