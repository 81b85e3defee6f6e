"""3D bounding-box helpers for the NOCS metrics (vectorized numpy; a copy of
``hspose_tpu/geometry/boxes.py``, which the port cannot import).

The reference computes these one pair at a time inside nested python loops
(``evaluation/eval_utils_v1.py``: ``get_3d_bbox`` :170-199, ``transform_coordinates_3d``
:202-216, ``compute_3d_iou_new`` :35-91, ``compute_RT_degree_cm_symmetry`` :94-167).
Here they are batched over full pred×gt grids — the 20-step y-rotation symmetry sweep
becomes one extra broadcast axis — which is what makes the mAP harness fast without
changing any matching semantics.
"""

from __future__ import annotations

import numpy as np

_CORNER_SIGNS = np.array(
    [[1, 1, 1], [1, 1, -1], [-1, 1, 1], [-1, 1, -1],
     [1, -1, 1], [1, -1, -1], [-1, -1, 1], [-1, -1, -1]], dtype=np.float64)


def get_3d_bbox(scales: np.ndarray) -> np.ndarray:
    """Corners of origin-centred boxes: scales (..., 3) -> (..., 3, 8)."""
    corners = 0.5 * scales[..., None, :] * _CORNER_SIGNS  # (..., 8, 3)
    return np.swapaxes(corners, -1, -2)


def transform_coordinates_3d(coords: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """Apply homogeneous transforms: coords (..., 3, N), RT (..., 4, 4) -> (..., 3, N)."""
    R = RT[..., :3, :3]
    t = RT[..., :3, 3:4]
    w_row = RT[..., 3:4, :3] @ coords + RT[..., 3:4, 3:4]
    return (R @ coords + t) / w_row


def _y_rotation_mats(n: int) -> np.ndarray:
    """(n, 4, 4) homogeneous rotations about y by 2πi/n."""
    theta = 2.0 * np.pi * np.arange(n) / float(n)
    c, s = np.cos(theta), np.sin(theta)
    mats = np.tile(np.eye(4), (n, 1, 1))
    mats[:, 0, 0] = c
    mats[:, 0, 2] = s
    mats[:, 2, 0] = -s
    mats[:, 2, 2] = c
    return mats


def _nocs_box_iou(mins1, maxs1, mins2, maxs2):
    """The NOCS-eval 'IoU' with arbitrary broadcast leading axes; inputs (..., 8).

    NOTE: the reference (evaluation/eval_utils_v1.py:47-62, inherited from the
    NOCS/CASS evaluation scripts) reduces the (3, 8) corner matrix with
    ``np.amax(..., axis=0)`` — i.e. per-CORNER min/max over the x/y/z coordinates,
    then products over the 8 corners — not a geometric axis-aligned box IoU.  Every
    published number in this line of work was produced by that exact computation, so
    we replicate it bit-for-bit (corner order matters and matches get_3d_bbox).
    """
    overlap = np.minimum(maxs1, maxs2) - np.maximum(mins1, mins2)
    inter = np.where(np.min(overlap, axis=-1) < 0, 0.0, np.prod(overlap, axis=-1))
    vol1 = np.prod(maxs1 - mins1, axis=-1)
    vol2 = np.prod(maxs2 - mins2, axis=-1)
    return inter / (vol1 + vol2 - inter)


def pairwise_3d_iou(pred_RTs: np.ndarray, pred_scales: np.ndarray,
                    gt_RTs: np.ndarray, gt_scales: np.ndarray,
                    sym_pair: np.ndarray, n_rot: int = 20) -> np.ndarray:
    """Pairwise 3D box IoU matrix (P, G), with a y-rotation sweep for symmetric pairs.

    Matches ``compute_3d_iou_new`` (evaluation/eval_utils_v1.py:35-91): for pairs
    flagged in ``sym_pair`` (P, G) bool, the *prediction's* RT is swept through
    ``n_rot`` rotations about its own y axis and the maximum IoU is kept; note the
    reference's max starts at 0, so symmetric pairs can never go negative.
    """
    P, G = len(pred_RTs), len(gt_RTs)
    if P == 0 or G == 0:
        return np.zeros((P, G), dtype=np.float64)

    rots = _y_rotation_mats(n_rot)  # (n, 4, 4)
    pred_corners_base = get_3d_bbox(pred_scales)  # (P, 3, 8)
    gt_corners = transform_coordinates_3d(get_3d_bbox(gt_scales), gt_RTs)  # (G, 3, 8)
    # reference reduces over the COORDINATE axis (see _nocs_box_iou): (G, 8)
    gt_min = gt_corners.min(axis=-2)
    gt_max = gt_corners.max(axis=-2)

    swept_RTs = pred_RTs[:, None] @ rots[None]  # (P, n, 4, 4)
    pred_corners = transform_coordinates_3d(pred_corners_base[:, None], swept_RTs)  # (P, n, 3, 8)
    pred_min = pred_corners.min(axis=-2)  # (P, n, 8)
    pred_max = pred_corners.max(axis=-2)

    # (P, n, G)
    ious = _nocs_box_iou(pred_min[:, :, None], pred_max[:, :, None],
                         gt_min[None, None], gt_max[None, None])
    sym_iou = np.maximum(ious.max(axis=1), 0.0)  # max over the rotation sweep
    asym_iou = ious[:, 0, :]  # rotation 0 is the identity
    return np.where(sym_pair, sym_iou, asym_iou)


def pairwise_degree_cm(pred_RTs: np.ndarray, gt_RTs: np.ndarray,
                       y_sym: np.ndarray, clip_cos: bool = False) -> np.ndarray:
    """Pairwise (P, G, 2) [rotation error in degrees, translation error in cm].

    Matches ``compute_RT_degree_cm_symmetry`` (evaluation/eval_utils_v1.py:94-167):
    rotations are first normalized by the cube root of their determinant; pairs whose
    gt class is y-axis symmetric (``y_sym`` (G,) bool — bottle/can/bowl, or mug with
    hidden handle) compare only the transformed y axes; others use the trace formula.

    ``clip_cos=True`` clips the arccos argument to [-1, 1] — the LEGACY metric's
    behaviour (``compute_RT_errors``, evaluation/eval_utils.py:210), where rounding
    past ±1 yields 0°/180° instead of the live metric's NaN.
    """
    P, G = len(pred_RTs), len(gt_RTs)
    out = np.zeros((P, G, 2), dtype=np.float64)
    if P == 0 or G == 0:
        return out

    def _norm_R(RTs):
        R = RTs[:, :3, :3]
        det = np.linalg.det(R)
        return R / np.cbrt(det)[:, None, None]

    R1 = _norm_R(pred_RTs)  # (P, 3, 3)
    R2 = _norm_R(gt_RTs)  # (G, 3, 3)
    T1 = pred_RTs[:, :3, 3]
    T2 = gt_RTs[:, :3, 3]

    # y-axis-only angle
    y1 = R1[:, :, 1]  # (P, 3)
    y2 = R2[:, :, 1]  # (G, 3)
    cos_y = (y1 @ y2.T) / (np.linalg.norm(y1, axis=-1)[:, None] * np.linalg.norm(y2, axis=-1)[None])

    # full-rotation angle from trace(R1 R2ᵀ).  NB: like the reference we do NOT clip
    # the arccos argument — out-of-range values become NaN, and NaN errors compare
    # False against thresholds (i.e. they match), which is reference behaviour.
    traces = np.einsum("pij,gij->pg", R1, R2)
    cos_full = (traces - 1.0) / 2.0
    if clip_cos:
        cos_y = np.clip(cos_y, -1.0, 1.0)
        cos_full = np.clip(cos_full, -1.0, 1.0)
    with np.errstate(invalid="ignore"):
        theta_y = np.arccos(cos_y)
        theta_full = np.arccos(cos_full)

    theta = np.where(y_sym[None, :], theta_y, theta_full)
    out[..., 0] = theta * 180.0 / np.pi
    out[..., 1] = np.linalg.norm(T1[:, None] - T2[None], axis=-1) * 100.0
    return out
