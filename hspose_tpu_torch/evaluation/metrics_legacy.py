"""Legacy buffered NOCS mAP (``compute_mAP``), vectorized; a copy of
``hspose_tpu/evaluation/metrics_legacy.py`` (numpy only) on the port's own
``metrics.py``, ``geometry/boxes.py`` and ``geometry/symmetry.py``.

The reference carries TWO metric stacks: the live ``eval_utils_v1.compute_degree_cm_mAP``
(rebuilt matching-identical in :mod:`hspose_tpu_torch.evaluation.metrics`) and the older
NOCS-CVPR2019-style ``eval_utils.compute_mAP`` (evaluation/eval_utils.py:296-464),
dormant at runtime but part of the public surface.  This module rebuilds the legacy
variant on the same vectorized pair grids and greedy matchers.  Semantic differences
from the live metric, all preserved here:

* the rotation error clips the arccos argument to [-1, 1]
  (``compute_RT_errors``, eval_utils.py:210) — the live metric lets it go NaN;
* each threshold cell reports BOTH ap and a PRECISION-style accuracy
  (matched predictions / total predictions, ``compute_ap_and_acc`` :291) — the
  live harness's acc is recall-style (matched gts / total gts);
* the synset table is hardcoded and a ``cls_ids`` subset can be evaluated, with
  the mean row dividing by ``len(cls_ids)`` (zeros/NaNs for unevaluated classes
  bleed into the mean exactly as in the reference, :437-450);
* returns ``(iou_aps, pose_aps, iou_acc, pose_acc)`` with shape
  ``(num_classes + 1, ...)`` and writes ``mAP_Acc.pkl``.

Matching itself (greedy score-ordered IoU / degree+shift assignment) is identical
between the two reference stacks, so the vectorized matchers are shared.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from hspose_tpu_torch.evaluation.metrics import (
    _iou_matches,
    _pose_matches,
    compute_ap_from_matches_scores,
)
from hspose_tpu_torch.geometry.boxes import pairwise_3d_iou, pairwise_degree_cm
from hspose_tpu_torch.geometry.symmetry import IOU_Y_SYMMETRIC

LEGACY_SYNSET_NAMES = ("BG", "bottle", "bowl", "camera", "can", "laptop", "mug")


def compute_ap_and_acc(pred_matches: np.ndarray, pred_scores: np.ndarray,
                       gt_matches: np.ndarray):
    """AP + precision-style accuracy (eval_utils.py:271-293).

    The AP math is shared with the live metric; acc here is matched preds over
    total preds (NaN when there are no predictions, as in the reference's 0/0).
    """
    ap = compute_ap_from_matches_scores(pred_matches, pred_scores, gt_matches)
    acc = (np.sum(pred_matches > -1) / len(pred_matches)
           if len(pred_matches) else np.nan)
    return ap, float(acc)


def compute_mAP(pred_results: List[Dict], out_dir: Optional[str] = None,
                degree_thresholds: Sequence[float] = (180,),
                shift_thresholds: Sequence[float] = (100,),
                iou_3d_thresholds: Sequence[float] = (0.1,),
                iou_pose_thres: float = 0.1,
                use_matches_for_pose: bool = False,
                cls_ids: Optional[Sequence[int]] = None,
                use_native: bool = True):
    """Legacy buffered mAP (eval_utils.py:296-464).

    Returns ``(iou_aps, pose_aps, iou_acc, pose_acc)``; writes ``mAP_Acc.pkl``
    into ``out_dir`` when given (the reference requires the directory; here it
    is optional).
    """
    synset_names = LEGACY_SYNSET_NAMES
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    D, S, T = len(degree_thres_list), len(shift_thres_list), len(iou_thres_list)
    if cls_ids is None:
        cls_ids = range(1, num_classes)
    cls_ids = list(cls_ids)

    if use_matches_for_pose:
        assert iou_pose_thres in iou_thres_list

    iou_aps = np.zeros((num_classes + 1, T))
    iou_acc = np.zeros((num_classes + 1, T))
    pose_aps = np.zeros((num_classes + 1, D, S))
    pose_acc = np.zeros((num_classes + 1, D, S))

    iou_pred_matches = [[] for _ in range(num_classes)]
    iou_pred_scores = [[] for _ in range(num_classes)]
    iou_gt_matches = [[] for _ in range(num_classes)]
    pose_pred_matches = [[] for _ in range(num_classes)]
    pose_pred_scores = [[] for _ in range(num_classes)]
    pose_gt_matches = [[] for _ in range(num_classes)]

    for result in pred_results:
        gt_class_ids = np.asarray(result["gt_class_ids"], np.int32).reshape(-1)
        gt_RTs = np.asarray(result["gt_RTs"], np.float64).reshape(-1, 4, 4) \
            if len(gt_class_ids) else np.zeros((0, 4, 4))
        gt_scales = np.asarray(result["gt_scales"], np.float64).reshape(-1, 3) \
            if len(gt_class_ids) else np.zeros((0, 3))
        gt_handle_visibility = np.asarray(result["gt_handle_visibility"]).reshape(-1)

        pred_class_ids = np.asarray(result["pred_class_ids"], np.int32).reshape(-1)
        pred_RTs = np.asarray(result["pred_RTs"], np.float64).reshape(-1, 4, 4) \
            if len(pred_class_ids) else np.zeros((0, 4, 4))
        pred_scales = np.asarray(result["pred_scales"], np.float64).reshape(-1, 3) \
            if len(pred_class_ids) else np.zeros((0, 3))
        pred_scores = np.asarray(result["pred_scores"], np.float64).reshape(-1)

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in cls_ids:
            cls_name = synset_names[cls_id]
            g_sel = gt_class_ids == cls_id
            p_sel = pred_class_ids == cls_id
            cls_gt_RTs = gt_RTs[g_sel]
            cls_gt_scales = gt_scales[g_sel]
            cls_pred_RTs = pred_RTs[p_sel]
            cls_pred_scales = pred_scales[p_sel]
            cls_pred_scores = pred_scores[p_sel]

            # non-mug classes force handle visibility to 1 (eval_utils.py:357-360)
            if cls_name == "mug":
                cls_gt_handle = (gt_handle_visibility[g_sel] if len(gt_class_ids)
                                 else np.ones(0))
            else:
                cls_gt_handle = np.ones(int(g_sel.sum()))

            # score-descending prediction order (compute_IoU_matches :131-136)
            order = np.argsort(cls_pred_scores)[::-1]
            cls_pred_RTs = cls_pred_RTs[order]
            cls_pred_scales = cls_pred_scales[order]
            cls_pred_scores = cls_pred_scores[order]

            P, G = len(cls_pred_RTs), len(cls_gt_RTs)
            if cls_name in IOU_Y_SYMMETRIC:
                sym_pair = np.ones((P, G), bool)
            elif cls_name == "mug":
                sym_pair = np.broadcast_to((cls_gt_handle == 0)[None, :], (P, G))
            else:
                sym_pair = np.zeros((P, G), bool)

            overlaps = pairwise_3d_iou(cls_pred_RTs, cls_pred_scales, cls_gt_RTs,
                                       cls_gt_scales, sym_pair)
            iou_gt_m, iou_pred_m = _iou_matches(overlaps,
                                                np.asarray(iou_thres_list),
                                                use_native)
            iou_pred_matches[cls_id].append(iou_pred_m)
            iou_pred_scores[cls_id].append(np.tile(cls_pred_scores, (T, 1)))
            iou_gt_matches[cls_id].append(iou_gt_m)

            if use_matches_for_pose:
                thres_ind = iou_thres_list.index(iou_pose_thres)
                keep_p = iou_pred_m[thres_ind] > -1
                keep_g = iou_gt_m[thres_ind] > -1
                cls_pred_RTs = cls_pred_RTs[keep_p]
                cls_pred_scores = cls_pred_scores[keep_p]
                cls_gt_RTs = cls_gt_RTs[keep_g]
                cls_gt_handle = cls_gt_handle[keep_g]

            # per-gt y-symmetry for the degree metric (compute_RT_errors :200-205)
            if cls_name in ("bottle", "can", "bowl"):
                y_sym = np.ones(len(cls_gt_RTs), bool)
            elif cls_name == "mug":
                y_sym = cls_gt_handle == 0
            else:
                y_sym = np.zeros(len(cls_gt_RTs), bool)

            errors = pairwise_degree_cm(cls_pred_RTs, cls_gt_RTs, y_sym,
                                        clip_cos=True)
            pose_gt_m, pose_pred_m = _pose_matches(errors, degree_thres_list,
                                                   shift_thres_list, use_native)
            pose_pred_matches[cls_id].append(pose_pred_m)
            pose_pred_scores[cls_id].append(np.tile(cls_pred_scores, (D, S, 1)))
            pose_gt_matches[cls_id].append(pose_gt_m)

    # IoU aps/acc run over ALL foreground classes, but the trim loop only covers
    # cls_ids (eval_utils.py:421-436): classes OUTSIDE cls_ids keep their full
    # preallocated 30000-zero buffers, where every "match" index 0 counts as
    # matched — an artifact ap 1.0 / acc 1.0 that bleeds into the mean row.
    # Faithfully replicated (published code path).
    for cls_id in range(1, num_classes):
        if cls_id not in cls_ids:
            iou_aps[cls_id], iou_acc[cls_id] = 1.0, 1.0
            continue
        ipm = (np.concatenate(iou_pred_matches[cls_id], axis=-1)
               if iou_pred_matches[cls_id] else np.zeros((T, 0)))
        ips = (np.concatenate(iou_pred_scores[cls_id], axis=-1)
               if iou_pred_scores[cls_id] else np.zeros((T, 0)))
        igm = (np.concatenate(iou_gt_matches[cls_id], axis=-1)
               if iou_gt_matches[cls_id] else np.zeros((T, 0)))
        for s in range(T):
            iou_aps[cls_id, s], iou_acc[cls_id, s] = compute_ap_and_acc(
                ipm[s], ips[s], igm[s])
    iou_aps[-1] = np.sum(iou_aps[1:-1], axis=0) / len(cls_ids)
    iou_acc[-1] = np.sum(iou_acc[1:-1], axis=0) / len(cls_ids)

    for cls_id in cls_ids:
        ppm = (np.concatenate(pose_pred_matches[cls_id], axis=-1)
               if pose_pred_matches[cls_id] else np.zeros((D, S, 0)))
        pps = (np.concatenate(pose_pred_scores[cls_id], axis=-1)
               if pose_pred_scores[cls_id] else np.zeros((D, S, 0)))
        pgm = (np.concatenate(pose_gt_matches[cls_id], axis=-1)
               if pose_gt_matches[cls_id] else np.zeros((D, S, 0)))
        for i in range(D):
            for j in range(S):
                pose_aps[cls_id, i, j], pose_acc[cls_id, i, j] = \
                    compute_ap_and_acc(ppm[i, j], pps[i, j], pgm[i, j])
    pose_aps[-1] = np.sum(pose_aps[1:-1], axis=0) / len(cls_ids)
    pose_acc[-1] = np.sum(pose_acc[1:-1], axis=0) / len(cls_ids)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        result_dict = {
            "iou_thres_list": iou_thres_list,
            "degree_thres_list": degree_thres_list,
            "shift_thres_list": shift_thres_list,
            "iou_aps": iou_aps,
            "pose_aps": pose_aps,
            "iou_acc": iou_acc,
            "pose_acc": pose_acc,
        }
        with open(os.path.join(out_dir, "mAP_Acc.pkl"), "wb") as f:
            pickle.dump(result_dict, f)
    return iou_aps, pose_aps, iou_acc, pose_acc
