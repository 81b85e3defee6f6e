"""NOCS-style 3D-IoU and degree/cm mAP (vectorized, matching-identical); a copy
of ``hspose_tpu/evaluation/metrics.py``, which the port cannot import.

Re-designed from ``evaluation/eval_utils_v1.py``: the per-pair IoU (with the 20-step
y-rotation symmetry sweep) and degree/cm error grids are computed as whole matrices
(hspose_tpu_torch.geometry.boxes), and the greedy matchers are vectorized over the
threshold axes — per (image, class) the pred→gt assignment loop runs once per pair
instead of once per (pair × threshold).  The matching *semantics* are identical:

* IoU matcher (ref :297-327): preds in descending score order, each takes the
  highest-overlap unmatched gt with IoU strictly greater than the threshold.
* Pose matcher (ref :402-427): preds in order, each takes the unmatched gt with the
  smallest degree+cm sum whose errors do not exceed the thresholds (NaN errors
  compare False against thresholds and therefore match, as in the reference).
* AP (ref :330-356): VOC-style precision envelope over score-ranked matches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from hspose_tpu_torch.geometry.boxes import pairwise_3d_iou, pairwise_degree_cm
from hspose_tpu_torch.geometry.symmetry import IOU_Y_SYMMETRIC


def greedy_iou_matches(overlaps: np.ndarray, iou_thresholds: np.ndarray):
    """Greedy per-threshold matching.

    overlaps: (P, G) IoU matrix with preds already in descending score order.
    Returns (gt_matches (T, G), pred_matches (T, P)) with -1 for unmatched.
    """
    T = len(iou_thresholds)
    P, G = overlaps.shape
    gt_matches = -np.ones((T, G))
    pred_matches = -np.ones((T, P))
    thr = np.asarray(iou_thresholds)[:, None]  # (T, 1)
    for i in range(P):
        order = np.argsort(overlaps[i])[::-1]
        pred_done = np.zeros(T, dtype=bool)
        for j in order:
            eligible = ((overlaps[i, j] > thr[:, 0]) & ~pred_done
                        & (gt_matches[:, j] == -1))
            if eligible.any():
                gt_matches[eligible, j] = i
                pred_matches[eligible, i] = j
                pred_done |= eligible
            if pred_done.all():
                break
    return gt_matches, pred_matches


def greedy_pose_matches(errors: np.ndarray, degree_thresholds: Sequence[float],
                        shift_thresholds: Sequence[float]):
    """Greedy matching over the (degree, shift) threshold grid.

    errors: (P, G, 2) [degrees, cm].  Returns (gt_matches (D, S, G),
    pred_matches (D, S, P)).
    """
    D, S = len(degree_thresholds), len(shift_thresholds)
    P, G = errors.shape[:2]
    gt_matches = -np.ones((D, S, G))
    pred_matches = -np.ones((D, S, P))
    if P == 0 or G == 0:
        return gt_matches, pred_matches
    deg_t = np.asarray(degree_thresholds)[:, None]  # (D, 1)
    cm_t = np.asarray(shift_thresholds)[None, :]  # (1, S)
    with np.errstate(invalid="ignore"):
        sum_err = errors.sum(-1)  # (P, G); NaN sorts last
    for i in range(P):
        order = np.argsort(sum_err[i])
        pred_done = np.zeros((D, S), dtype=bool)
        for j in order:
            # NaN errors: (err > thr) is False -> not excluded (reference :420)
            with np.errstate(invalid="ignore"):
                excluded = (errors[i, j, 0] > deg_t) | (errors[i, j, 1] > cm_t)
            eligible = ~excluded & ~pred_done & (gt_matches[:, :, j] == -1)
            if eligible.any():
                gt_matches[eligible, j] = i
                pred_matches[eligible, i] = j
                pred_done |= eligible
            if pred_done.all():
                break
    return gt_matches, pred_matches


def compute_accuracy_from_matches(gt_match: np.ndarray) -> float:
    """Recall-style accuracy: matched gts / total gts (the legacy NOCS
    ``compute_mAP`` 'acc' output, evaluation/eval_utils.py:296-464)."""
    if len(gt_match) == 0:
        return 0.0
    return float(np.mean(gt_match > -1))


def compute_ap_from_matches_scores(pred_match: np.ndarray, pred_scores: np.ndarray,
                                   gt_match: np.ndarray) -> float:
    """VOC AP (evaluation/eval_utils_v1.py:330-356)."""
    assert pred_match.shape[0] == pred_scores.shape[0]
    order = np.argsort(pred_scores)[::-1]
    pred_match = pred_match[order]

    tp_cum = np.cumsum(pred_match > -1)
    precisions = tp_cum / (np.arange(len(pred_match)) + 1)
    # like the reference, recall divides by len(gt) unguarded: zero gts with
    # predictions present yields NaN AP (eval_utils_v1.py:340)
    with np.errstate(invalid="ignore", divide="ignore"):
        recalls = tp_cum.astype(np.float64) / len(gt_match)

    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    precisions = np.maximum.accumulate(precisions[::-1])[::-1]
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))


def _iou_matches(overlaps, thresholds, use_native):
    if use_native:
        from hspose_tpu_torch.evaluation.native_matcher import greedy_iou_matches_native
        out = greedy_iou_matches_native(overlaps, thresholds)
        if out is not None:
            return out
    return greedy_iou_matches(overlaps, thresholds)


def _pose_matches(errors, degree_thresholds, shift_thresholds, use_native):
    if use_native:
        from hspose_tpu_torch.evaluation.native_matcher import greedy_pose_matches_native
        out = greedy_pose_matches_native(errors, degree_thresholds, shift_thresholds)
        if out is not None:
            return out
    return greedy_pose_matches(errors, degree_thresholds, shift_thresholds)


def compute_degree_cm_mAP(final_results: List[Dict], synset_names: Sequence[str],
                          log_dir: Optional[str] = None,
                          degree_thresholds: Sequence[float] = (360,),
                          shift_thresholds: Sequence[float] = (100,),
                          iou_3d_thresholds: Sequence[float] = (0.1,),
                          iou_pose_thres: float = 0.1,
                          use_matches_for_pose: bool = False,
                          plot_figure: bool = False,
                          use_native: bool = True,
                          eval_recon: bool = False):
    """Accumulate matches over images/classes and compute AP grids.

    Structure mirrors ``compute_degree_cm_mAP`` (eval_utils_v1.py:430-712); returns
    (iou_3d_aps (C+1, T_iou), pose_aps (C+1, D, S)) where index -1 is the mean over
    foreground classes.
    """
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    D, S, T = len(degree_thres_list), len(shift_thres_list), len(iou_thres_list)

    if use_matches_for_pose:
        assert iou_pose_thres in iou_thres_list

    iou_3d_aps = np.zeros((num_classes + 1, T))
    pose_aps = np.zeros((num_classes + 1, D, S))
    iou_acc = np.zeros((num_classes + 1, T))
    pose_acc = np.zeros((num_classes + 1, D, S))

    iou_pred_matches = [[] for _ in range(num_classes)]
    iou_pred_scores = [[] for _ in range(num_classes)]
    iou_gt_matches = [[] for _ in range(num_classes)]
    pose_pred_matches = [[] for _ in range(num_classes)]
    pose_pred_scores = [[] for _ in range(num_classes)]
    pose_gt_matches = [[] for _ in range(num_classes)]

    for result in final_results:
        gt_class_ids = np.asarray(result["gt_class_ids"], np.int32).reshape(-1)
        gt_RTs = np.asarray(result["gt_RTs"], np.float64).reshape(-1, 4, 4) \
            if len(gt_class_ids) else np.zeros((0, 4, 4))
        gt_scales = np.asarray(result["gt_scales"], np.float64).reshape(-1, 3) \
            if len(gt_class_ids) else np.zeros((0, 3))
        gt_handle_visibility = np.asarray(result["gt_handle_visibility"]).reshape(-1)

        pred_class_ids = np.asarray(result["pred_class_ids"], np.int32).reshape(-1)
        pred_scales = np.asarray(result["pred_scales"], np.float64).reshape(-1, 3) \
            if len(pred_class_ids) else np.zeros((0, 3))
        pred_scores = np.asarray(result["pred_scores"], np.float64).reshape(-1)
        pred_RTs = np.asarray(result["pred_RTs"], np.float64).reshape(-1, 4, 4) \
            if len(pred_class_ids) else np.zeros((0, 4, 4))

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            cls_name = synset_names[cls_id]
            g_sel = gt_class_ids == cls_id
            p_sel = pred_class_ids == cls_id
            cls_gt_RTs = gt_RTs[g_sel]
            cls_gt_scales = gt_scales[g_sel]
            cls_pred_RTs = pred_RTs[p_sel]
            cls_pred_scales = pred_scales[p_sel]
            cls_pred_scores = pred_scores[p_sel]

            if cls_name == "mug":
                cls_gt_handle = (gt_handle_visibility[g_sel] if len(gt_class_ids)
                                 else np.ones(0))
            else:
                cls_gt_handle = np.ones(int(g_sel.sum()))

            # sort preds by score, descending (ref compute_3d_matches :269-280)
            order = np.argsort(cls_pred_scores)[::-1]
            cls_pred_RTs = cls_pred_RTs[order]
            cls_pred_scales = cls_pred_scales[order]
            cls_pred_scores = cls_pred_scores[order]

            # (P, G) symmetric-pair flags: bottle/bowl/can always; mug with hidden
            # handle (ref compute_3d_iou_new :69)
            P, G = len(cls_pred_RTs), len(cls_gt_RTs)
            if cls_name in IOU_Y_SYMMETRIC:
                sym_pair = np.ones((P, G), bool)
            elif cls_name == "mug":
                sym_pair = np.broadcast_to((cls_gt_handle == 0)[None, :], (P, G))
            else:
                sym_pair = np.zeros((P, G), bool)

            overlaps = pairwise_3d_iou(cls_pred_RTs, cls_pred_scales, cls_gt_RTs,
                                       cls_gt_scales, sym_pair)
            iou_gt_m, iou_pred_m = _iou_matches(overlaps, np.asarray(iou_thres_list),
                                                use_native)

            iou_pred_matches[cls_id].append(iou_pred_m)
            iou_pred_scores[cls_id].append(np.tile(cls_pred_scores, (T, 1)))
            iou_gt_matches[cls_id].append(iou_gt_m)

            if use_matches_for_pose:
                thres_ind = iou_thres_list.index(iou_pose_thres)
                keep_p = iou_pred_m[thres_ind] > -1
                keep_g = iou_gt_m[thres_ind] > -1
                cls_pred_RTs = cls_pred_RTs[keep_p]
                cls_pred_scores_pose = cls_pred_scores[keep_p]
                cls_gt_RTs_pose = cls_gt_RTs[keep_g]
                cls_gt_handle_pose = cls_gt_handle[keep_g]
            else:
                cls_pred_scores_pose = cls_pred_scores
                cls_gt_RTs_pose = cls_gt_RTs
                cls_gt_handle_pose = cls_gt_handle

            # per-gt y-symmetry flag for the degree metric (ref :140-152)
            if cls_name in ("bottle", "can", "bowl"):
                y_sym = np.ones(len(cls_gt_RTs_pose), bool)
            elif cls_name == "mug":
                y_sym = cls_gt_handle_pose == 0
            else:
                y_sym = np.zeros(len(cls_gt_RTs_pose), bool)

            errors = pairwise_degree_cm(cls_pred_RTs, cls_gt_RTs_pose, y_sym)
            pose_gt_m, pose_pred_m = _pose_matches(errors, degree_thres_list,
                                                   shift_thres_list, use_native)

            pose_pred_matches[cls_id].append(pose_pred_m)
            pose_pred_scores[cls_id].append(
                np.tile(cls_pred_scores_pose, (D, S, 1)))
            pose_gt_matches[cls_id].append(pose_gt_m)

    def _cat(lst, axis):
        return (np.concatenate(lst, axis=axis) if lst else
                np.zeros((0,)))

    for cls_id in range(1, num_classes):
        ipm = (np.concatenate(iou_pred_matches[cls_id], axis=-1)
               if iou_pred_matches[cls_id] else np.zeros((T, 0)))
        ips = (np.concatenate(iou_pred_scores[cls_id], axis=-1)
               if iou_pred_scores[cls_id] else np.zeros((T, 0)))
        igm = (np.concatenate(iou_gt_matches[cls_id], axis=-1)
               if iou_gt_matches[cls_id] else np.zeros((T, 0)))
        for s in range(T):
            iou_3d_aps[cls_id, s] = compute_ap_from_matches_scores(
                ipm[s], ips[s], igm[s])
            iou_acc[cls_id, s] = compute_accuracy_from_matches(igm[s])

        ppm = (np.concatenate(pose_pred_matches[cls_id], axis=-1)
               if pose_pred_matches[cls_id] else np.zeros((D, S, 0)))
        pps = (np.concatenate(pose_pred_scores[cls_id], axis=-1)
               if pose_pred_scores[cls_id] else np.zeros((D, S, 0)))
        pgm = (np.concatenate(pose_gt_matches[cls_id], axis=-1)
               if pose_gt_matches[cls_id] else np.zeros((D, S, 0)))
        for i in range(D):
            for j in range(S):
                pose_aps[cls_id, i, j] = compute_ap_from_matches_scores(
                    ppm[i, j], pps[i, j], pgm[i, j])
                pose_acc[cls_id, i, j] = compute_accuracy_from_matches(pgm[i, j])

    iou_3d_aps[-1] = np.mean(iou_3d_aps[1:-1], axis=0)
    pose_aps[-1] = np.mean(pose_aps[1:-1], axis=0)
    iou_acc[-1] = np.mean(iou_acc[1:-1], axis=0)
    pose_acc[-1] = np.mean(pose_acc[1:-1], axis=0)

    if eval_recon:
        recon_stats = aggregate_recon_metrics(final_results, synset_names)
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            import json
            with open(os.path.join(log_dir, "recon_metrics.json"), "w") as f:
                json.dump(recon_stats, f, indent=2)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        np.savez(os.path.join(log_dir, "mAP_data.npz"), pose_aps=pose_aps,
                 degree_thres_list=degree_thres_list,
                 shift_thres_list=shift_thres_list, iou_thres_list=iou_thres_list,
                 iou_3d_aps=iou_3d_aps, iou_acc=iou_acc, pose_acc=pose_acc)
        if plot_figure:
            plot_map_curves(log_dir, synset_names, iou_3d_aps, pose_aps,
                            iou_thres_list, degree_thres_list, shift_thres_list,
                            use_matches_for_pose)
    return iou_3d_aps, pose_aps


def aggregate_recon_metrics(final_results, synset_names):
    """Per-class chamfer/EMD means over per-instance reconstruction distances.

    Matches the reference's ``eval_recon`` branch (eval_utils_v1.py:672-707):
    results carry 'chamfer_dis_cass' / 'emd_dis_cass' arrays per detection.  Use
    ``hspose_tpu_torch.ops.chamfer.chamfer_distance`` to produce them during inference.
    """
    cmf = {c: [] for c in synset_names}
    emd = {c: [] for c in synset_names}
    for result in final_results:
        pred_class_ids = np.asarray(result.get("pred_class_ids", []))
        if len(pred_class_ids) == 0 or "chamfer_dis_cass" not in result:
            continue
        cd = np.asarray(result["chamfer_dis_cass"])
        ed = np.asarray(result.get("emd_dis_cass", np.zeros_like(cd)))
        for cls_id in range(1, len(synset_names)):
            sel = pred_class_ids == cls_id
            if sel.any():
                cmf[synset_names[cls_id]] += cd[sel].tolist()
                emd[synset_names[cls_id]] += ed[sel].tolist()

    out = {"cmf": {}, "emd": {}}
    for key, store in [("cmf", cmf), ("emd", emd)]:
        vals = {k: float(np.mean(v)) for k, v in store.items() if k != "BG" and v}
        if vals:
            vals["mean"] = float(np.mean(list(vals.values())))
        out[key] = vals
    return out


def plot_map_curves(log_dir, synset_names, iou_3d_aps, pose_aps, iou_thres_list,
                    degree_thres_list, shift_thres_list, use_matches_for_pose):
    """AP-vs-threshold curves (eval_utils_v1.py:577-652)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(30, 10))
    labels = list(synset_names[1:]) + ["mean"]
    ax = plt.subplot(131)
    ax.set_ylim(0, 1)
    ax.set_ylabel("AP")
    ax.set_xlabel("3D IoU thresholds")
    for cls_id in range(1, len(synset_names)):
        ax.plot(iou_thres_list, iou_3d_aps[cls_id], label=synset_names[cls_id])
    ax.plot(iou_thres_list, iou_3d_aps[-1], label="mean")

    ax = plt.subplot(132)
    ax.set_ylim(0, 1)
    ax.set_xlabel("Rotation/degree")
    for cls_id in range(1, len(synset_names)):
        ax.plot(degree_thres_list[:-1], pose_aps[cls_id, :-1, -1],
                label=synset_names[cls_id])
    ax.plot(degree_thres_list[:-1], pose_aps[-1, :-1, -1], label="mean")

    ax = plt.subplot(133)
    ax.set_ylim(0, 1)
    ax.set_xlabel("translation/cm")
    for cls_id in range(1, len(synset_names)):
        ax.plot(shift_thres_list[:-1], pose_aps[cls_id, -1, :-1],
                label=synset_names[cls_id])
    ax.plot(shift_thres_list[:-1], pose_aps[-1, -1, :-1], label="mean")
    ax.legend()

    prefix = "Pose_Only_" if use_matches_for_pose else "Pose_Detection_"
    out = os.path.join(log_dir, prefix + "mAP_{}-{}cm.png".format(
        shift_thres_list[0], shift_thres_list[-2]))
    fig.savefig(out)
    plt.close(fig)
    return out
