"""The eval harness of the port (counterpart of ``hspose_tpu/evaluation``):
``evaluate.py`` (batched inference on one GPU or, under ``torchrun``, over
``parallel.dp`` / ``parallel.sp`` ranks; the CLI), ``eval_dataset.py``,
``metrics.py`` and the native matchers, the legacy mAP ``metrics_legacy.py``
and the drawing helpers ``visualize.py``."""

from hspose_tpu_torch.evaluation.metrics import (
    compute_ap_from_matches_scores,
    compute_degree_cm_mAP,
    greedy_iou_matches,
    greedy_pose_matches,
)
from hspose_tpu_torch.evaluation.metrics_legacy import compute_mAP

__all__ = [
    "compute_ap_from_matches_scores", "compute_degree_cm_mAP", "compute_mAP",
    "greedy_iou_matches", "greedy_pose_matches",
]
