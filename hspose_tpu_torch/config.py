"""Model configuration of the port: only the fields the serving forward reads.

Defaults are copied from ``hspose_tpu/config.py`` (``ModelConfig`` and
``DataConfig.num_points``).  ``compute_dtype`` other than ``"float32"`` is not
ported yet and raises where the model is built.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    gcn_sup_num: int = 7  # support directions per HS layer
    gcn_n_num: int = 20  # neighbours per receptive field
    obj_c: int = 6  # object categories (one-hot width)
    compute_dtype: str = "float32"
    # relaxed-KNN serving tier: overrides k at inference (0 = gcn_n_num); the
    # pooled-resolution rules min(k, n//8) still apply
    serve_k: int = 0
    num_points: int = 1028  # points per crop
