"""Configuration of the port: only the fields its slices read.

Defaults are copied from ``hspose_tpu/config.py`` (``ModelConfig``,
``DataConfig.num_points``, ``AugConfig``, ``LossConfig``, ``OptimConfig`` and
the ``TrainConfig`` fields the train step reads), leaving out the fields that
neither package reads.  ``compute_dtype`` is ``"float32"`` or ``"bfloat16"``;
``"f32x2"`` raises where the model is built, and so does a ``gcn_n_num`` or
``serve_k`` above 31 (``MAX_K``, the most the KNN kernel keeps).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    gcn_sup_num: int = 7  # support directions per HS layer
    gcn_n_num: int = 20  # neighbours per receptive field
    obj_c: int = 6  # object categories (one-hot width)
    face_recon_c: int = 30  # 6*3 normals + 6 distances + 6 confidences
    compute_dtype: str = "float32"
    # relaxed-KNN serving tier: overrides k at inference (0 = gcn_n_num); the
    # pooled-resolution rules min(k, n//8) still apply; training keeps gcn_n_num
    serve_k: int = 0
    num_points: int = 1028  # points per crop
    # training only, both tiers: the support reductions keep the winner's
    # theta and projection for the backward (True, K13) or recompute them
    # there (False, K14)
    bwd_store: bool = True
    # training only, both tiers: the HS layers at N <= 512 (conv_2 .. conv_4)
    # and their ORL branches train through the fused ops' backwards (K8, K10)
    train_v4_small: bool = False


@dataclass(frozen=True)
class AugConfig:
    """Probabilities of the four batched augmentations."""

    pc_pro: float = 0.2
    pc_r: float = 0.2
    rt_pro: float = 0.3
    bb_pro: float = 0.3
    bc_pro: float = 0.3  # box-cage, only bowl & mug


@dataclass(frozen=True)
class LossConfig:
    fsnet_loss_type: str = "l1"  # 'l1' or 'smoothl1'

    rot_1_w: float = 8.0
    rot_2_w: float = 8.0
    rot_regular: float = 4.0
    tran_w: float = 8.0
    size_w: float = 8.0
    recon_w: float = 8.0
    r_con_w: float = 1.0

    recon_n_w: float = 3.0
    recon_d_w: float = 3.0
    recon_v_w: float = 1.0
    recon_f_w: float = 1.0
    recon_bb_r_w: float = 1.0
    recon_bb_t_w: float = 1.0
    recon_bb_s_w: float = 1.0
    recon_bb_self_w: float = 1.0

    geo_p_w: float = 1.0

    prop_pm_w: float = 2.0
    prop_sym_w: float = 1.0
    prop_r_reg_w: float = 1.0


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    lr_pose: float = 1.0
    lr_scheduler_name: str = "flat_and_anneal"
    anneal_method: str = "cosine"
    anneal_point: float = 0.72
    weight_decay: float = 0.0
    warmup_factor: float = 0.001
    warmup_iters: int = 1000
    warmup_method: str = "linear"
    gamma: float = 0.1
    poly_power: float = 0.9
    rel_steps: Tuple[float, float] = (2.0 / 3.0, 8.0 / 9.0)  # WarmupMultiStepLR milestones
    betas: Tuple[float, float] = (0.95, 0.999)
    eps: float = 1e-5
    n_sma_threshold: int = 5
    lookahead_k: int = 6
    lookahead_alpha: float = 0.5
    use_gc: bool = True
    clip_grad_norm: float = 5.0


@dataclass(frozen=True)
class TrainConfig:
    train_stage: str = "PoseNet_only"
    batch_size: int = 16
    total_epoch: int = 150
    train_steps: int = 1500
    accumulate: int = 1  # micro-batches per optimizer step (optax.MultiSteps)
    # per-family finite flags in the step's metrics (``finite/<family>``)
    debug_nan: bool = False


@dataclass(frozen=True)
class HSPoseConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    aug: AugConfig = field(default_factory=AugConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "HSPoseConfig":
        return dataclasses.replace(self, **kw)
