"""Configuration of the port: only the fields its slices read.

Defaults are copied from ``hspose_tpu/config.py`` (``ModelConfig``, the
``DataConfig`` fields the train loader and the eval harness read, the
``EvalConfig`` fields the harness reads, ``AugConfig``, ``LossConfig``,
``OptimConfig``, the ``TrainConfig`` fields the train loop, the step and the
harness read, and ``ParallelConfig``'s axis sizes: the harness serves dp and
sp over a process group, ``mp`` and the one-device train loop refuse them
above 1), leaving out the fields that neither
package reads, except ``data.sample_method`` and ``train.resume_point``: the
JAX package reads neither, and they are kept only so that its command lines
parse here unchanged.  ``compute_dtype`` is ``"float32"`` or ``"bfloat16"``;
``"f32x2"`` raises where the model is built, and so does a ``gcn_n_num`` or
``serve_k`` above 31 (``MAX_K``, the most the KNN kernel keeps).
``parse_overrides`` reads the CLI's ``section.key=value`` arguments as the
JAX package's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths and the host input pipelines of the train loop and the
    eval harness."""

    dataset: str = "Real"  # 'CAMERA', 'Real', or 'CAMERA+Real'
    dataset_dir: str = "./data/NOCS"
    detection_dir: str = "./data/segmentation_results"
    per_obj: str = ""
    # dynamic zoom-in crop augmentation (reference config/config.py:13-16)
    dzi_pad_scale: float = 1.5
    dzi_type: str = "uniform"
    dzi_scale_ratio: float = 0.25
    dzi_shift_ratio: float = 0.25
    img_size: int = 256  # cropped square ROI resolution
    # 2D mask noise (reference config/config.py:22-23)
    roi_mask_r: int = 3
    roi_mask_pro: float = 0.5
    num_points: int = 1028  # points per crop
    sample_method: str = "basic"  # not read: kept so JAX command lines parse
    # 'host' only: back-projection and sampling per crop in the loader
    # workers; 'device' is ROADMAP Queue 1 item 4
    sample_mode: str = "host"
    # -1 sizes the loader's worker pool from the host's cores
    # (data/dataset.py::resolve_num_workers)
    num_workers: int = -1
    prefetch: int = 4  # batches in flight beyond one per worker
    # fused C++ decode + crop (native/preproc.cpp, needs libpng) where the
    # library builds and loads, else the numpy path of data/image_utils.py.
    # Both decode losslessly, but their crops can differ at half-pixel source
    # coordinates (closed-form affine in C++, cv2 5.0's LU solve in numpy), so
    # the batch stream depends on the path: data/dataset.py::decode_path names
    # it, and the train loop logs it and writes it into each checkpoint
    native_preproc: bool = True


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
    seed: int = -1  # -1: the time; a resumed run takes its checkpoint's
    batch_size: int = 16
    total_epoch: int = 150
    train_steps: int = 1500
    accumulate: int = 1  # micro-batches per optimizer step (optax.MultiSteps)
    save_every: int = 10  # epochs between checkpoints (and the last epoch)
    log_every: int = 100  # steps between metric records
    # checkpoints, metrics and logs of the train loop; the harness's outputs
    model_save: str = "output/models"
    resume: bool = False  # the loop restores train.resume_model
    # a training checkpoint (engine/checkpoint.py) to resume or to evaluate,
    # or a reference .pth for the harness
    resume_model: str = ""
    resume_point: int = 0  # not read: kept so JAX command lines parse
    # per-family finite flags in the step's metrics (``finite/<family>``); the
    # loop also turns on autograd's anomaly detection and stops at the first
    # non-finite family
    debug_nan: bool = False


@dataclass(frozen=True)
class EvalConfig:
    eval_seed: int = -1  # -1: the time; seeds the point sampling and the pooling
    eval_inference_only: bool = False
    eval_batch: int = 24  # detection crops per padded batch, across images
    # 'host' only: back-projection and sampling per crop on the host
    sample_mode: str = "host"
    # per-detection chamfer and Sinkhorn-EMD between the recon head's cloud
    # and the observed points (needs the train heads in the weights)
    recon: bool = False
    emd_epsilon: float = 0.005
    emd_iters: int = 200


@dataclass(frozen=True)
class ParallelConfig:
    """The (dp, sp) or (dp, mp) layout of the processes, one per GPU
    (``parallel/mesh.py``): training on (dp, mp), the eval harness on
    either."""

    dp: int = -1  # -1: every process not on the sp or mp axis on the data axis
    # model (tensor) parallelism: the output channels of every Dense layer
    # at least 256 wide that divides by mp sharded over mp ranks, in training
    # and in the eval harness (parallel/mp.py); not with sp
    mp: int = 1
    # sequence (point-axis) parallelism for serving at large N: each crop's
    # points shard over sp ranks (parallel/sp.py); needs num_points % (16*sp)
    # == 0; not with mp; eval only
    sp: int = 1


@dataclass(frozen=True)
class HSPoseConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    aug: AugConfig = field(default_factory=AugConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "HSPoseConfig":
        return dataclasses.replace(self, **kw)


def _apply_dotted(cfg: HSPoseConfig, dotted: str, value: str) -> HSPoseConfig:
    """Apply one 'section.key=value' override, typed by the field's default."""
    section_name, _, key = dotted.partition(".")
    if not key:
        raise ValueError(f"override '{dotted}' must look like section.key")
    section = getattr(cfg, section_name)
    old = getattr(section, key)
    if isinstance(old, bool):
        new = value.lower() in ("1", "true", "yes")
    elif isinstance(old, int):
        new = int(value)
    elif isinstance(old, float):
        new = float(value)
    elif isinstance(old, tuple):
        new = tuple(type(old[0])(v) for v in value.split(","))
    else:
        new = value
    return dataclasses.replace(cfg, **{section_name: dataclasses.replace(section, **{key: new})})


def format_help(cfg: Optional[HSPoseConfig] = None) -> str:
    """Every section.key with its type and default."""
    cfg = cfg or HSPoseConfig()
    lines = ["Overrides take the form section.key=value (a leading -- is allowed).", ""]
    for f in dataclasses.fields(cfg):
        section = getattr(cfg, f.name)
        lines.append(f"[{f.name}]")
        for sf in dataclasses.fields(section):
            default = getattr(section, sf.name)
            lines.append(f"  {f.name}.{sf.name}={default!r}  ({type(default).__name__})")
        lines.append("")
    return "\n".join(lines)


def parse_overrides(argv, cfg: Optional[HSPoseConfig] = None) -> HSPoseConfig:
    """Parse CLI arguments ``section.key=value`` (or ``--section.key=value``);
    ``--help`` / ``-h`` prints every field and exits."""
    cfg = cfg or HSPoseConfig()
    for arg in argv:
        arg = arg.lstrip("-")
        if arg in ("help", "h"):
            print(format_help(cfg))
            raise SystemExit(0)
        if "=" not in arg:
            raise ValueError(f"unrecognized argument '{arg}' (expected section.key=value)")
        dotted, _, value = arg.partition("=")
        cfg = _apply_dotted(cfg, dotted, value)
    return cfg
