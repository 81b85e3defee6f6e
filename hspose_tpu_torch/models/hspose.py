"""Model construction, the serving forward and the train forward with its
losses (counterpart of ``hspose_tpu/models/hspose.py``)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed

from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
from hspose_tpu_torch.data.augment import AugmentDraws, augment_batch, draw_augment
from hspose_tpu_torch.data.preprocess import CROP_KEYS, roi_to_pointcloud
from hspose_tpu_torch.geometry.rotations import get_gt_v
from hspose_tpu_torch.losses import (
    control_loss,
    fs_net_loss,
    geo_transform_loss,
    prop_rot_loss,
    recon_6face_loss,
)
from hspose_tpu_torch.models import graphed
from hspose_tpu_torch.models.heads import KEEP_PROB
from hspose_tpu_torch.models.posenet import PoseNet9D, PoseNetOutput, PoseNetTrainOutput
from hspose_tpu_torch.ops.cuda_knn import MAX_K
from hspose_tpu_torch.ops.sampling import draw_sample_scores
from hspose_tpu_torch.parallel.dp import gather
from hspose_tpu_torch.utils.spans import span

LossDicts = Dict[str, Dict[str, torch.Tensor]]


def _card_unless_asked(device):
    """The device an entry point runs on: the CUDA card unless the caller
    names another; raises when it is the card and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the caller "
                           "asks for another, e.g. device='cpu'")
    return device


def build_model(cfg: ModelConfig, device=None, train_heads: bool = False) -> PoseNet9D:
    """PoseNet9D on ``device`` (the CUDA card unless the caller names
    another), in eval mode; with ``train_heads`` it also has the conv1d,
    recon and face heads that the train forward needs.

    ``compute_dtype`` is ``"float32"`` (the reference semantics) or
    ``"bfloat16"`` (the fast tier, serving and training; parameters stay
    fp32 and are cast at use, as flax's ``param_dtype``, so
    ``load_jax_params`` fills either).
    ``"f32x2"`` worked around the TPU compiler's lack of in-kernel fp32
    products and has no counterpart here.  The fp32 tier must not drift, so
    this turns TF32 off for matrix products and cuDNN process-wide: with
    TF32 on, KNN order and pose geometry drift.

    ``gcn_n_num`` and ``serve_k`` above ``MAX_K`` = 31 raise a ValueError
    here, on any device: the KNN kernel keeps at most 32 = k + 1 entries per
    query, and the port's entry points serve the card."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: only 'float32' and 'bfloat16' are ported")
    for name in ("gcn_n_num", "serve_k"):
        if getattr(cfg, name) > MAX_K:
            raise ValueError(f"{name}={getattr(cfg, name)}: the port's KNN kernel takes "
                             f"k <= MAX_K = {MAX_K}")
    device = _card_unless_asked(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PoseNet9D(cfg, device=device, train_heads=train_heads).eval()


def draw_pool_samples(n: int, generator: torch.Generator | None = None,
                      device=None) -> list[torch.Tensor]:
    """Kept-row indices of the two 4x pools of an n-point cloud: the first
    n // 4 entries of one permutation of n, then of n // 4.  One draw serves
    the whole batch.  The samples lie on ``device``, else on the
    generator's device, else on the CUDA card."""
    if device is None and generator is not None:
        device = generator.device
    device = _card_unless_asked(device)
    samples = []
    for _ in range(2):
        perm = torch.randperm(n, generator=generator, device=device)
        n //= 4
        samples.append(perm[:n])
    return samples


@torch.no_grad()
def eval_forward(model: PoseNet9D, pc: torch.Tensor, obj_id: torch.Tensor,
                 generator: torch.Generator | None = None,
                 pool_samples: Sequence[torch.Tensor] | None = None,
                 with_heads: bool = False,
                 sp_group=None) -> PoseNetOutput | PoseNetTrainOutput:
    """Inference forward: pc (B, N, 3) float32, obj_id (B,) 0-based.

    The pooling permutations are drawn from ``generator`` unless
    ``pool_samples`` gives the kept rows (the counterpart of the JAX
    ``pool_key``; tests pass the same samples to both packages).
    ``with_heads`` also runs the conv1d, recon and face heads in eval mode
    and returns a ``PoseNetTrainOutput`` whose ``recon`` is the world-frame
    cloud, as the JAX ``eval_forward(..., with_heads=True)``; the model
    needs ``build_model(..., train_heads=True)``.

    ``sp_group`` (a process group, ``parallel/mesh.py::make_mesh``) serves
    sequence-parallel, as the JAX ``eval_forward(..., sp_axis=)``: ``pc``
    holds this rank's contiguous shard of the points, the pools' kept rows
    are drawn (or given) over the global cloud of ``pc.shape[1] * sp``
    points, the same on every rank, and the outputs are the same on every
    rank of the group.  None is the one-device forward.

    On the CUDA card, a forward in eval mode on one process, without
    ``with_heads``, on the factored heads is served as one CUDA graph
    replay (``models/graphed.py``), its outputs fresh tensors; every other
    forward runs the module's ops one by one."""
    with span("model.eval_forward"):
        if pool_samples is None:
            sp = 1 if sp_group is None else torch.distributed.get_world_size(sp_group)
            pool_samples = draw_pool_samples(pc.shape[1] * sp, generator, pc.device)
        if graphed.eligible(model, pc, with_heads, sp_group):
            # samples drawn or kept on the host (fast_mode_parity's pool_device="cpu")
            # go up here: inside a capture their pageable copy would raise
            pool_samples = [s.to(pc.device) for s in pool_samples]
            return PoseNetOutput(*graphed.forward(model, pc, obj_id, pool_samples))
        return model(pc, obj_id, pool_samples, with_heads=with_heads, sp_group=sp_group)


class TrainDraws(NamedTuple):
    """The random numbers of one train forward."""

    aug: AugmentDraws
    pool_samples: Sequence[torch.Tensor]  # kept rows of the two pools
    dropout_keep: Sequence[torch.Tensor]  # (B, 256) bool for rot_green, rot_red, ts
    sample_scores: Optional[torch.Tensor] = None  # (B, H·W): device sampling's scores

    def rows(self, rows: slice) -> "TrainDraws":
        """The draws of the batch rows ``rows``: the per-row draws cut, the
        pool samples (shared by the batch) whole."""
        a = self.aug
        scores = self.sample_scores
        return TrainDraws(AugmentDraws(a.flags[:, rows], a.ey_up[rows], a.ey_down[rows],
                                       a.defor[rows]),
                          self.pool_samples, [k[rows] for k in self.dropout_keep],
                          None if scores is None else scores[rows])

    def to(self, device) -> "TrainDraws":
        scores = self.sample_scores
        return TrainDraws(AugmentDraws(*(x.to(device) for x in self.aug)),
                          [x.to(device) for x in self.pool_samples],
                          [x.to(device) for x in self.dropout_keep],
                          None if scores is None else scores.to(device))


def draw_train(generator: torch.Generator, bs: int, n: int,
               crop_pixels: int = 0) -> TrainDraws:
    """Draw a train forward's randomness from ``generator``, on its device.
    A batch of crops (device sampling) also needs the sampling scores of its
    ``crop_pixels`` = H·W pixels a crop; they are drawn last, so the other
    draws are those of a batch of clouds."""
    device = generator.device
    aug = draw_augment(generator, bs, n)
    pools = draw_pool_samples(n, generator, device)
    keep = tuple(torch.rand((bs, 256), generator=generator, device=device) < KEEP_PROB
                 for _ in range(3))
    scores = draw_sample_scores(generator, bs, crop_pixels) if crop_pixels else None
    return TrainDraws(aug, pools, keep, scores)


def compute_losses(cfg: HSPoseConfig, out: PoseNetTrainOutput, pc, gt_R, gt_t, gt_s,
                   mean_shape, sym, obj_id) -> LossDicts:
    """The pred/gt dicts and the four loss families.  The rotation
    confidences are detached where the reference detaches them: for the
    prop, recon and geo families, not for fsnet."""
    name_fs, name_recon, name_geo, name_prop = control_loss(cfg.train.train_stage)

    gt_green, gt_red = get_gt_v(gt_R)
    f_green_det = out.f_green_R.detach()
    f_red_det = out.f_red_R.detach()

    pred_fsnet = {
        "Rot1": out.p_green_R, "Rot1_f": out.f_green_R,
        "Rot2": out.p_red_R, "Rot2_f": out.f_red_R,
        "Recon": out.recon, "Tran": out.pred_T, "Size": out.pred_s,
    }
    gt_fsnet = {"Rot1": gt_green, "Rot2": gt_red, "Recon": pc, "Tran": gt_t,
                "Size": gt_s}
    fsnet = fs_net_loss(cfg.loss, name_fs, pred_fsnet, gt_fsnet, sym)

    pred_prop = {
        "Recon": out.recon, "Rot1": out.p_green_R, "Rot2": out.p_red_R,
        "Tran": out.pred_T, "Scale": out.pred_s,
        "Rot1_f": f_green_det, "Rot2_f": f_red_det,
    }
    gt_prop = {"Points": pc, "R": gt_R, "T": gt_t, "Mean_shape": mean_shape}
    prop = prop_rot_loss(cfg.loss, name_prop, pred_prop, gt_prop, sym)

    pred_recon = {
        "F_n": out.face_normal, "F_d": out.face_dis, "F_c": out.face_f,
        "Rot1": out.p_green_R, "Rot1_f": f_green_det,
        "Rot2": out.p_red_R, "Rot2_f": f_red_det,
        "Tran": out.pred_T, "Size": out.pred_s,
    }
    gt_recon = {"R": gt_R, "T": gt_t, "Size": gt_s, "Mean_shape": mean_shape,
                "Points": pc}
    recon = recon_6face_loss(cfg.loss, name_recon, pred_recon, gt_recon, sym, obj_id)

    pred_geo = {
        "Rot1": out.p_green_R, "Rot2": out.p_red_R, "Tran": out.pred_T,
        "Size": out.pred_s, "Rot1_f": f_green_det, "Rot2_f": f_red_det,
    }
    gt_geo = {"Points": pc, "R": gt_R, "T": gt_t, "Mean_shape": mean_shape}
    geo = geo_transform_loss(cfg.loss, name_geo, pred_geo, gt_geo, sym)

    return {"fsnet_loss": fsnet, "recon_loss": recon, "geo_loss": geo,
            "prop_loss": prop}


def total_loss(loss_dicts: LossDicts) -> torch.Tensor:
    """Sum of all scalar terms."""
    return sum(v for d in loss_dicts.values() for v in d.values())


def train_forward(cfg: HSPoseConfig, model: PoseNet9D, batch: Dict[str, torch.Tensor],
                  generator: torch.Generator | None = None,
                  draws: TrainDraws | None = None,
                  dp_group=None) -> Tuple[torch.Tensor, LossDicts]:
    """One differentiable train forward: augmentation, posenet, losses.

    ``model`` is in train mode and built with ``train_heads``; its BatchNorm
    running statistics update in place.  ``batch`` holds the 12 tensors of
    ``utils/synthetic.py::synthetic_train_batch``; a device-sampled batch
    (``data.sample_mode=device``) holds ``roi_depth``, ``roi_mask``,
    ``roi_coord`` and ``cam_k`` in place of ``pcl_in``, and the cloud of
    ``cfg.data.num_points`` points is sampled here from the crops
    (``data/preprocess.py::roi_to_pointcloud``), on the batch's device.  The
    randomness comes from ``draws`` when given, else from ``generator``.
    Returns (total loss, loss dicts).

    ``dp_group`` (``parallel/mesh.py::make_mesh``) trains data-parallel:
    ``batch`` holds this rank's rows of a global batch, rank r of the group
    the r-th equal part.  The draws are the global batch's (``draws``, or
    drawn from ``generator`` at the global batch size, the same on every
    rank), and this rank keeps its rows of them; the model's BatchNorm
    layers take their statistics over the group (``parallel/mp.py::
    distribute``); the loss inputs are gathered over the group
    (``parallel/dp.py::gather``), so that every rank computes the losses of
    the global batch, those of the one-process forward on it, and each
    rank's backward gives its rows' share of the gradient."""
    crops = "pcl_in" not in batch
    bs = batch["cat_id"].shape[0]
    n = cfg.data.num_points if crops else batch["pcl_in"].shape[1]
    world, rank = ((1, 0) if dp_group is None else
                   (torch.distributed.get_world_size(dp_group),
                    torch.distributed.get_rank(dp_group)))
    if draws is None:
        if generator is None:
            raise ValueError("train_forward needs a generator or the draws")
        draws = draw_train(generator, bs * world, n,
                           batch["roi_depth"][0].numel() if crops else 0)
    if dp_group is not None:
        draws = draws.rows(slice(rank * bs, (rank + 1) * bs))
    if crops:
        if draws.sample_scores is None:
            raise ValueError("a batch of crops needs draws with sample_scores")
        pc, _ = roi_to_pointcloud(draws.sample_scores, *(batch[k] for k in CROP_KEYS), n)
    else:
        pc = batch["pcl_in"]
    obj_id = batch["cat_id"].to(torch.int32)
    aug = augment_batch(
        cfg.aug, pc.detach(), batch["rotation"], batch["translation"],
        batch["fsnet_scale"], batch["mean_shape"], batch["sym_info"], batch["aug_bb"],
        batch["aug_rt_t"], batch["aug_rt_R"], batch["model_point"], batch["nocs_scale"],
        obj_id, draws.aug)
    out = model(aug.pc, obj_id, draws.pool_samples, draws.dropout_keep)
    targets = (aug.pc, aug.gt_R, aug.gt_t, aug.gt_s, batch["mean_shape"], batch["sym_info"],
               obj_id)
    if dp_group is not None:
        out = PoseNetTrainOutput(*gather(out, dp_group))
        targets = gather(targets, dp_group)
    loss_dicts = compute_losses(cfg, out, *targets)
    return total_loss(loss_dicts), loss_dicts
