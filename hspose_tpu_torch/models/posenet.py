"""PoseNet9D (counterpart of ``hspose_tpu/models/posenet.py``): points are
centred, go through the backbone, and the rotation and translation/size heads
read the per-point features.  In train mode, and in eval mode with
``with_heads``, the recon cloud is moved back by the centre and the 30-d face
tensor splits into unit normals (18), distances (6) and sigmoid confidences
(6).  With an sp group (sequence-parallel serving) ``points`` is this rank's
shard: the centring mean finishes as the mean over the group
(hspose_tpu/models/posenet.py:50-51), the heads' max-pools as the max, and
every output comes out the same on all of its ranks."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.models.face_recon import FEAT_C, FaceRecon, compute_dtype
from hspose_tpu_torch.models.graphed import Graphs
from hspose_tpu_torch.models.heads import FirstLayers, PoseTsHead, RotationHead
from hspose_tpu_torch.parallel.sp import mean_over_shards


class PoseNetOutput(NamedTuple):
    p_green_R: torch.Tensor  # (B, 3) unit green axis
    p_red_R: torch.Tensor    # (B, 3) unit red axis
    f_green_R: torch.Tensor  # (B,) confidence
    f_red_R: torch.Tensor    # (B,) confidence
    pred_T: torch.Tensor     # (B, 3) translation
    pred_s: torch.Tensor     # (B, 3) size residual


class PoseNetTrainOutput(NamedTuple):
    recon: torch.Tensor        # (B, N, 3) world-frame recon
    face_normal: torch.Tensor  # (B, N, 6, 3) unit normals
    face_dis: torch.Tensor     # (B, N, 6) distances
    face_f: torch.Tensor       # (B, N, 6) confidences
    p_green_R: torch.Tensor
    p_red_R: torch.Tensor
    f_green_R: torch.Tensor
    f_red_R: torch.Tensor
    pred_T: torch.Tensor
    pred_s: torch.Tensor


class PoseNet9D(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, train_heads: bool = False):
        super().__init__()
        feat_c = FEAT_C + cfg.obj_c
        dt = compute_dtype(cfg)
        self.face_recon = FaceRecon(cfg, device=device, train_heads=train_heads)
        self.rot_green = RotationHead(feat_c, device=device, dtype=dt)
        self.rot_red = RotationHead(feat_c, device=device, dtype=dt)
        self.ts = PoseTsHead(feat_c, device=device, dtype=dt)
        self.first_layers = FirstLayers(tuple(head.vec for head in self.pose_heads()))
        self.graphs = Graphs()  # the served forward's last CUDA graph (models/graphed.py)

    def pose_heads(self) -> tuple[nn.Module, ...]:
        return self.rot_green, self.rot_red, self.ts

    def factored(self) -> bool:
        """Whether the forward serves the pose heads' first block per backbone
        resolution (``heads.py::FirstLayers``): in eval mode without
        gradients and with no head layer sharded over mp; ``with_heads`` and
        an sp group too.  Otherwise every head multiplies the concatenated
        feature (``VecHead.forward``): training, gradients (the backward of
        the per-resolution gather would be a scatter-add) and mp, whose
        head layers form their own output columns."""
        return not (self.training or torch.is_grad_enabled()
                    or any(getattr(m, "mp_group", None) is not None
                           for head in self.pose_heads() for m in head.modules()))

    def forward(self, points: torch.Tensor, obj_id: torch.Tensor,
                pool_samples: Sequence[torch.Tensor],
                dropout_keep: Sequence[torch.Tensor] | None = None,
                with_heads: bool = False, sp_group=None):
        """PoseNetOutput in eval mode, PoseNetTrainOutput in train mode or
        with ``with_heads`` (the heads then run in eval mode: running
        BatchNorm statistics, no dropout).  ``dropout_keep``: the keep-masks
        of rot_green, rot_red and ts (train mode; drawn when None).
        ``sp_group``: sequence-parallel serving (module docstring)."""
        keep = dropout_keep if dropout_keep is not None else (None, None, None)
        # equal shards: the mean of the shard means is the mean
        center = mean_over_shards(points.mean(dim=1, keepdim=True), sp_group)
        centred = points - center
        heads = self.training or with_heads
        if self.factored():
            maps = self.face_recon.maps(centred, pool_samples, sp_group)
            if with_heads:
                recon, face, _ = self.face_recon(centred, obj_id, pool_samples, with_heads,
                                                 sp_group, maps)
            h = self.first_layers(maps, obj_id, centred)
            green_vec, red_vec, ts_vec = (head.vec.tail(x, sp_group=sp_group)
                                          for head, x in zip(self.pose_heads(), h))
            T, s = ts_vec[:, 0:3], ts_vec[:, 3:6]
        else:
            if heads:
                recon, face, feat = self.face_recon(centred, obj_id, pool_samples, with_heads,
                                                    sp_group)
            else:
                feat = self.face_recon(centred, obj_id, pool_samples, sp_group=sp_group)
            green_vec = self.rot_green(feat, keep[0], sp_group)  # (B, 4)
            red_vec = self.rot_red(feat, keep[1], sp_group)
            # the bf16 tier feeds the centred points to the Ts head in bf16
            # (hspose_tpu/models/posenet.py:82-83)
            T, s = self.ts(feat, centred.to(feat.dtype), keep[2], sp_group)
        # the + 1e-6 in the denominators is the reference's, not a clamp
        p_green_R = green_vec[:, 1:] / (torch.linalg.vector_norm(
            green_vec[:, 1:], dim=-1, keepdim=True) + 1e-6)
        p_red_R = red_vec[:, 1:] / (torch.linalg.vector_norm(
            red_vec[:, 1:], dim=-1, keepdim=True) + 1e-6)
        f_green_R = torch.sigmoid(green_vec[:, 0])
        f_red_R = torch.sigmoid(red_vec[:, 0])
        pose = (p_green_R, p_red_R, f_green_R, f_red_R, T + center[:, 0, :], s)
        if not heads:
            return PoseNetOutput(*pose)
        B, N = points.shape[:2]
        face_normal = face[..., :18].reshape(B, N, 6, 3)
        face_normal = face_normal / torch.linalg.vector_norm(face_normal, dim=-1,
                                                             keepdim=True)  # no clamp
        return PoseNetTrainOutput(recon + center, face_normal, face[..., 18:24],
                                  torch.sigmoid(face[..., 24:]), *pose)
