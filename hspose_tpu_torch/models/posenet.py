"""PoseNet9D, eval path (counterpart of ``hspose_tpu/models/posenet.py``):
points are centred, go through the backbone, and the rotation and
translation/size heads read the per-point features."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.models.face_recon import FEAT_C, FaceRecon
from hspose_tpu_torch.models.heads import PoseTsHead, RotationHead


class PoseNetOutput(NamedTuple):
    p_green_R: torch.Tensor  # (B, 3) unit green axis
    p_red_R: torch.Tensor    # (B, 3) unit red axis
    f_green_R: torch.Tensor  # (B,) confidence
    f_red_R: torch.Tensor    # (B,) confidence
    pred_T: torch.Tensor     # (B, 3) translation
    pred_s: torch.Tensor     # (B, 3) size residual


class PoseNet9D(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        feat_c = FEAT_C + cfg.obj_c
        self.face_recon = FaceRecon(cfg, device=device)
        self.rot_green = RotationHead(feat_c, device=device)
        self.rot_red = RotationHead(feat_c, device=device)
        self.ts = PoseTsHead(feat_c, device=device)

    def forward(self, points: torch.Tensor, obj_id: torch.Tensor,
                pool_samples: Sequence[torch.Tensor]) -> PoseNetOutput:
        center = points.mean(dim=1, keepdim=True)
        centred = points - center
        feat = self.face_recon(centred, obj_id, pool_samples)

        green_vec = self.rot_green(feat)  # (B, 4)
        red_vec = self.rot_red(feat)
        # the + 1e-6 in the denominators is the reference's, not a clamp
        p_green_R = green_vec[:, 1:] / (torch.linalg.vector_norm(
            green_vec[:, 1:], dim=-1, keepdim=True) + 1e-6)
        p_red_R = red_vec[:, 1:] / (torch.linalg.vector_norm(
            red_vec[:, 1:], dim=-1, keepdim=True) + 1e-6)
        f_green_R = torch.sigmoid(green_vec[:, 0])
        f_red_R = torch.sigmoid(red_vec[:, 0])

        T, s = self.ts(feat, centred)
        return PoseNetOutput(p_green_R, p_red_R, f_green_R, f_red_R,
                             T + center[:, 0, :], s)
