"""Pose heads (counterpart of ``hspose_tpu/models/heads.py``): two rotation
heads (1286 -> 1024 -> 256 | max over points | 256 -> 256 -> 4) and the
translation/size head (1289 -> ... -> 6), channel-last.  In train mode each
head applies dropout 0.2 after its third block, with an injected keep-mask
when one is given."""

from __future__ import annotations

import torch
from torch import nn

from hspose_tpu_torch.models.face_recon import _bn, batch_norm

KEEP_PROB = 1.0 - 0.2  # dropout 0.2 after bn3


class VecHead(nn.Module):
    """Shared architecture of the three heads.  With ``xyz`` given, the first
    layer's (Cx + 3, 1024) weight runs as a split product
    x @ W[:Cx] + xyz @ W[Cx:] + b instead of on a materialised concat."""

    def __init__(self, in_c: int, out_c: int, device=None):
        super().__init__()
        self.conv1 = nn.Linear(in_c, 1024, device=device)
        self.bn1 = _bn(1024, device)
        self.conv2 = nn.Linear(1024, 256, device=device)
        self.bn2 = _bn(256, device)
        self.conv3 = nn.Linear(256, 256, device=device)
        self.bn3 = _bn(256, device)
        self.conv4 = nn.Linear(256, out_c, device=device)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, N, C) per-point features -> (B, out_c).  ``keep`` (B, 256)
        bool is the dropout keep-mask in train mode (drawn from torch's
        global generator when None)."""
        if xyz is None:
            h = self.conv1(x)
        else:
            w = self.conv1.weight  # (1024, Cx + 3)
            cx = x.shape[-1]
            h = x @ w[:, :cx].t() + xyz @ w[:, cx:].t() + self.conv1.bias
        h = torch.relu(batch_norm(self.bn1, h))
        h = torch.relu(batch_norm(self.bn2, self.conv2(h)))
        h = h.amax(dim=1, keepdim=True)  # global max over points (B, 1, 256)
        h = torch.relu(batch_norm(self.bn3, self.conv3(h)))[:, 0, :]
        if self.training:
            if keep is None:
                keep = torch.rand(h.shape, device=h.device) < KEEP_PROB
            h = torch.where(keep, h / KEEP_PROB, 0.0)
        return self.conv4(h)


class RotationHead(nn.Module):
    """Rot_green / Rot_red: a 4-vector [confidence, axis(3)]."""

    def __init__(self, in_c: int, device=None):
        super().__init__()
        self.vec = VecHead(in_c, 4, device=device)

    def forward(self, feat: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        return self.vec(feat, keep=keep)


class PoseTsHead(nn.Module):
    """Pose_Ts: translation residual (3) and size residual (3), from the
    per-point features and the centred points."""

    def __init__(self, in_c: int, device=None):
        super().__init__()
        self.vec = VecHead(in_c + 3, 6, device=device)

    def forward(self, feat: torch.Tensor, xyz: torch.Tensor,
                keep: torch.Tensor | None = None):
        x = self.vec(feat, xyz, keep)
        return x[:, 0:3], x[:, 3:6]
