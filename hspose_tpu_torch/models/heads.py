"""Pose heads (counterpart of ``hspose_tpu/models/heads.py``): two rotation
heads (1286 -> 1024 -> 256 | max over points | 256 -> 256 -> 4) and the
translation/size head (1289 -> ... -> 6), channel-last.  In train mode each
head applies dropout 0.2 after its third block, with an injected keep-mask
when one is given.  With ``dtype=torch.bfloat16`` (the bf16 tier) the
products, BatchNorm and dropout run in bf16 and the output is cast to fp32,
as the JAX heads with ``dtype=bfloat16`` (hspose_tpu/models/heads.py:39-94).
With an sp group (sequence-parallel serving) each rank holds a shard of the
points, and the max-pool over points finishes as the max over the group
(heads.py:83-84).  Under mp (``parallel/mp.py``) conv1, conv2 and conv3
form their own output columns and gather the rest."""

from __future__ import annotations

import torch
from torch import nn

from hspose_tpu_torch.models.face_recon import _bn, batch_norm
from hspose_tpu_torch.models.layers import dense
from hspose_tpu_torch.parallel.mp import columns
from hspose_tpu_torch.parallel.sp import max_over_shards

KEEP_PROB = 1.0 - 0.2  # dropout 0.2 after bn3


class VecHead(nn.Module):
    """Shared architecture of the three heads.  With ``xyz`` given, the first
    layer's (Cx + 3, 1024) weight runs as a split product
    x @ W[:Cx] + xyz @ W[Cx:] + b instead of on a materialised concat."""

    def __init__(self, in_c: int, out_c: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Linear(in_c, 1024, device=device)
        self.bn1 = _bn(1024, device)
        self.conv2 = nn.Linear(1024, 256, device=device)
        self.bn2 = _bn(256, device)
        self.conv3 = nn.Linear(256, 256, device=device)
        self.bn3 = _bn(256, device)
        self.conv4 = nn.Linear(256, out_c, device=device)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor | None = None,
                keep: torch.Tensor | None = None, sp_group=None) -> torch.Tensor:
        """x (B, N, C) per-point features -> (B, out_c).  ``keep`` (B, 256)
        bool is the dropout keep-mask in train mode (drawn from torch's
        global generator when None)."""
        dt = self.dtype
        if xyz is None:
            h = dense(self.conv1, x, dt)
        else:
            w = self.conv1.weight.to(dt)  # (1024, Cx + 3), or this rank's rows under mp
            cx = x.shape[-1]
            h = columns(self.conv1, lambda a, b: (a @ w[:, :cx].t() + b @ w[:, cx:].t()
                                                  + self.conv1.bias.to(dt)),
                        x.to(dt), xyz.to(dt))
        h = torch.relu(batch_norm(self.bn1, h))
        h = torch.relu(batch_norm(self.bn2, dense(self.conv2, h, dt)))
        h = h.amax(dim=1, keepdim=True)  # global max over points (B, 1, 256)
        h = max_over_shards(h, sp_group)
        h = torch.relu(batch_norm(self.bn3, dense(self.conv3, h, dt)))[:, 0, :]
        if self.training:
            if keep is None:
                keep = torch.rand(h.shape, device=h.device) < KEEP_PROB
            # flax divides by the keep probability in h's dtype: 0.8 is
            # 0.80078125 in bf16 (and 0.8 again in fp32)
            h = torch.where(keep, h / torch.tensor(KEEP_PROB, dtype=h.dtype).item(), 0.0)
        return dense(self.conv4, h, dt).float()


class RotationHead(nn.Module):
    """Rot_green / Rot_red: a 4-vector [confidence, axis(3)]."""

    def __init__(self, in_c: int, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vec = VecHead(in_c, 4, device=device, dtype=dtype)

    def forward(self, feat: torch.Tensor, keep: torch.Tensor | None = None,
                sp_group=None) -> torch.Tensor:
        return self.vec(feat, keep=keep, sp_group=sp_group)


class PoseTsHead(nn.Module):
    """Pose_Ts: translation residual (3) and size residual (3), from the
    per-point features and the centred points."""

    def __init__(self, in_c: int, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vec = VecHead(in_c + 3, 6, device=device, dtype=dtype)

    def forward(self, feat: torch.Tensor, xyz: torch.Tensor,
                keep: torch.Tensor | None = None, sp_group=None):
        x = self.vec(feat, xyz, keep, sp_group)
        return x[:, 0:3], x[:, 3:6]
