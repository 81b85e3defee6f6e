"""FaceRecon backbone and its train-only heads (counterpart of
``hspose_tpu/models/face_recon.py``).

Five HS layers at N, N//4 and N//16 points with two 4x pools, BatchNorm
(eps 1e-5) and ReLU between them, 1-NN upsampling of the pooled maps, and the
per-point feature
[fm_0 128 | fm_1 128 | fm_2 256 | fm_3 256 | fm_4 512 | one-hot obj_c].
Per forward: nine KNN searches, one surface and four support reductions,
and five ORL branches.  A model built with ``train_heads`` also has the
conv1d, recon and face heads; in train mode the forward returns
(recon, face, feat) from them, in eval mode feat alone.

``compute_dtype="bfloat16"`` serves and trains in bf16 as the JAX
package's fast tier does: bf16 features and one-hot between the layers,
BatchNorm rounded to bf16, all nine searches by packed keys, the 1-NN
upsample still exact in fp32 on the vertices.  The train heads have no
dtype in the JAX package, so flax promotes their bf16 input against the
fp32 parameters: here they take it widened to fp32 and run in fp32, their
BatchNorm too.

``bwd_store`` and ``train_v4_small`` reach conv_1 .. conv_4, as
hspose_tpu/models/face_recon.py:146-202 passes them, in both tiers.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.models.layers import (
    HSLayer,
    HSLayerSurface,
    pool_layer,
    receptive_field_indices as knn,
)
from hspose_tpu_torch.ops.knn import gather_neighbors, nearest_index

FEAT_C = 128 + 128 + 256 + 256 + 512  # backbone channels before the one-hot


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d over the channel axis of a channel-last (..., C) tensor.

    In train mode it is flax's BatchNorm: the batch variance is
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance, whose rounding the
    gradients then carry), x is normalised as (x - mean) * (rsqrt(var + eps)
    * scale) + bias, and the running statistics move by the momentum with
    this *biased* variance (torch's own update takes the unbiased one, which
    at the heads' B rows after the max-pool is B/(B-1) too large).

    bf16 x in train mode is flax's BatchNorm(dtype=bf16) (flax
    _compute_stats, _normalize): the statistics come from x widened to fp32,
    y is formed in fp32 and rounded to bf16 once."""
    x2 = x.reshape(-1, x.shape[-1])
    if not bn.training and x.dtype == torch.bfloat16:
        # flax's BatchNorm(dtype=bf16) in eval mode (hspose_tpu/models/
        # face_recon.py:31-34, flax _normalize): bf16 x against the fp32
        # running statistics promotes to fp32, and the result rounds once
        y = (x2.float() - bn.running_mean) * (torch.rsqrt(bn.running_var + bn.eps)
                                              * bn.weight) + bn.bias
        return y.to(torch.bfloat16).reshape(x.shape)
    if not bn.training:
        return bn(x2).reshape(x.shape)
    xf = x2.float()
    mean = xf.mean(0)
    var = torch.clamp((xf * xf).mean(0) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return y.to(x.dtype).reshape(x.shape)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The tier's activation type; parameters are fp32 in both."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _bn(channels: int, device) -> nn.BatchNorm1d:
    # torch defaults, as the JAX package sets them: eps 1e-5, momentum 0.1
    return nn.BatchNorm1d(channels, eps=1e-5, momentum=0.1, device=device)


class MLPHead(nn.Module):
    """Stack of Linear -> BN -> ReLU blocks with a final projection, named
    as the flax ``MLPHead`` (``dense_i``, ``bn_i``, ``dense_out``, ``bn_out``).
    ``final_act`` puts BN and ReLU on the output layer too."""

    def __init__(self, in_c: int, hidden, out: int, final_act: bool = False, device=None):
        super().__init__()
        self.n_hidden = len(hidden)
        for i, h in enumerate(hidden):
            setattr(self, f"dense_{i}", nn.Linear(in_c, h, device=device))
            setattr(self, f"bn_{i}", _bn(h, device))
            in_c = h
        self.dense_out = nn.Linear(in_c, out, device=device)
        self.bn_out = _bn(out, device) if final_act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # flax promotes a bf16 input against the fp32 parameters
        for i in range(self.n_hidden):
            x = torch.relu(batch_norm(getattr(self, f"bn_{i}"),
                                      getattr(self, f"dense_{i}")(x)))
        x = self.dense_out(x)
        if self.bn_out is not None:
            x = torch.relu(batch_norm(self.bn_out, x))
        return x


class FaceRecon(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, train_heads: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        s, dt = cfg.gcn_sup_num, self.dtype
        hs = functools.partial(HSLayer, device=device, dtype=dt, bwd_store=cfg.bwd_store,
                               train_v4_small=cfg.train_v4_small)
        self.conv_0 = HSLayerSurface(128, s, device=device, dtype=dt)
        self.conv_1 = hs(128, 128, s)
        self.bn1 = _bn(128, device)
        self.conv_2 = hs(128, 256, s)
        self.bn2 = _bn(256, device)
        self.conv_3 = hs(256, 256, s)
        self.bn3 = _bn(256, device)
        self.conv_4 = hs(256, 512, s)
        self.train_heads = train_heads
        if train_heads:
            feat_c = FEAT_C + cfg.obj_c
            self.conv1d_block = MLPHead(feat_c, (512, 512), 256, final_act=True,
                                        device=device)
            self.recon_head = MLPHead(256, (128,), 3, device=device)
            self.face_head = MLPHead(512 + 256 + 3, (512, 256, 128), cfg.face_recon_c,
                                     device=device)

    def forward(self, vertices: torch.Tensor, cat_id: torch.Tensor,
                pool_samples: Sequence[torch.Tensor]):
        """vertices (B, N, 3) centred points; cat_id (B,) 0-based; pool_samples
        the kept-row indices of the two pools.  Returns feat (B, N, 1286) in
        eval mode and (recon (B, N, 3), face (B, N, 30), feat) in train mode."""
        cfg = self.cfg
        fast = self.dtype == torch.bfloat16
        # the relaxed-KNN tier serves only: training keeps gcn_n_num
        k = cfg.serve_k if cfg.serve_k > 0 and not self.training else cfg.gcn_n_num
        B, N, _ = vertices.shape
        one_hot = F.one_hot(cat_id.long().reshape(B), cfg.obj_c).to(self.dtype)
        # the bf16 tier runs every search on packed keys
        search = functools.partial(knn, packed=True) if fast else knn

        # resolution 0: N points
        vert_idx_0 = search(vertices, k)
        fm_0 = torch.relu(self.conv_0(vertices, vert_idx_0, vert_idx_0))
        rf_1 = search(fm_0, k)
        fm_1 = self.conv_1(vertices, fm_0, rf_1, vert_idx_0)
        fm_1 = torch.relu(batch_norm(self.bn1, fm_1))
        pool_idx_0 = search(vertices, 4)
        v_pool_1, fm_pool_1 = pool_layer(vertices, fm_1, pool_idx_0, pool_samples[0])

        # resolution 1: N // 4 points
        k1 = min(k, v_pool_1.shape[1] // 8)
        vert_idx_1 = search(v_pool_1, k1)
        rf_2 = search(fm_pool_1, k1)
        fm_2 = self.conv_2(v_pool_1, fm_pool_1, rf_2, vert_idx_1)
        fm_2 = torch.relu(batch_norm(self.bn2, fm_2))
        rf_3 = search(fm_2, k1)
        fm_3 = self.conv_3(v_pool_1, fm_2, rf_3, vert_idx_1)
        fm_3 = torch.relu(batch_norm(self.bn3, fm_3))
        pool_idx_1 = search(v_pool_1, 4)
        v_pool_2, fm_pool_2 = pool_layer(v_pool_1, fm_3, pool_idx_1, pool_samples[1])

        # resolution 2: N // 16 points
        k2 = min(k, v_pool_2.shape[1] // 8)
        vert_idx_2 = search(v_pool_2, k2)
        rf_4 = search(fm_pool_2, k2)
        fm_4 = self.conv_4(v_pool_2, fm_pool_2, rf_4, vert_idx_2)

        # 1-NN upsample back to N points
        up_1 = nearest_index(vertices, v_pool_1)[..., None]
        up_2 = nearest_index(vertices, v_pool_2)[..., None]
        fm_2_up = gather_neighbors(fm_2, up_1)[:, :, 0]
        fm_3_up = gather_neighbors(fm_3, up_1)[:, :, 0]
        fm_4_up = gather_neighbors(fm_4, up_2)[:, :, 0]
        one_hot_tiled = one_hot[:, None, :].expand(B, N, cfg.obj_c)
        feat = torch.cat([fm_0, fm_1, fm_2_up, fm_3_up, fm_4_up, one_hot_tiled], dim=-1)
        if not self.training:
            return feat
        if not self.train_heads:
            raise RuntimeError("train mode needs the train heads: build_model(..., "
                               "train_heads=True)")

        conv1d_out = self.conv1d_block(feat)
        recon = self.recon_head(conv1d_out)
        f_global = fm_4.amax(dim=1)  # (B, 512)
        face_in = torch.cat([f_global[:, None, :].expand(B, N, f_global.shape[-1]).float(),
                             conv1d_out, vertices], dim=-1)  # 771, fp32 as flax promotes it
        return recon, self.face_head(face_in), feat
