"""Hybrid-scope graph-conv layers, channel-last (counterpart of
``hspose_tpu/models/layers.py``).

KNN index sets are computed by the caller and passed in, as in the JAX
package.  In eval mode the layers run the serving kernels of
``ops/cuda_hs_fused.py``; in train mode (``self.training``) they gather the
receptive-field directions and neighbour features with autograd and run the
differentiable kernels of ``ops/cuda_hs.py`` on them, as the JAX layers' v3
training branch does, and the ORL branch is the plain gather, max and mean.
Either way a CUDA tensor takes the kernel and a CPU tensor its plain version.
"""

from __future__ import annotations

import torch
from torch import nn

from hspose_tpu_torch.ops.cuda_hs import hs_support_reduce, hs_surface_reduce
from hspose_tpu_torch.ops.cuda_hs_fused import (
    hs_support_fused,
    hs_surface_fused,
    orl_global_fused,
    orl_global_plain,
)
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized


def _uniform(shape, bound: float, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device).uniform_(-bound, bound))


def _normalize_dirs(directions: torch.Tensor) -> torch.Tensor:
    """Unit support directions: normalised over axis 0 of (3, S*Co), the norm
    clamped at 1e-12."""
    norm = torch.linalg.vector_norm(directions, dim=0, keepdim=True)
    return directions / torch.clamp(norm, min=1e-12)


def orl_global(feature: torch.Tensor, orl_idx: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    """Outlier-robust global feature: (B, N, C), vertex-KNN (B, N, K) ->
    (B, 1, C) = mean over points of the max over each point's neighbours.
    Training takes the plain gather, max and mean with autograd (the max
    splits a gradient over ties, as the JAX package's does)."""
    if train:
        return orl_global_plain(feature, orl_idx)
    return orl_global_fused(feature, orl_idx)


def _with_global(feature: torch.Tensor, f_global: torch.Tensor) -> torch.Tensor:
    return torch.cat([feature, f_global.expand(-1, feature.shape[1], -1)], dim=-1)


class HSLayerSurface(nn.Module):
    """First layer: learned support directions over the raw surface, an ORL
    global branch and a linear shortcut on xyz (``STE_layer``)."""

    def __init__(self, kernel_num: int, support_num: int, device=None):
        super().__init__()
        self.kernel_num, self.support_num = kernel_num, support_num
        self.directions = _uniform((3, support_num * kernel_num),
                                   1.0 / (support_num * kernel_num) ** 0.5, device)
        self.STE_layer = nn.Linear(3, kernel_num, bias=False, device=device)
        self.conv2 = nn.Linear(2 * kernel_num, kernel_num, bias=False, device=device)

    def forward(self, vertices: torch.Tensor, rf_idx: torch.Tensor,
                orl_idx: torch.Tensor) -> torch.Tensor:
        f_ste = self.STE_layer(vertices)
        dirs = _normalize_dirs(self.directions)
        if self.training:
            rf = neighbor_directions_normalized(vertices, rf_idx)
            feature = hs_surface_reduce(rf, dirs, self.support_num, self.kernel_num)
        else:
            feature = hs_surface_fused(vertices, rf_idx, dirs, self.support_num,
                                       self.kernel_num)
        f_global = orl_global(feature, orl_idx, self.training)
        feature = self.conv2(_with_global(feature, f_global)) + feature
        return feature + f_ste


class HSLayer(nn.Module):
    """General hybrid-scope layer.  ``weights`` is (Cin, (S+1)*Co): the first
    Co columns are the centre projection, support s channel c sits at column
    Co + s*Co + c.  Receptive fields (``rf_idx``) come from feature space,
    the directions and the ORL branch from the vertices."""

    def __init__(self, in_channel: int, out_channel: int, support_num: int,
                 device=None):
        super().__init__()
        self.in_channel, self.out_channel = in_channel, out_channel
        self.support_num = support_num
        s, co = support_num, out_channel
        stdv = 1.0 / (co * (s + 1)) ** 0.5
        self.weights = _uniform((in_channel, (s + 1) * co), stdv, device)
        self.bias = _uniform(((s + 1) * co,), stdv, device)
        self.directions = _uniform((3, s * co), stdv, device)
        self.STE_layer = nn.Linear(in_channel, co, bias=False, device=device)
        self.conv2 = nn.Linear(2 * co, co, bias=False, device=device)

    def forward(self, vertices: torch.Tensor, feature_map: torch.Tensor,
                rf_idx: torch.Tensor, orl_idx: torch.Tensor) -> torch.Tensor:
        s, co = self.support_num, self.out_channel
        f_ste = self.STE_layer(feature_map)
        feature_center = feature_map @ self.weights[:, :co] + self.bias[:co]
        dirs = _normalize_dirs(self.directions)
        if self.training:
            rf = neighbor_directions_normalized(vertices, rf_idx)
            g = gather_neighbors(feature_map, rf_idx)
            activation = hs_support_reduce(g, rf, self.weights[:, co:], self.bias[co:],
                                           dirs, s, co)
        else:
            activation = hs_support_fused(feature_map, vertices, rf_idx,
                                          self.weights[:, co:], self.bias[co:], dirs, s, co)
        feature = feature_center + activation
        f_global = orl_global(feature, orl_idx, self.training)
        feature = self.conv2(_with_global(feature, f_global)) + feature
        return feature + f_ste


def pool_layer(vertices: torch.Tensor, feature_map: torch.Tensor,
               pool_idx: torch.Tensor, sample: torch.Tensor):
    """Neighbour-max pooling at the kept rows.  ``sample`` holds the kept-row
    indices (the first n // 4 entries of one permutation, shared by the whole
    batch); ``pool_idx`` is the vertex-KNN (B, n, 4).  Returns
    (vertices_pool, features_pool)."""
    pooled = gather_neighbors(feature_map, pool_idx[:, sample, :]).amax(dim=2)
    return vertices[:, sample, :], pooled


def receptive_field_indices(feat_or_verts: torch.Tensor, k: int) -> torch.Tensor:
    """RF-P (point distance) or RF-F (feature distance) neighbour search."""
    return knn_indices_cuda(feat_or_verts, k)
