"""Hybrid-scope graph-conv layers, channel-last (counterpart of
``hspose_tpu/models/layers.py``).

KNN index sets are computed by the caller and passed in, as in the JAX
package.  In eval mode the layers run the serving kernels of
``ops/cuda_hs_fused.py``; in train mode (``self.training``) they gather the
receptive-field directions and neighbour features with autograd and run the
differentiable kernels of ``ops/cuda_hs.py`` on them, as the JAX layers' v3
training branch does (``bwd_store`` picks the support backward), and the ORL
branch is the plain gather, max and mean.  An ``HSLayer`` with
``train_v4_small`` at N <= 512 trains through the differentiable fused ops
of ``ops/cuda_hs_fused.py`` instead, its ORL branch too, as the JAX layers'
v4 training route does (hspose_tpu/models/layers.py:76-82, 246-264).
Either way a CUDA tensor takes the kernel and a CPU tensor its plain version,
in both tiers.

``dtype=torch.bfloat16`` is the bf16 tier: parameters stay fp32 and are
cast at use, and the layers round where the JAX layers with
``dtype=bfloat16`` do (hspose_tpu/models/layers.py:128-192, 235-343): the
dense maps in bf16, the HS reductions through the kernels' bf16 variants
into fp32, the centre projection in bf16 plus the fp32 bias, the ORL input
and the concat in bf16, and the output rounded to bf16.  In train mode the
receptive-field directions are formed in bf16 arithmetic from the vertices
rounded to bf16, the gathered features and the support directions are
bf16, and W and b of the supports stay fp32 (layers.py:147-159, 265-285).
For fp32 every cast is the identity, so the fp32 tier runs the same
operations as before.

Sequence-parallel serving (``sp_group``, ``parallel/sp.py``): the layers take
this rank's query rows and the gathered source (``verts_src``,
``feat_src``), and the kernels' query-sharded branches search and reduce the
local rows against it (hspose_tpu/models/layers.py:55-89, 115-124,
217-224); the ORL branch gathers its feature map, averages over the local
rows and finishes with the mean over the sp ranks, and the pool keeps this
rank's slice of the one global sample (:346-390).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
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
from hspose_tpu_torch.parallel.mp import columns
from hspose_tpu_torch.parallel.sp import all_gather_points, mean_over_shards


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input and fp32 parameters cast to
    ``dtype``, the product in ``dtype`` (fp32 accumulation inside the matrix
    product).  For fp32 it is ``layer(x)``.  A layer whose output channels
    are sharded over an mp group (``parallel/mp.py``) forms its own columns
    and gathers the rest."""
    if dtype == torch.float32:
        return columns(layer, layer, x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return columns(layer, lambda v: F.linear(v, layer.weight.to(dtype), bias), x.to(dtype))


def _uniform(shape, bound: float, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device).uniform_(-bound, bound))


def _normalize_dirs(directions: torch.Tensor) -> torch.Tensor:
    """Unit support directions: normalised over axis 0 of (3, S*Co), the norm
    clamped at 1e-12."""
    norm = torch.linalg.vector_norm(directions, dim=0, keepdim=True)
    return directions / torch.clamp(norm, min=1e-12)


def orl_global(feature: torch.Tensor, orl_idx: torch.Tensor, train: bool = False,
               train_v4_small: bool = False, sp_group=None) -> torch.Tensor:
    """Outlier-robust global feature: (B, N, C), vertex-KNN (B, N, K) ->
    (B, 1, C) = mean over points of the max over each point's neighbours.
    Training takes the plain gather, max and mean with autograd (the max
    splits a gradient over ties, as the JAX package's does), unless
    ``train_v4_small`` at N <= 512 sends it through the differentiable fused
    op, whose backward routes each tie to the first k.  With ``sp_group``
    the local rows' neighbours come from the gathered feature map and the
    shard means are averaged over the group."""
    if train and not (train_v4_small and feature.shape[1] <= 512):
        return orl_global_plain(feature, orl_idx)
    out = orl_global_fused(all_gather_points(feature, sp_group), orl_idx,
                           query_sharded=sp_group is not None)
    return mean_over_shards(out, sp_group)


def _with_global(feature: torch.Tensor, f_global: torch.Tensor) -> torch.Tensor:
    return torch.cat([feature, f_global.expand(-1, feature.shape[1], -1)], dim=-1)


def _finish(layer, feature: torch.Tensor, orl_idx: torch.Tensor, f_ste: torch.Tensor,
            train_v4_small: bool = False, sp_group=None) -> torch.Tensor:
    """The common tail of both HS layers (gcn3d.py:109-113, 183-187): the
    ORL branch on the layer's dtype, conv2 over [feature | global] plus the
    fp32 feature, plus the shortcut, rounded to the layer's dtype."""
    dt = layer.dtype
    f_global = orl_global(feature.to(dt), orl_idx, layer.training, train_v4_small,
                          sp_group).to(dt)
    feature = dense(layer.conv2, _with_global(feature.to(dt), f_global), dt) + feature
    return (feature + f_ste).to(dt)


class HSLayerSurface(nn.Module):
    """First layer: learned support directions over the raw surface, an ORL
    global branch and a linear shortcut on xyz (``STE_layer``)."""

    def __init__(self, kernel_num: int, support_num: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_num, self.support_num = kernel_num, support_num
        self.dtype = dtype
        self.directions = _uniform((3, support_num * kernel_num),
                                   1.0 / (support_num * kernel_num) ** 0.5, device)
        self.STE_layer = nn.Linear(3, kernel_num, bias=False, device=device)
        self.conv2 = nn.Linear(2 * kernel_num, kernel_num, bias=False, device=device)

    def forward(self, vertices: torch.Tensor, rf_idx: torch.Tensor, orl_idx: torch.Tensor,
                sp_group=None, verts_src: torch.Tensor | None = None) -> torch.Tensor:
        """``sp_group``: sequence-parallel serving; ``vertices`` are this
        rank's query rows, ``verts_src`` the gathered cloud that the indices
        point into."""
        dt = self.dtype
        f_ste = dense(self.STE_layer, vertices, dt)
        dirs = _normalize_dirs(self.directions)
        if self.training:
            rf = neighbor_directions_normalized(vertices.to(dt), rf_idx)
            feature = hs_surface_reduce(rf, dirs.to(dt), self.support_num, self.kernel_num)
        elif verts_src is None:
            feature = hs_surface_fused(vertices, rf_idx, dirs, self.support_num,
                                       self.kernel_num, exact=dt == torch.float32)
        else:
            feature = hs_surface_fused(verts_src, rf_idx, dirs, self.support_num,
                                       self.kernel_num, exact=dt == torch.float32,
                                       vertices_q=vertices)
        return _finish(self, feature, orl_idx, f_ste, sp_group=sp_group)


class HSLayer(nn.Module):
    """General hybrid-scope layer.  ``weights`` is (Cin, (S+1)*Co): the first
    Co columns are the centre projection, support s channel c sits at column
    Co + s*Co + c.  Receptive fields (``rf_idx``) come from feature space,
    the directions and the ORL branch from the vertices.  ``bwd_store`` and
    ``train_v4_small`` choose the training route (module docstring)."""

    def __init__(self, in_channel: int, out_channel: int, support_num: int,
                 device=None, dtype: torch.dtype = torch.float32, bwd_store: bool = True,
                 train_v4_small: bool = False):
        super().__init__()
        self.in_channel, self.out_channel = in_channel, out_channel
        self.support_num = support_num
        self.dtype = dtype
        self.bwd_store, self.train_v4_small = bwd_store, train_v4_small
        s, co = support_num, out_channel
        stdv = 1.0 / (co * (s + 1)) ** 0.5
        self.weights = _uniform((in_channel, (s + 1) * co), stdv, device)
        self.bias = _uniform(((s + 1) * co,), stdv, device)
        self.directions = _uniform((3, s * co), stdv, device)
        self.STE_layer = nn.Linear(in_channel, co, bias=False, device=device)
        self.conv2 = nn.Linear(2 * co, co, bias=False, device=device)

    def forward(self, vertices: torch.Tensor, feature_map: torch.Tensor,
                rf_idx: torch.Tensor, orl_idx: torch.Tensor, sp_group=None,
                verts_src: torch.Tensor | None = None,
                feat_src: torch.Tensor | None = None) -> torch.Tensor:
        """``sp_group``: sequence-parallel serving; ``vertices`` and
        ``feature_map`` are this rank's query rows, ``verts_src`` and
        ``feat_src`` the gathered maps that ``rf_idx`` points into."""
        s, co, dt = self.support_num, self.out_channel, self.dtype
        feature_map = feature_map.to(dt)
        f_ste = dense(self.STE_layer, feature_map, dt)
        feature_center = feature_map @ self.weights[:, :co].to(dt) + self.bias[:co]
        dirs = _normalize_dirs(self.directions)
        v4 = self.train_v4_small and vertices.shape[1] <= 512
        if self.training and not v4:
            rf = neighbor_directions_normalized(vertices.to(dt), rf_idx)
            g = gather_neighbors(feature_map, rf_idx)
            activation = hs_support_reduce(g, rf, self.weights[:, co:], self.bias[co:],
                                           dirs.to(dt), s, co, store=self.bwd_store,
                                           feat=feature_map.detach(), idx=rf_idx)
        elif feat_src is not None:
            activation = hs_support_fused(feat_src.to(dt), verts_src, rf_idx,
                                          self.weights[:, co:], self.bias[co:], dirs, s, co,
                                          vertices_q=vertices)
        else:
            # the JAX layer passes the directions rounded to its dtype and widened
            # (layers.py:240, :262), so in training their cotangent rounds too
            activation = hs_support_fused(feature_map, vertices, rf_idx,
                                          self.weights[:, co:], self.bias[co:],
                                          dirs.to(dt).float() if self.training else dirs, s, co)
        return _finish(self, feature_center + activation, orl_idx, f_ste, self.train_v4_small,
                       sp_group)


def pool_layer(vertices: torch.Tensor, feature_map: torch.Tensor,
               pool_idx: torch.Tensor, sample: torch.Tensor, sp_group=None,
               verts_src: torch.Tensor | None = None, feat_src: torch.Tensor | None = None):
    """Neighbour-max pooling at the kept rows.  ``sample`` holds the kept-row
    indices (the first n // 4 entries of one permutation, shared by the whole
    batch); ``pool_idx`` is the vertex-KNN (B, n, 4).  Returns
    (vertices_pool, features_pool).

    With ``sp_group``, ``sample`` is drawn over the global cloud (the same on
    every rank), the local rows pool over the gathered ``feat_src``, the
    pooled rows are gathered, and rank i keeps ``sample[i*m:(i+1)*m]`` of
    them and of ``verts_src``: the one-device pooled cloud, split in rank
    order."""
    if sp_group is None:
        pooled = gather_neighbors(feature_map, pool_idx[:, sample, :]).amax(dim=2)
        return vertices[:, sample, :], pooled
    sp = dist.get_world_size(sp_group)
    if sample.shape[0] % sp:
        raise ValueError(f"pooled size {sample.shape[0]} does not shard over sp={sp}")
    pooled = all_gather_points(gather_neighbors(feat_src, pool_idx).amax(dim=2), sp_group)
    m = sample.shape[0] // sp
    local = sample[dist.get_rank(sp_group) * m:(dist.get_rank(sp_group) + 1) * m]
    return verts_src[:, local, :], pooled[:, local, :]


def receptive_field_indices(feat_or_verts: torch.Tensor, k: int, packed: bool = False,
                            source: torch.Tensor | None = None) -> torch.Tensor:
    """RF-P (point distance) or RF-F (feature distance) neighbour search;
    ``packed`` is the bf16 tier's packed-key search, ``source`` the gathered
    map of sequence-parallel serving."""
    return knn_indices_cuda(feat_or_verts, k, packed=packed, source=source)
