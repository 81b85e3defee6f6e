"""HS graph-conv reductions through hand-written CUDA kernels.

Counterpart of ``hspose_tpu/ops/pallas_hs_fused.py`` (the forward of
``hs_surface_fused``, ``hs_support_fused`` and ``orl_global_fused``), with the
TPU-only arguments (``tq``, ``exact``, ``interpret``, ``slots``,
``vertices_q``) gone.  Each wrapper runs its plain version, in this module, on
CPU tensors, and on CUDA tensors launches its kernel or raises:

* ``hs_surface_fused`` -> ``csrc/hs_surface.cu``;
* ``hs_support_fused`` -> ``csrc/hs_support.cu`` (a tiled GEMM for the
  projection, then the gather-theta-max-mean reduction);
* ``orl_global_fused`` -> ``csrc/orl.cu``.

Inputs are fp32 and ``idx`` int32, with values in [0, N).  These are the
serving forwards: the kernels fill their outputs outside autograd, so every
wrapper raises when grad mode is on and a floating input requires grad, on
either device, rather than return a result cut from the graph.  Training
goes through ``ops/cuda_hs.py``.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized


def hs_surface_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                     support_num: int, out_channel: int) -> torch.Tensor:
    """mean_s max_k relu(normalize(v[idx] - v) . dir_s): (B, N, 3), (B, N, K),
    (3, S*Co) -> (B, N, Co)."""
    rf = neighbor_directions_normalized(vertices, idx)  # (B, N, K, 3)
    total = 0.0
    for s in range(support_num):
        d = dirs[:, s * out_channel:(s + 1) * out_channel]
        total = total + torch.relu(rf @ d).amax(dim=2)
    return total / support_num


def hs_support_plain(feature_map: torch.Tensor, vertices: torch.Tensor,
                     idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     dirs: torch.Tensor, support_num: int,
                     out_channel: int) -> torch.Tensor:
    """mean_s max_k relu(rf . dir_s) * (feat @ W_s + b_s)[idx], projecting
    before the gather as the reference does: (B, N, Cin), (B, N, 3),
    (B, N, K), (Cin, S*Co), (S*Co,), (3, S*Co) -> (B, N, Co)."""
    rf = neighbor_directions_normalized(vertices, idx)
    proj = feature_map @ weights + bias  # (B, N, S*Co)
    total = 0.0
    for s in range(support_num):
        cols = slice(s * out_channel, (s + 1) * out_channel)
        theta = torch.relu(rf @ dirs[:, cols])
        total = total + (theta * gather_neighbors(proj[..., cols], idx)).amax(dim=2)
    return total / support_num


def orl_global_plain(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mean_n max_k feat[idx]: (B, N, C), (B, N, K) -> (B, 1, C)."""
    return gather_neighbors(feature, idx).amax(dim=2).mean(dim=1, keepdim=True)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is a serving kernel with no backward: call it under "
                           f"torch.no_grad(), or train through ops/cuda_hs.py")


def _check_idx(idx: torch.Tensor, B: int, N: int) -> int:
    _build.check(idx, "idx", torch.int32, (B, N, None))
    return idx.shape[2]


def hs_surface_fused(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                     support_num: int, out_channel: int) -> torch.Tensor:
    """HS surface reduction (conv_0); see ``hs_surface_plain``."""
    _refuse_grad("hs_surface_fused", vertices, dirs)
    if _build.on_cpu(vertices, idx, dirs):
        return hs_surface_plain(vertices, idx, dirs, support_num, out_channel)
    S, co = support_num, out_channel
    _build.check(vertices, "vertices", torch.float32, (None, None, 3))
    B, N, _ = vertices.shape
    K = _check_idx(idx, B, N)
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    out = torch.empty((B, N, co), dtype=torch.float32, device=vertices.device)
    _build.launch("hs_surface", vertices, idx, dirs, out, B, N, K, S, co)
    hs_surface_fused.launches += 1
    return out


def hs_support_fused(feature_map: torch.Tensor, vertices: torch.Tensor,
                     idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     dirs: torch.Tensor, support_num: int,
                     out_channel: int) -> torch.Tensor:
    """HS support reduction (conv_1 .. conv_4); see ``hs_support_plain``.

    ``weights`` may be a column slice of a wider matrix (rows need not be
    adjacent, but each row must be)."""
    tensors = (feature_map, vertices, idx, weights, bias, dirs)
    _refuse_grad("hs_support_fused", *tensors)
    if _build.on_cpu(*tensors):
        return hs_support_plain(*tensors, support_num, out_channel)
    S, co = support_num, out_channel
    _build.check(feature_map, "feature_map", torch.float32, (None, None, None))
    B, N, cin = feature_map.shape
    _build.check(vertices, "vertices", torch.float32, (B, N, 3))
    K = _check_idx(idx, B, N)
    _build.check_rows(weights, "weights", (cin, S * co))
    _build.check(bias, "bias", torch.float32, (S * co,))
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    proj = torch.empty((B, N, S * co), dtype=torch.float32, device=feature_map.device)
    out = torch.empty((B, N, co), dtype=torch.float32, device=feature_map.device)
    _build.launch("hs_support_project", feature_map, weights, weights.stride(0), bias,
                  proj, B * N, cin, S * co)
    _build.launch("hs_support_reduce", proj, vertices, idx, dirs, out, B, N, K, S, co)
    hs_support_fused.launches += 1
    return out


def orl_global_fused(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ORL global branch; see ``orl_global_plain``."""
    _refuse_grad("orl_global_fused", feature)
    if _build.on_cpu(feature, idx):
        return orl_global_plain(feature, idx)
    _build.check(feature, "feature", torch.float32, (None, None, None))
    B, N, C = feature.shape
    K = _check_idx(idx, B, N)
    tiles = _build.load().hs_orl_tiles(N)
    partial = torch.empty((B, tiles, C), dtype=torch.float32, device=feature.device)
    out = torch.empty((B, 1, C), dtype=torch.float32, device=feature.device)
    _build.launch("hs_orl", feature, idx, partial, out, B, N, K, C)
    orl_global_fused.launches += 1
    return out


hs_surface_fused.launches = 0
hs_support_fused.launches = 0
orl_global_fused.launches = 0
