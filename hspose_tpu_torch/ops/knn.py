"""Plain PyTorch neighbour ops (counterpart of ``hspose_tpu/ops/knn.py``).

These are the semantics the CUDA kernels are held to: ``knn_indices`` is the
plain version of the KNN kernel (``ops/cuda_knn.py``), and the gathers and
receptive-field directions feed the plain versions of the HS kernels
(``ops/cuda_hs_fused.py``).  Indices are int32, as in the JAX package.
"""

from __future__ import annotations

import torch


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances a (B, N, D), b (B, M, D) -> (B, N, M), by the
    ‖a‖² + ‖b‖² − 2a·b expansion in fp32 (TF32 must be off on the card)."""
    a = a.float()
    b = b.float()
    inner = torch.matmul(a, b.transpose(-1, -2))
    a_sq = (a * a).sum(-1)
    b_sq = (b * b).sum(-1)
    return a_sq[..., :, None] + b_sq[..., None, :] - 2.0 * inner


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest neighbours: (B, N, D) -> int32 (B, N, k).

    Takes the k+1 smallest distances and drops column 0 (which is the query
    itself unless a duplicate with a lower index ties with it).  Ties go to the
    lowest index: a stable sort keeps equal distances in index order, which
    ``torch.topk`` does not promise.
    """
    d = pairwise_sq_dist(points, points)
    order = torch.sort(d, dim=-1, stable=True).indices
    return order[..., 1:k + 1].to(torch.int32)


def nearest_index(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """1-NN of each target point among the source points: (B, N1, D),
    (B, N2, D) -> int32 (B, N1); ties go to the first occurrence."""
    return torch.argmin(pairwise_sq_dist(target, source), dim=-1).to(torch.int32)


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour features: features (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    batch = torch.arange(features.shape[0], device=features.device)[:, None, None]
    return features[batch, idx.long()]


def neighbor_directions_normalized(vertices: torch.Tensor,
                                   idx: torch.Tensor) -> torch.Tensor:
    """Unit directions to each neighbour: (B, N, 3), (B, N, K) -> (B, N, K, 3).

    The norm is clamped at 1e-12, so a duplicated point gives exactly 0."""
    direction = gather_neighbors(vertices, idx) - vertices[:, :, None, :]
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    return direction / torch.clamp(norm, min=1e-12)
