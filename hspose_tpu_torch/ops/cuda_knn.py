"""KNN through the hand-written CUDA kernel ``csrc/knn.cu``.

Counterpart of ``hspose_tpu/ops/pallas_knn.py::knn_indices_pallas``.  On a
CPU tensor the wrapper runs the plain version, ``ops/knn.py::knn_indices``;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import knn_indices

MAX_K = 31  # the kernel keeps at most 32 = k + 1 entries per query


def knn_indices_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest neighbours, column 0 of the k+1 smallest
    dropped, ties to the lowest index: fp32 (B, N, D) -> int32 (B, N, k)."""
    if _build.on_cpu(points):
        return knn_indices(points, k)
    _build.check(points, "points", torch.float32, (None, None, None))
    B, N, D = points.shape
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, N - 1 = {N - 1})]")
    out = torch.empty((B, N, k), dtype=torch.int32, device=points.device)
    _build.launch("hs_knn", points, out, B, N, D, k + 1)
    knn_indices_cuda.launches += 1
    return out


knn_indices_cuda.launches = 0
