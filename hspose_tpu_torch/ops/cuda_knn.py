"""KNN through the hand-written CUDA kernels of ``csrc/knn.cu``.

Counterpart of ``hspose_tpu/ops/pallas_knn.py::knn_indices_pallas``: the
exact search of the fp32 tier and the packed-key search of the bf16 tier
(``fast=True``).  On a CPU tensor the wrapper runs the plain version,
``ops/knn.py::knn_indices`` or ``knn_indices_packed``; on a CUDA tensor it
launches the kernel or raises.  ``knn_indices_cuda.launches`` counts exact
launches at N <= 2048, ``.streamed_launches`` exact launches above (the
JAX package's streamed kernel K5, ``_knn_kernel_streamed``, which the exact
kernel's design covers: source tiles stream through shared memory with a
running sorted list per query), and ``.packed_launches`` packed ones.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import PACKED_MAX_N, knn_indices, knn_indices_packed

MAX_K = 31  # the kernel keeps at most 32 = k + 1 entries per query
MAX_D = 512  # a block keeps its query rows in shared memory
SMS = 132  # streaming multiprocessors of an H100 SXM


def knn_lanes(batch: int, n: int, d: int, k: int) -> int:
    """Selecting lanes per query (4, 8 or 16; 256 / lanes queries per block
    of 256 threads) of the kernel's launch for ``batch`` clouds of ``n``
    points of dimension ``d``, k neighbours.  The lanes split a query's
    source points between them and merge their lists in (distance, index)
    order, so the choice does not change the result, only the time: fewer
    lanes mean larger query tiles, which the distance product of D > 8
    needs, more lanes more blocks, which the small searches need to fill
    the card.  Chosen from the nine searches of the B = 24 forward and K5's
    at N = 2056 on an H100 (``PERF.md`` §6)."""
    blocks = batch * -(-n // 64)  # blocks of 64 queries
    if d > 8:
        return 4 if blocks >= SMS // 2 else 16
    if blocks < 2 * SMS:
        return 16
    return 8 if k <= 8 and blocks < 4 * SMS else 4


def knn_indices_cuda(points: torch.Tensor, k: int, packed: bool = False) -> torch.Tensor:
    """Indices of the k nearest neighbours, column 0 of the k+1 smallest
    dropped: (B, N, D) -> int32 (B, N, k).

    Exact (the default): fp32 points, ties to the lowest index.  ``packed``:
    fp32 or bf16 points, ordered by packed keys (``knn_indices_packed``).
    Above N = 2048 the index does not fit the key, and the JAX package then
    runs the exact search (pallas_knn.py:347-348); so does this wrapper, on
    the points widened to fp32, counted in ``.streamed_launches``.  The
    kernel takes bf16 points with D a multiple of 16 on the tensor cores;
    other bf16 points are widened to fp32, which holds their values exactly."""
    if packed:
        if points.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"points: expected fp32 or bf16, got {points.dtype}")
        if points.shape[1] > PACKED_MAX_N:
            packed, points = False, points.float()
    if _build.on_cpu(points):
        return knn_indices_packed(points, k) if packed else knn_indices(points, k)
    _build.check(points, "points", points.dtype if packed else torch.float32,
                 (None, None, None))
    B, N, D = points.shape
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, N - 1 = {N - 1})]")
    if D > MAX_D:
        raise ValueError(f"the KNN kernel takes D <= {MAX_D}, got D={D}")
    out = torch.empty((B, N, k), dtype=torch.int32, device=points.device)
    lanes = knn_lanes(B, N, D, k)
    if packed:
        if points.dtype == torch.bfloat16 and D % 16:
            points = points.float()
        _build.launch("hs_knn_packed", points, int(points.dtype == torch.bfloat16), out, B,
                      N, D, k + 1, lanes)
        knn_indices_cuda.packed_launches += 1
        return out
    _build.launch("hs_knn", points, out, B, N, D, k + 1, lanes)
    if N > PACKED_MAX_N:
        knn_indices_cuda.streamed_launches += 1
    else:
        knn_indices_cuda.launches += 1
    return out


knn_indices_cuda.launches = 0
knn_indices_cuda.streamed_launches = 0
knn_indices_cuda.packed_launches = 0
