"""KNN through the hand-written CUDA kernels of ``csrc/knn.cu``.

Counterpart of ``hspose_tpu/ops/pallas_knn.py::knn_indices_pallas``: the
exact search of the fp32 tier and the packed-key search of the bf16 tier
(``fast=True``), and with ``source`` the query-sharded branch of both
(``knn_indices_pallas_qs``, sequence-parallel serving).  On a CPU tensor
the wrapper runs the plain version, ``ops/knn.py::knn_indices`` or
``knn_indices_packed``; on a CUDA tensor it launches the kernel or raises.
``knn_indices_cuda.launches`` counts exact launches at N <= 2048,
``.streamed_launches`` exact launches above (the JAX package's streamed
kernel K5, ``_knn_kernel_streamed``, which the exact kernel's design
covers: source tiles stream through shared memory with a running sorted
list per query), and ``.packed_launches`` packed ones; the query-sharded
launches count in ``.qs_launches``, ``.qs_streamed_launches`` (by the
source's M) and ``.qs_packed_launches`` instead.
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


def knn_indices_cuda(points: torch.Tensor, k: int, packed: bool = False,
                     source: torch.Tensor | None = None) -> torch.Tensor:
    """Indices of the k nearest neighbours, column 0 of the k+1 smallest
    dropped: (B, N, D) -> int32 (B, N, k).

    Exact (the default): fp32 points, ties to the lowest index.  ``packed``:
    fp32 or bf16 points, ordered by packed keys (``knn_indices_packed``).
    Above N = 2048 the index does not fit the key, and the JAX package then
    runs the exact search (pallas_knn.py:347-348); so does this wrapper, on
    the points widened to fp32, counted in ``.streamed_launches``.  The
    kernel takes bf16 points with D a multiple of 16 on the tensor cores;
    other bf16 points are widened to fp32, which holds their values exactly.

    ``source`` (B, M, D), of the points' type, holds the candidates and
    contains every query row, best as the rows the query tensor was copied
    from (a shard of the gathered cloud): the indices point into it.  The
    switch to the exact search then goes by M, the source's size, not by N.
    """
    qs = source is not None
    src = source if qs else points
    if packed:
        if points.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"points: expected fp32 or bf16, got {points.dtype}")
        if src.shape[1] > PACKED_MAX_N:
            packed, points, src = False, points.float(), src.float()
    if _build.on_cpu(points, src):
        if packed:
            return knn_indices_packed(points, k, source)
        return knn_indices(points, k, source)
    dtype = points.dtype if packed else torch.float32
    _build.check(points, "points", dtype, (None, None, None))
    B, N, D = points.shape
    _build.check(src, "source", dtype, (B, None, D))
    M = src.shape[1]
    if not 1 <= k <= min(MAX_K, M - 1):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, M - 1 = {M - 1})]")
    if D > MAX_D:
        raise ValueError(f"the KNN kernel takes D <= {MAX_D}, got D={D}")
    out = torch.empty((B, N, k), dtype=torch.int32, device=points.device)
    lanes = knn_lanes(B, N, D, k)
    if packed:
        if points.dtype == torch.bfloat16 and D % 16:
            points, src = points.float(), src.float()
        bf16 = int(points.dtype == torch.bfloat16)
        if qs:
            _build.launch("hs_knn_packed_qs", points, src, bf16, out, B, N, M, D, k + 1, lanes)
            knn_indices_cuda.qs_packed_launches += 1
        else:
            _build.launch("hs_knn_packed", points, bf16, out, B, N, D, k + 1, lanes)
            knn_indices_cuda.packed_launches += 1
        return out
    if qs:
        _build.launch("hs_knn_qs", points, src, out, B, N, M, D, k + 1, lanes)
    else:
        _build.launch("hs_knn", points, out, B, N, D, k + 1, lanes)
    streamed = M > PACKED_MAX_N
    attr = ("qs_" if qs else "") + ("streamed_launches" if streamed else "launches")
    setattr(knn_indices_cuda, attr, getattr(knn_indices_cuda, attr) + 1)
    return out


knn_indices_cuda.launches = 0
knn_indices_cuda.streamed_launches = 0
knn_indices_cuda.packed_launches = 0
knn_indices_cuda.qs_launches = 0
knn_indices_cuda.qs_streamed_launches = 0
knn_indices_cuda.qs_packed_launches = 0
