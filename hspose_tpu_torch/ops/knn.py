"""Plain PyTorch neighbour ops (counterpart of ``hspose_tpu/ops/knn.py``).

These are the semantics the CUDA kernels are held to: ``knn_indices`` and
``knn_indices_packed`` are the plain versions of the exact and packed-key KNN
kernels (``ops/cuda_knn.py``), and the gathers and receptive-field
directions feed the plain versions of the HS kernels
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


def knn_indices(points: torch.Tensor, k: int,
                source: torch.Tensor | None = None) -> torch.Tensor:
    """Indices of the k nearest neighbours: (B, N, D) -> int32 (B, N, k).

    Takes the k+1 smallest distances and drops column 0 (which is the query
    itself unless a duplicate with a lower index ties with it).  Ties go to the
    lowest index: a stable sort keeps equal distances in index order, which
    ``torch.topk`` does not promise.

    ``source`` (B, M, D) searches another candidate set, as the JAX
    package's ``knn_indices(..., source=)`` (hspose_tpu/ops/knn.py:42-61):
    indices point into ``source``, which must contain every query row (the
    sequence-parallel path passes a shard of the gathered cloud), so column 0
    is still the query itself.
    """
    d = pairwise_sq_dist(points, points if source is None else source)
    order = torch.sort(d, dim=-1, stable=True).indices
    return order[..., 1:k + 1].to(torch.int32)


IDX_BITS = 11  # the packed key's index bits (hspose_tpu/ops/pallas_knn.py:32)
PACKED_MAX_N = 1 << IDX_BITS


def knn_indices_packed(points: torch.Tensor, k: int,
                       source: torch.Tensor | None = None) -> torch.Tensor:
    """Indices of the k nearest neighbours by packed keys, the bf16 tier's
    search (``hspose_tpu/ops/pallas_knn.py``, ``fast=True``): (B, N, D) fp32
    or bf16 -> int32 (B, N, k), N <= 2048.  ``source`` (B, M, D), M <= 2048,
    as in ``knn_indices``: the keys then hold the source index.

    Distances are fp32 from the input's values: for D <= 8 the sum over the
    dimensions, in order, of squared differences (pallas_knn.py:204-209),
    above that ||x||^2 + ||q||^2 - 2 q.x (:198-203).  Each candidate's key is
    (bits(max(d, 0)) & ~0x7FF) | index, a non-negative int that orders as the
    distance truncated to 12 mantissa bits, ties to the lower index
    (:213-215).  The k+1 smallest keys are taken and column 0 dropped.  Keys
    are unique, so the order is total and ``topk`` returns it exactly."""
    q = points.float()
    x = q if source is None else source.float()
    B, N, D = q.shape
    M = x.shape[1]
    if M > PACKED_MAX_N:
        raise ValueError(f"packed keys hold indices below {PACKED_MAX_N}, got {M} source points")
    if D <= 8:
        d = torch.zeros((B, N, M), dtype=torch.float32, device=x.device)
        for dim in range(D):
            diff = x[:, None, :, dim] - q[:, :, None, dim]
            d = d + diff * diff
    else:
        sq_x, sq_q = (x * x).sum(-1), (q * q).sum(-1)
        d = (sq_x[:, None, :] + sq_q[:, :, None]) - 2.0 * torch.matmul(q, x.transpose(-1, -2))
    col = torch.arange(M, dtype=torch.int32, device=x.device)
    key = (d.clamp_min(0.0).view(torch.int32) & ~(PACKED_MAX_N - 1)) | col
    smallest = torch.topk(key, k + 1, dim=-1, largest=False, sorted=True).values
    return smallest[..., 1:] & (PACKED_MAX_N - 1)


def nearest_index(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """1-NN of each target point among the source points: (B, N1, D),
    (B, N2, D) -> int32 (B, N1); ties go to the first occurrence."""
    return torch.argmin(pairwise_sq_dist(target, source), dim=-1).to(torch.int32)


def _gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    batch = torch.arange(features.shape[0], device=features.device)[:, None, None]
    return features[batch, idx.long()]


class _GatherBF16(torch.autograd.Function):
    """The gather of bf16 features, whose cotangent is summed in fp32 and
    rounded to bf16 once, as the TPU forms it (a one-hot product with fp32
    accumulation, hspose_tpu/ops/knn.py:175-183).  Autograd's own backward
    of the indexing adds into bf16, rounding after every add."""

    @staticmethod
    def forward(ctx, features, idx):
        ctx.save_for_backward(idx)
        ctx.shape = features.shape
        return _gather(features, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, N, C = ctx.shape
        rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
        acc = torch.zeros((B * N, C), dtype=torch.float32, device=grad.device)
        acc.index_add_(0, rows, grad.reshape(-1, C).float())
        return acc.to(grad.dtype).reshape(B, N, C), None


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour features: features (B, N, C), idx (B, M, K) -> (B, M, K, C).
    For bf16 features the cotangent is summed in fp32 (``_GatherBF16``)."""
    if features.dtype == torch.bfloat16:
        return _GatherBF16.apply(features, idx)
    return _gather(features, idx)


def neighbor_directions_normalized(vertices: torch.Tensor, idx: torch.Tensor,
                                   source: torch.Tensor | None = None) -> torch.Tensor:
    """Unit directions to each neighbour: (B, N, 3), (B, N, K) -> (B, N, K, 3);
    with ``source`` (B, M, 3) the neighbours are its rows (the
    sequence-parallel path's gathered cloud).

    The norm is clamped at 1e-12, so a duplicated point gives exactly 0.
    bf16 vertices (the bf16 train step) take the JAX package's bf16
    arithmetic (hspose_tpu/ops/knn.py:224-230): the difference, the square
    root and the division round to bf16; the squares and their sum are
    fp32, rounded once (jnp.linalg.norm's upcast sum, into which XLA fuses
    the squares: this matches the JAX function bit for bit on the CPU)."""
    src = vertices if source is None else source
    direction = gather_neighbors(src, idx) - vertices[:, :, None, :]
    if direction.dtype == torch.bfloat16:
        sq = direction.float().square().sum(-1, keepdim=True).to(torch.bfloat16)
        norm = torch.sqrt(sq)
    else:
        norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    return direction / torch.clamp(norm, min=1e-12)
