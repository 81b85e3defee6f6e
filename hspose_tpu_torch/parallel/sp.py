"""Sequence parallelism: shard the point axis N over the ranks of an sp group
for serving (counterpart of ``hspose_tpu/parallel/sp.py``).

Each rank holds N / sp contiguous points of every crop.  Per layer the
source side (vertices, feature maps) is all-gathered over the sp group in
rank order; the KNN searches, neighbour gathers and HS reductions run on the
local query rows against it (the query-sharded kernel branches of
``ops/cuda_knn.py`` and ``ops/cuda_hs_fused.py``), and the cross-N
reductions finish as collectives: the centring and ORL means as the
all-reduced sum over sp (the mean of equal shards' means, JAX's ``pmean``),
the heads' max-pools as an all-reduced max.  Every per-crop output comes out
the same on all sp ranks.

The global point count must divide by 16 * sp, so that both pooled
resolutions (N / 4, N / 16) shard evenly: the large-N configurations (2048,
4096, ...), not the 1028-point REAL275 one, which shards over dp only.  sp
serves only: training and the heads with recon raise.

Collectives take the tensors as they are, on the group's backend: ``nccl``
for one GPU per rank, ``gloo`` on the CPU or for ranks that share one card
(gloo takes CUDA tensors itself, fp32 and bf16, exactly: ``chip_smoke.py``
phase 26 asserts it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def all_gather_points(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The point axis (1) of ``x`` gathered over ``group`` in rank order,
    tiled: (B, n, ...) on each of sp ranks -> (B, sp * n, ...).  Identity
    when ``group`` is None."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def mean_over_shards(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (JAX's ``pmean``: the
    all-reduced sum divided by the group's size); identity for None."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.SUM) / dist.get_world_size(group)


def max_over_shards(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``group`` (JAX's
    ``pmax``); identity for None."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def sp_eval_fn(model, group: Optional[dist.ProcessGroup], with_rt: bool = True):
    """The sequence-parallel serving forward of ``model`` (in eval mode).

    Returns ``fn(pc, obj_id, sym, mean_shape, pool_samples)``: ``pc`` is this
    rank's shard (B, N / sp, 3) of the crops' points, ``pool_samples`` the
    kept rows of the two pools over the global N (the same on every rank),
    and the result ``(RT (B, 4, 4), scales (B, 3))``, or with ``with_rt``
    False the six raw head outputs, the same on every rank of ``group``."""
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    def fn(pc: torch.Tensor, obj_id: torch.Tensor, sym: torch.Tensor,
           mean_shape: torch.Tensor, pool_samples: Sequence[torch.Tensor]):
        out = eval_forward(model, pc, obj_id, pool_samples=pool_samples, sp_group=group)
        if not with_rt:
            return tuple(out)
        RT = generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                         out.pred_T, sym)
        return RT, out.pred_s + mean_shape

    return fn


def sp_points_per_device(n_points: int, sp: int) -> Tuple[int, int]:
    """Validate the SP divisibility rule; returns (local N, global N)."""
    if n_points % (16 * sp):
        raise ValueError(
            f"sequence parallelism needs num_points % (16*sp) == 0 so both "
            f"pooled resolutions shard evenly; got N={n_points}, sp={sp}")
    return n_points // sp, n_points
