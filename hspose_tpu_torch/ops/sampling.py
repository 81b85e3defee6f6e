"""Fixed-size point selection for device sampling (counterpart of
``hspose_tpu/ops/sampling.py``).

The JAX package draws its scores inside the function from a key; here the
scores are an argument, uniform [0, 1) fp32 draws of one per point, so that
the tests can hand in the JAX package's own draws and the train step and the
eval harness draw theirs from their generator (:func:`draw_sample_scores`).
"""

from __future__ import annotations

import torch


def draw_sample_scores(generator: torch.Generator, b: int, n: int) -> torch.Tensor:
    """(b, n) uniform [0, 1) fp32 scores, one per point, on the generator's
    device."""
    return torch.rand((b, n), generator=generator, device=generator.device)


def sample_points_fixed(scores: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                        n_out: int) -> torch.Tensor:
    """Exactly ``n_out`` points of a padded, masked cloud, in a random order.

    scores (..., N) uniform draws; points (..., N, 3); valid (..., N) bool;
    returns (..., n_out, 3).  The valid points are ordered by their score
    (score + 1 ranks every valid point above every invalid one), and output
    i takes the (i mod n_valid)-th of them, so a short cloud tiles; with no
    valid point it takes the i-th in the order of all points.

    ``jax.lax.top_k`` breaks ties by the lower index first, which is a stable
    descending sort, and uniform fp32 draws tie often (a 256² crop holds
    about 256 equal pairs).  ``torch.topk`` orders ties otherwise on the
    CPU and leaves their order unspecified on CUDA, so this sorts stably on
    both devices."""
    n = points.shape[-2]
    order = torch.sort(scores + valid.to(scores.dtype), dim=-1, descending=True,
                       stable=True).indices
    n_valid = valid.sum(-1, keepdim=True)
    pos = torch.arange(n_out, device=points.device)
    # with no valid point JAX reads order[pos]; its gather clamps pos to n - 1
    pick = torch.where(n_valid > 0, pos % n_valid.clamp(min=1), pos.clamp(max=n - 1))
    idx = order.gather(-1, pick)
    return points.gather(-2, idx[..., None].expand(*idx.shape, points.shape[-1]))


def batched_sample_points(scores: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                          n_out: int) -> torch.Tensor:
    """:func:`sample_points_fixed` over a batch: (B, N), (B, N, 3), (B, N)
    -> (B, n_out, 3), each cloud with its own row of scores."""
    if scores.dim() != 2 or points.dim() != 3 or valid.dim() != 2:
        raise ValueError(f"scores {tuple(scores.shape)}, points {tuple(points.shape)}, "
                         f"valid {tuple(valid.shape)}: expected (B, N), (B, N, 3), (B, N)")
    return sample_points_fixed(scores, points, valid, n_out)
