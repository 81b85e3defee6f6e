"""The training collectives of the (dp, mp) layout (``mesh.py``).

A train step on dp ranks over a global batch of B rows computes what the
one-process step computes on those B rows, as the JAX package's GSPMD step
does (hspose_tpu/engine/train.py:38-80):

* BatchNorm in train mode takes its sums of x and x^2 over the dp group
  (``all_reduce_sum``, differentiable: its backward sums the cotangents of
  the group's ranks), so the statistics and the running statistics are the
  whole batch's, the same on every rank;
* the loss inputs (the model's outputs, the augmented targets) are gathered
  over the dp group in rank order (``gather``), and every rank computes the
  one-process losses on the global batch.  The code after the gather is the
  same on every rank, so a row's cotangent is its slice of the gathered
  cotangent (the backward slices; it does not sum over the ranks);
* each rank's backward then holds its rows' share of the gradient, and
  ``reduce_gradients`` sums the shares over the dp group; under mp,
  ``broadcast_gradients`` then gives the replicated parameters the mp
  group's first rank's gradients.

The same ``gather`` joins the output channels of a Dense layer sharded over
an mp group (``mp.py``), and ``copy_to_group`` is its input's counterpart:
the identity forward, the sum over the group backward (each mp rank's
product gives its columns' share of the input's cotangent).

Every function is the identity for a group of None.  Collectives take the
tensors as they are, on the group's backend (``nccl``, or ``gloo`` on the
CPU and for ranks that share a card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its cotangent is the
    sum of the ranks' cotangents."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` itself, whose cotangent is summed over ``group``: the input of
    a product whose output columns are sharded over the group."""
    return x if group is None or not x.requires_grad else _CopyToGroup.apply(x, group)


def _gather(xs: Sequence[torch.Tensor], dim: int, group) -> list:
    world = dist.get_world_size(group)
    out = []
    for x in xs:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat(parts, dim=dim))
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, group, *xs):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.sizes = [x.shape[dim] for x in xs]
        return tuple(_gather(xs, dim, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(None if g is None else g.narrow(ctx.dim, ctx.rank * n, n)
                              for g, n in zip(gs, ctx.sizes)))


def gather(xs: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
           dim: int = 0) -> list:
    """Each tensor of ``xs`` gathered along ``dim`` over ``group`` in rank
    order (every rank holds equal parts).  Differentiable where an input
    needs a gradient: the code after the gather must be the same on every
    rank, and each rank's cotangent is its own slice of the gathered one."""
    if group is None:
        return list(xs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Gather.apply(dim, group, *xs))
    return _gather(xs, dim, group)


def _grads(params: Sequence[torch.Tensor]) -> tuple:
    """The parameters' gradients (zeros where there is none) and all of
    them laid end to end."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    return grads, torch.cat([g.reshape(-1) for g in grads])


def _set_grads(params: Sequence[torch.Tensor], grads: list, flat: torch.Tensor) -> None:
    at = 0
    for p, g in zip(params, grads):
        p.grad = flat[at:at + g.numel()].view_as(g)
        at += g.numel()


def reduce_gradients(params: Sequence[torch.Tensor],
                     group: Optional[dist.ProcessGroup]) -> None:
    """Sum every parameter's ``.grad`` over ``group`` in place, in one
    all-reduce of all of them laid end to end; a parameter without a
    gradient takes part as zeros and gets the sum."""
    if group is None:
        return
    grads, flat = _grads(params)
    _set_grads(params, grads, _sum(flat, group))


def broadcast_gradients(params: Sequence[torch.Tensor],
                        group: Optional[dist.ProcessGroup]) -> None:
    """Give every rank of ``group`` the first rank's ``.grad`` of each of
    ``params`` in place, in one broadcast of all of them laid end to end.
    The mp ranks compute the gradients of the replicated parameters each
    for itself from the same numbers, but a backward whose scatters add in
    a run-dependent order (atomics, threads) rounds them apart, and the
    replicated parameters would drift apart."""
    if group is None or not params:
        return
    grads, flat = _grads(params)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    _set_grads(params, grads, flat)
