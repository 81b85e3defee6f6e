"""Chamfer distance through hand-written CUDA kernels.

Counterpart of ``hspose_tpu/ops/chamfer.py``: ``chamfer_distance(a, b)``
returns, for clouds a (B, N, 3) and b (B, M, 3) in fp32, the squared
distance from each point of a to its nearest point of b (B, N) and the
reverse (B, M), as the reference's CUDA extension's forward.  Three kernels
of ``csrc/chamfer.cu``, each behind a wrapper that runs its plain version
(in this module) on CPU tensors and on CUDA tensors launches the kernel or
raises; each counts its launches in ``.launches``:

* ``chamfer_min_cuda`` -> K16 (``_chamfer_kernel``), plain ``chamfer_min``;
* ``chamfer_min_argmin_cuda`` -> K17 (``_chamfer_fwd_idx_kernel``), plain
  ``chamfer_min_argmin``: the minimum and its first index;
* ``chamfer_grad_cuda`` -> K18 (``_chamfer_bwd_kernel``), plain
  ``chamfer_grad``: the gradient for one cloud.

Under ``torch.no_grad()``, or when neither cloud requires grad,
``chamfer_distance`` launches K16 twice (one per direction) and nothing
else.  Otherwise it is an autograd Function, as the JAX op's custom VJP:
the forward launches K17 twice and keeps the argmins, and the backward
launches K18 once per cloud that needs a gradient.  Distances are
|a|^2 + |b|^2 - 2 a.b in fp32 (``ops/knn.py::pairwise_sq_dist``), so
coincident points may give small negative values, kept as the JAX function
keeps them.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import pairwise_sq_dist


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, 3) at idx (B, N) -> (B, N, 3)."""
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[batch, idx.long()]


def chamfer_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per point of a (B, N, 3): min squared distance to b (B, M, 3) -> (B, N)."""
    return pairwise_sq_dist(a, b).amin(-1)


def chamfer_min_argmin(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``chamfer_min`` and the first index of each minimum, int32 (B, N)."""
    d, i = pairwise_sq_dist(a, b).min(-1)
    return d, i.to(torch.int32)


def chamfer_grad(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                 gda: torch.Tensor, gdb: torch.Tensor) -> torch.Tensor:
    """The gradient of chamfer_distance with respect to a (B, N, 3), given
    the argmins ia (B, N) into b and ib (B, M) into a and the cotangents gda
    (B, N), gdb (B, M): ga_i = 2 (a_i - b_{ia_i}) gda_i plus, added in
    increasing j by ``index_add_``, -2 (b_j - a_i) gdb_j for each j with
    ib_j = i (hspose_tpu/ops/chamfer.py::_chamfer_bwd)."""
    B, N, _ = a.shape
    diff_a = 2.0 * (a - _rows(b, ia)) * gda[..., None]
    diff_b = 2.0 * (b - _rows(a, ib)) * gdb[..., None]
    rows = (ib.long() + N * torch.arange(B, device=a.device)[:, None]).reshape(-1)
    ga = diff_a.reshape(B * N, 3).index_add(0, rows, -diff_b.reshape(-1, 3))
    return ga.reshape(B, N, 3)


def _check_clouds(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    _build.check(a, "a", torch.float32, (None, None, 3))
    B, N, _ = a.shape
    _build.check(b, "b", torch.float32, (B, None, 3))
    if N < 1 or b.shape[1] < 1:
        raise ValueError(f"empty cloud: a {tuple(a.shape)}, b {tuple(b.shape)}")
    return B, N, b.shape[1]


def _no_grad_inputs(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the chamfer kernels are not differentiable one by one: "
                         "call chamfer_distance")


def chamfer_min_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K16: see ``chamfer_min``."""
    if _build.on_cpu(a, b):
        return chamfer_min(a, b)
    _no_grad_inputs(a, b)
    B, N, M = _check_clouds(a, b)
    dist = torch.empty((B, N), dtype=torch.float32, device=a.device)
    _build.launch("hs_chamfer_min", a, b, dist, B, N, M)
    chamfer_min_cuda.launches += 1
    return dist


def chamfer_min_argmin_cuda(a: torch.Tensor, b: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K17: see ``chamfer_min_argmin``."""
    if _build.on_cpu(a, b):
        return chamfer_min_argmin(a, b)
    _no_grad_inputs(a, b)
    B, N, M = _check_clouds(a, b)
    dist = torch.empty((B, N), dtype=torch.float32, device=a.device)
    arg = torch.empty((B, N), dtype=torch.int32, device=a.device)
    _build.launch("hs_chamfer_min_argmin", a, b, dist, arg, B, N, M)
    chamfer_min_argmin_cuda.launches += 1
    return dist, arg


def chamfer_grad_cuda(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                      gda: torch.Tensor, gdb: torch.Tensor) -> torch.Tensor:
    """K18: see ``chamfer_grad``.  Deterministic: the scatter is summed per
    point of a in increasing j, with no atomics."""
    if _build.on_cpu(a, b, ia, ib, gda, gdb):
        return chamfer_grad(a, b, ia, ib, gda, gdb)
    B, N, M = _check_clouds(a, b)
    _build.check(ia, "ia", torch.int32, (B, N))
    _build.check(ib, "ib", torch.int32, (B, M))
    _build.check(gda, "gda", torch.float32, (B, N))
    _build.check(gdb, "gdb", torch.float32, (B, M))
    rowptr = torch.empty((B, N + 1), dtype=torch.int32, device=a.device)
    ent = torch.empty((B, M), dtype=torch.int32, device=a.device)
    ga = torch.empty((B, N, 3), dtype=torch.float32, device=a.device)
    _build.launch("hs_chamfer_grad", a, b, ia, ib, gda, gdb, rowptr, ent, ga, B, N, M)
    chamfer_grad_cuda.launches += 1
    return ga


for _wrapper in (chamfer_min_cuda, chamfer_min_argmin_cuda, chamfer_grad_cuda):
    _wrapper.launches = 0


class ChamferDistance(torch.autograd.Function):
    """``chamfer_distance`` differentiable in both clouds."""

    @staticmethod
    def forward(ctx, a, b):
        da, ia = chamfer_min_argmin_cuda(a, b)
        db, ib = chamfer_min_argmin_cuda(b, a)
        ctx.save_for_backward(a, b, ia, ib)
        return da, db

    @staticmethod
    def backward(ctx, gda, gdb):
        a, b, ia, ib = ctx.saved_tensors
        gda, gdb = gda.float().contiguous(), gdb.float().contiguous()
        need = ctx.needs_input_grad
        ga = chamfer_grad_cuda(a, b, ia, ib, gda, gdb) if need[0] else None
        gb = chamfer_grad_cuda(b, a, ib, ia, gdb, gda) if need[1] else None
        return ga, gb


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(da (B, N), db (B, M)): squared distance from each point of a to the
    nearest point of b, and from each point of b to the nearest of a."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return ChamferDistance.apply(a, b)
    return chamfer_min_cuda(a, b), chamfer_min_cuda(b, a)


def chamfer_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar symmetric chamfer loss (mean of both directions)."""
    da, db = chamfer_distance(a, b)
    return da.mean() + db.mean()
