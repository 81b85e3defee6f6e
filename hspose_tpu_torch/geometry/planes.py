"""Batched weighted least-squares plane fitting (counterpart of
``hspose_tpu/geometry/planes.py``)."""

from __future__ import annotations

import torch


def fit_plane_weighted(pc: torch.Tensor, w: torch.Tensor):
    """Fit z = a*x + b*y + c to weighted points pc (..., P, 3), w (..., P).

    Solves X = (A^T W A)^-1 A^T W b with A = [x, y, 1], b = z, then returns
    (normal (..., 3), dn (..., 3), for_p2plane (..., 1)) with
    dn = [X0 X2, X1 X2, -X2] / (X0^2 + X1^2 + 1 + 1e-8), normal = dn / |dn|
    and for_p2plane = X2 / sqrt(X0^2 + X1^2 + 1)."""
    A = torch.cat([pc[..., :2], torch.ones_like(pc[..., :1])], dim=-1)  # (..., P, 3)
    b = pc[..., 2:3]
    Aw = A * w[..., None]
    AtWA = A.transpose(-1, -2) @ Aw
    AtWb = A.transpose(-1, -2) @ (b * w[..., None])
    # linalg.solve's factorisation without its error check, which reads the
    # solver's status on the host: a singular fit gives non-finite losses,
    # which the train step's NaN guard skips
    X = torch.linalg.solve_ex(AtWA, AtWb, check_errors=False).result[..., 0]

    x0, x1, x2 = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    dn_up = torch.cat([x0 * x2, x1 * x2, -x2], dim=-1)
    dn_norm = x0 * x0 + x1 * x1 + 1.0
    dn = dn_up / (dn_norm + 1e-8)
    normal_n = dn / torch.linalg.vector_norm(dn, dim=-1, keepdim=True)
    return normal_n, dn, x2 / torch.sqrt(dn_norm)
