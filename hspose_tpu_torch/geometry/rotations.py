"""Rotation-vector geometry, batched (counterpart of
``hspose_tpu/geometry/rotations.py``)."""

from __future__ import annotations

import math

import torch

from hspose_tpu_torch.utils.spans import span


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along ``dim`` with the norm clamped at ``eps``."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def batch_dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Row-wise dot product over the last axis."""
    out = (a * b).sum(-1)
    return out[..., None] if keepdim else out


def rodrigues_matrix(axis: torch.Tensor, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Rotations about unit ``axis`` (..., 3) with sin ``s`` / cos ``c``
    (..., 1) -> (..., 3, 3)."""
    x, y, z = axis[..., 0:1], axis[..., 1:2], axis[..., 2:3]
    one_c = 1.0 - c
    r1 = torch.cat([x * x * one_c + c, x * y * one_c - z * s, x * z * one_c + y * s], -1)
    r2 = torch.cat([y * x * one_c + z * s, y * y * one_c + c, y * z * one_c - x * s], -1)
    r3 = torch.cat([x * z * one_c - y * s, z * y * one_c + x * s, z * z * one_c + c], -1)
    return torch.stack([r1, r2, r3], dim=-2)


def get_vertical_rot_vec(c1: torch.Tensor, c2: torch.Tensor, y: torch.Tensor,
                         z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Confidence-weighted re-orthogonalisation of the (y, z) axis pair:
    c1, c2 (B,), y, z (B, 3) -> (new_y, new_z).  The cosine is clamped to
    [-1 + 1e-6, 1 - 1e-6] before acos."""
    c1 = c1[..., None]
    c2 = c2[..., None]
    rot_x = torch.linalg.cross(y, z, dim=-1)
    rot_x = rot_x / (torch.linalg.vector_norm(rot_x, dim=-1, keepdim=True) + 1e-8)
    y_z_cos = torch.clamp((y * z).sum(-1, keepdim=True), -1 + 1e-6, 1 - 1e-6)
    y_z_theta = torch.acos(y_z_cos)
    theta_2 = c1 / (c1 + c2) * (y_z_theta - math.pi / 2)
    theta_1 = c2 / (c1 + c2) * (y_z_theta - math.pi / 2)

    rot_y = rodrigues_matrix(rot_x, torch.sin(theta_1), torch.cos(theta_1))
    new_y = (rot_y @ y[..., None])[..., 0]
    rot_z = rodrigues_matrix(rot_x, torch.sin(-theta_2), torch.cos(-theta_2))
    new_z = (rot_z @ z[..., None])[..., 0]
    return new_y, new_z


def get_rot_mat_y_first(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R = [x' y' z'] columns from a trusted y axis and an x hint."""
    y = normalize(y)
    z = normalize(torch.linalg.cross(x, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def to_R_matrices(f_g: torch.Tensor, f_r: torch.Tensor, p_g: torch.Tensor,
                  p_r: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted rotation assembly."""
    new_y, new_x = get_vertical_rot_vec(f_g, f_r, p_g, p_r)
    return get_rot_mat_y_first(new_y, new_x)


def generate_RT(green_vec: torch.Tensor, red_vec: torch.Tensor, f_green: torch.Tensor,
                f_red: torch.Tensor, T: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Homogeneous poses (B, 4, 4) from the two axis heads.  For
    axis-symmetric objects (sym[:, 0] == 1) the red confidence is zeroed, so
    the y axis trusts the green head alone."""
    with span("model.generate_RT"):
        f_red = torch.where(sym[:, 0] == 1, torch.zeros_like(f_red), f_red)
        Rs = to_R_matrices(f_green, f_red, green_vec, red_vec)
        res = torch.eye(4, dtype=T.dtype, device=T.device).repeat(T.shape[0], 1, 1)
        res[:, :3, :3] = Rs
        res[:, :3, 3] = T
        return res


def get_gt_v(Rs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """gt green (y column) and red (x column) axes of R, as the reference's
    corner-matrix product gives them at its live call site."""
    return Rs[..., :, 1], Rs[..., :, 0]


def get_size(model: torch.Tensor) -> torch.Tensor:
    """Axis-aligned extents of a model point cloud (..., P, 3) -> (..., 3)."""
    return model.amax(dim=-2) - model.amin(dim=-2)
