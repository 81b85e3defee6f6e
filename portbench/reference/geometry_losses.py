"""Pose geometry and the four loss families of the train step, a frozen copy
in plain PyTorch.

Copied from the port's plain modules, which its CPU tests hold to the JAX
package (the reference HS-Pose's ``network/fs_net_repo`` and ``losses``):
``hspose_tpu_torch/geometry/rotations.py:11-91``, ``geometry/planes.py:9-28``,
``losses/organize.py:7-16``, ``losses/fs_net_loss.py:16-99``,
``losses/geometry_loss.py:14-32``, ``losses/prop_loss.py:15-106`` and
``losses/recon_loss.py:20-212``, each section marked below.  Only the
imports changed: ``cfg`` is ``LossWeights``, the loss configuration's
defaults copied from ``hspose_tpu_torch/config.py:96-124``.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict

import torch

# hspose_tpu_torch/config.py:96-124 (LossConfig defaults; the reference
# HS-Pose config/config.py)
LossWeights = SimpleNamespace(
    fsnet_loss_type="l1", rot_1_w=8.0, rot_2_w=8.0, rot_regular=4.0, tran_w=8.0,
    size_w=8.0, recon_w=8.0, r_con_w=1.0, recon_n_w=3.0, recon_d_w=3.0, recon_v_w=1.0,
    recon_f_w=1.0, recon_bb_r_w=1.0, recon_bb_t_w=1.0, recon_bb_s_w=1.0,
    recon_bb_self_w=1.0, geo_p_w=1.0, prop_pm_w=2.0, prop_sym_w=1.0, prop_r_reg_w=1.0)
LossConfig = SimpleNamespace


# ---- copied from hspose_tpu_torch/geometry/rotations.py ----
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


# ---- copied from hspose_tpu_torch/geometry/planes.py ----
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
    X = torch.linalg.solve(AtWA, AtWb)[..., 0]

    x0, x1, x2 = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    dn_up = torch.cat([x0 * x2, x1 * x2, -x2], dim=-1)
    dn_norm = x0 * x0 + x1 * x1 + 1.0
    dn = dn_up / (dn_norm + 1e-8)
    normal_n = dn / torch.linalg.vector_norm(dn, dim=-1, keepdim=True)
    return normal_n, dn, x2 / torch.sqrt(dn_norm)


# ---- copied from hspose_tpu_torch/losses/organize.py ----
def control_loss(train_stage: str):
    if train_stage == "PoseNet_only":
        name_fs_list = ["Rot1", "Rot2", "Rot1_cos", "Rot2_cos", "Rot_regular",
                        "Tran", "Size", "R_con"]
        name_recon_list = ["Per_point", "Point_voting"]
        name_geo_list = ["Geo_point"]
        name_prop_list = ["Prop_pm", "Prop_sym"]
    else:
        raise NotImplementedError(train_stage)
    return name_fs_list, name_recon_list, name_geo_list, name_prop_list


# ---- copied from hspose_tpu_torch/losses/fs_net_loss.py ----
def l1(pred, gt):
    return (pred - gt).abs().mean()


def smooth_l1(pred, gt, beta):
    d = (pred - gt).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _base_loss(cfg: LossConfig):
    if cfg.fsnet_loss_type == "l1":
        return l1
    if cfg.fsnet_loss_type == "smoothl1":
        return lambda p, g: smooth_l1(p, g, 0.5)
    raise NotImplementedError(cfg.fsnet_loss_type)


def _rescale_by_valid(res, flag, bs):
    """Masked-mean rescale: res (a mean over all samples, zeros where masked)
    times bs/valid when any sample is valid."""
    valid = flag.to(res.dtype).sum()
    return torch.where(valid > 0, res * bs / torch.clamp(valid, min=1.0), res)


def loss_rot2(loss_fn, pred_v, gt_v, sym, bs):
    flag = (sym[:, 0] == 0)[:, None]
    res = loss_fn(torch.where(flag, pred_v, 0.0), torch.where(flag, gt_v, 0.0))
    return _rescale_by_valid(res, flag[:, 0], bs)


def cosine_dis(pred_v, gt_v):
    return ((1.0 - batch_dot(pred_v, gt_v)) * 2.0).mean()


def cosine_dis_sym(pred_v, gt_v, sym, bs):
    res = (1.0 - batch_dot(pred_v, gt_v)) * 2.0
    flag = sym[:, 0] == 0
    return _rescale_by_valid(torch.where(flag, res, 0.0).mean(), flag, bs)


def rot_regular_angle(pred_v1, pred_v2, sym, bs):
    res = batch_dot(pred_v1, pred_v2).abs()
    flag = sym[:, 0] == 0
    return _rescale_by_valid(torch.where(flag, res, 0.0).mean(), flag, bs)


def loss_r_con(loss_fn, p_rot_g, p_rot_r, g_rot_g, g_rot_r, p_g_con, p_r_con, sym):
    dis_g = torch.linalg.vector_norm(p_rot_g - g_rot_g, dim=-1)
    res_g = loss_fn(torch.exp(-13.7 * dis_g * dis_g), p_g_con)
    dis_r = torch.linalg.vector_norm(p_rot_r - g_rot_r, dim=-1)
    p_r_con_gt = torch.exp(-13.7 * dis_r * dis_r)
    flag = sym[:, 0] == 0
    res_r = loss_fn(torch.where(flag, p_r_con_gt, 0.0), torch.where(flag, p_r_con, 0.0))
    return res_g + res_r


def fs_net_loss(cfg: LossConfig, name_list, pred, gt, sym) -> Dict[str, torch.Tensor]:
    """pred/gt: dicts with Rot1, Rot2, Rot1_f, Rot2_f, Tran, Size."""
    f = _base_loss(cfg)
    bs = pred["Rot1"].shape[0]
    out = {}
    if "Rot1" in name_list:
        out["Rot1"] = cfg.rot_1_w * f(pred["Rot1"], gt["Rot1"])
    if "Rot1_cos" in name_list:
        out["Rot1_cos"] = cfg.rot_1_w * cosine_dis(pred["Rot1"], gt["Rot1"])
    if "Rot2" in name_list:
        out["Rot2"] = cfg.rot_2_w * loss_rot2(f, pred["Rot2"], gt["Rot2"], sym, bs)
    if "Rot2_cos" in name_list:
        out["Rot2_cos"] = cfg.rot_2_w * cosine_dis_sym(pred["Rot2"], gt["Rot2"], sym, bs)
    if "Rot_regular" in name_list:
        out["Rot_r_a"] = cfg.rot_regular * rot_regular_angle(pred["Rot1"], pred["Rot2"],
                                                             sym, bs)
    if "Recon" in name_list:
        out["Recon"] = cfg.recon_w * f(pred["Recon"], gt["Recon"])
    if "Tran" in name_list:
        out["Tran"] = cfg.tran_w * f(pred["Tran"], gt["Tran"])
    if "Size" in name_list:
        out["Size"] = cfg.size_w * f(pred["Size"], gt["Size"])
    if "R_con" in name_list:
        out["R_con"] = cfg.r_con_w * loss_r_con(f, pred["Rot1"], pred["Rot2"],
                                                gt["Rot1"], gt["Rot2"],
                                                pred["Rot1_f"], pred["Rot2_f"], sym)
    return out


# ---- copied from hspose_tpu_torch/losses/geometry_loss.py ----
def geo_loss_point(points, p_rot_g, p_rot_r, p_t, g_R, g_t, sym):
    bs = points.shape[0]
    points_re = (points - g_t[:, None, :]) @ g_R  # R^T (p - t), row form
    rel = points - p_t[:, None, :]
    res_geo_y = l1((rel * p_rot_g[:, None, :]).sum(-1), points_re[:, :, 1])

    flag = sym[:, 0] == 0
    points_re_x = torch.where(flag[:, None], (rel * p_rot_r[:, None, :]).sum(-1), 0.0)
    new_points_re = torch.where(flag[:, None, None], points_re, 0.0)
    res_geo_x = _rescale_by_valid(l1(points_re_x, new_points_re[..., 0]), flag, bs)
    return res_geo_y + res_geo_x


def geo_transform_loss(cfg: LossConfig, name_list, pred, gt, sym):
    out = {}
    if "Geo_point" in name_list:
        out["geo_point"] = cfg.geo_p_w * geo_loss_point(
            gt["Points"], pred["Rot1"], pred["Rot2"], pred["Tran"], gt["R"], gt["T"], sym)
    return out


# ---- copied from hspose_tpu_torch/losses/prop_loss.py ----
_Y_REF = (-1.0, 1.0, -1.0)
_YX_REF = (1.0, 1.0, -1.0)


def _project(R, t, points):
    """R^T (points - t): world -> object frame, batched."""
    return (points - t[:, None, :]) @ R


def _to_world(R, t, pts):
    return pts @ R.transpose(-1, -2) + t[:, None, :]


def prop_point_matching_loss(points, p_g_vec, f_g_vec, p_r_vec, f_r_vec, p_t, g_R,
                             g_t, sym):
    points_re = _project(g_R, g_t, points)

    near_zero = torch.full_like(f_g_vec, 1e-5)
    ny_sym, nx_sym = get_vertical_rot_vec(f_g_vec, near_zero, p_g_vec, g_R[..., 0])
    ny, nx = get_vertical_rot_vec(f_g_vec, f_r_vec, p_g_vec, p_r_vec)
    sym_flag = (sym[:, 0] == 1)[:, None]
    new_y = torch.where(sym_flag, ny_sym, ny)
    new_x = torch.where(sym_flag, nx_sym, nx)
    p_R = get_rot_mat_y_first(new_y, new_x)
    return l1(_project(p_R, p_t, points), points_re)


def _y_reflection_flag(sym):
    """can/bowl/bottle: axis-symmetric with at least one reflection plane."""
    return (sym[:, 0] == 1) & (sym[:, 1:].sum(-1) > 0)


def _yx_reflection_flag(sym):
    """laptop / mug-with-handle: xy-plane reflection only."""
    return (sym[:, 0] == 0) & (sym[:, 1] == 1)


def prop_sym_matching_loss(PC, PC_re, p_g_vec, p_r_vec, p_t, gt_R, gt_t, sym):
    """Returns (res_p_recon, res_p_rt)."""
    cano = _project(gt_R, gt_t, PC)

    y_flag = _y_reflection_flag(sym)[:, None, None]
    yx_flag = _yx_reflection_flag(sym)[:, None, None]
    no_flag = ((sym[:, 0] == 0) & (sym[:, 1] != 1))[:, None, None]

    y_ref = cano * cano.new_tensor(_Y_REF)
    yx_ref = cano * cano.new_tensor(_YX_REF)
    gt_pc = (torch.where(y_flag, _to_world(gt_R, gt_t, y_ref), 0.0)
             + torch.where(yx_flag, _to_world(gt_R, gt_t, yx_ref), 0.0)
             + torch.where(no_flag, PC, 0.0))
    # a mug without a visible handle is excluded entirely
    excluded = ((sym[:, 0] == 1) & (sym[:, 1:].sum(-1) == 0))[:, None, None]
    res_p_recon = l1(gt_pc, torch.where(excluded, 0.0, PC_re))

    # y-axis reflection (180 degrees about the predicted green axis)
    pc_t_res = PC - p_t[:, None, :]
    along_g = batch_dot(pc_t_res, p_g_vec[:, None, :], keepdim=True) * p_g_vec[:, None, :]
    pc_b_y = PC + 2.0 * (along_g - pc_t_res)

    # xy-plane reflection through the predicted plane normal z = x cross y
    p_z = torch.linalg.cross(p_r_vec, p_g_vec, dim=-1)
    p_z = p_z / (torch.linalg.vector_norm(p_z, dim=-1, keepdim=True) + 1e-8)
    t_plane = -(batch_dot(PC, p_z[:, None, :], keepdim=True)
                - batch_dot(p_z, p_t)[:, None, None])
    pc_b_yx = PC + 2.0 * p_z[:, None, :] * t_plane

    pc_b = torch.where(y_flag, pc_b_y, 0.0) + torch.where(yx_flag, pc_b_yx, 0.0)
    pc_re_rt = torch.where(y_flag, PC_re, 0.0) + torch.where(yx_flag, PC_re, 0.0)
    return res_p_recon, l1(pc_b, pc_re_rt)


def prop_rot_reg_loss(f_g_vec, f_r_vec):
    return (1.0 - (f_g_vec + f_r_vec)).abs().mean()


def prop_rot_loss(cfg: LossConfig, name_list, pred, gt, sym):
    out = {}
    if "Prop_pm" in name_list:
        out["Prop_pm"] = cfg.prop_pm_w * prop_point_matching_loss(
            gt["Points"], pred["Rot1"], pred["Rot1_f"], pred["Rot2"], pred["Rot2_f"],
            pred["Tran"], gt["R"], gt["T"], sym)
    if "Prop_r_reg" in name_list:
        out["Prop_r_reg"] = cfg.prop_r_reg_w * prop_rot_reg_loss(pred["Rot1_f"],
                                                                 pred["Rot2_f"])
    if "Prop_sym" in name_list and cfg.prop_sym_w > 0:
        recon, rt = prop_sym_matching_loss(gt["Points"], pred["Recon"], pred["Rot1"],
                                           pred["Rot2"], pred["Tran"], gt["R"],
                                           gt["T"], sym)
        out["Prop_sym_recon"] = cfg.prop_sym_w * recon
        out["Prop_sym_rt"] = cfg.prop_sym_w * rt
    return out


# ---- copied from hspose_tpu_torch/losses/recon_loss.py ----
FACE_REMAP = (1, 0, 2, 3, 5, 4)


def _select_sum(res, sym_flag, obj_ids, xz_only: bool = False):
    """res (B, 3) per-axis values -> masked scalar sum."""
    xmask = (sym_flag == 0) & (obj_ids != 5)
    xres = torch.where(xmask, res[:, 0], 0.0).sum()
    zres = torch.where(sym_flag == 0, res[:, 2], 0.0).sum()
    if xz_only:
        return xres + zres
    return xres + res[:, 1].sum() + zres


# ----------------------------------------------------------------------------- #
# Per_point
# ----------------------------------------------------------------------------- #

def _face_normal_loss(gt_R, face_normal, sym_flag):
    """face_normal (B, N, 6, 3) axis-major."""
    def one_side(normals, R):
        # norm_dis[b, n, i] = normals[b, n, i] . R[:, i]
        norm_dis = (normals * R.transpose(-1, -2)[:, None]).sum(-1)
        res = (1.0 - norm_dis).mean(1)  # (B, 3)
        xz = torch.where(sym_flag == 0, res[:, 0] + res[:, 2], 0.0)
        return res[:, 1].sum() + xz.sum()

    return one_side(face_normal[:, :, 0:3], gt_R) + one_side(face_normal[:, :, 3:6], -gt_R)


def _face_dis_loss(face_dis, dis_plus_gt, dis_minus_gt, sym_flag, obj_ids):
    """face_dis (B, N, 6); gt (B, N, 3)."""
    def one_side(dis, dis_gt):
        return _select_sum((dis - dis_gt).abs().mean(1), sym_flag, obj_ids)

    return one_side(face_dis[:, :, :3], dis_plus_gt) + one_side(face_dis[:, :, 3:], dis_minus_gt)


def _face_conf_loss(face_f, face_dis, face_normal, dis_plus_gt, dis_minus_gt, gt_R,
                    sym_flag, obj_ids):
    def one_side(f, dis, normals, dis_gt, R):
        # target vector of face i: R[:, i] * dis_gt[b, n, i]
        target = R.transpose(-1, -2)[:, None] * dis_gt[..., None]  # (B, N, 3, 3)
        cc = torch.linalg.vector_norm(normals * dis[..., None] - target, dim=-1)
        f_up = torch.exp(-303.5 * cc * cc)
        return _select_sum((f_up - f).abs().mean(1), sym_flag, obj_ids)

    up = one_side(face_f[:, :, :3], face_dis[:, :, :3], face_normal[:, :, 0:3],
                  dis_plus_gt, gt_R)
    down = one_side(face_f[:, :, 3:], face_dis[:, :, 3:], face_normal[:, :, 3:6],
                    dis_minus_gt, -gt_R)
    return up + down


def recon_loss_point(pc, face_normal, face_dis, face_f, gt_R, gt_t, gt_s, mean_shape,
                     sym, obj_ids):
    """Returns (res_normal, res_dis, res_f)."""
    bs = pc.shape[0]
    remap = list(FACE_REMAP)
    f_n = face_normal[:, :, remap]
    f_d = face_dis[:, :, remap]
    f_f = face_f[:, :, remap]

    pc_proj = (pc - gt_t[:, None, :]) @ gt_R
    re_s = gt_s + mean_shape
    dis_plus_gt = re_s[:, None, :] / 2.0 - pc_proj
    dis_minus_gt = re_s[:, None, :] / 2.0 + pc_proj

    sym_flag = sym[:, 0]
    res_normal = _face_normal_loss(gt_R, f_n, sym_flag) / 6.0 / bs
    res_dis = _face_dis_loss(f_d, dis_plus_gt, dis_minus_gt, sym_flag, obj_ids) / 6.0 / bs
    res_f = _face_conf_loss(f_f, f_d, f_n, dis_plus_gt, dis_minus_gt, gt_R, sym_flag,
                            obj_ids) / 6.0 / bs
    return res_normal, res_dis, res_f


# ----------------------------------------------------------------------------- #
# Point_voting
# ----------------------------------------------------------------------------- #

def _recon_geo_loss(pc_on_plane, face_c, gt_t, gt_R, re_s, sym_flag, obj_ids):
    """pc_on_plane (B, N, 3, 3) votes for 3 faces, face_c (B, N, 3) weights.
    Returns (res_vote, new_n, new_c, new_dn), the plane fits sign-aligned to
    the gt axes."""
    pts = pc_on_plane.transpose(1, 2)  # (B, 3, N, 3)
    weights = face_c.transpose(1, 2)  # (B, 3, N)
    new_n, new_dn, new_c = fit_plane_weighted(pts, weights)

    # flip where n_f . R[:, f] < 0
    align = (new_n * gt_R.transpose(-1, -2)).sum(-1)[..., None]  # (B, 3, 1)
    flip = align < 0
    new_n = torch.where(flip, -new_n, new_n)
    new_c = torch.where(flip, -new_c, new_c)

    # face-centre offsets: row f = t + R[:, f] * s_f / 2
    Rt = gt_R.transpose(-1, -2)
    re_s_trans = gt_t[:, None, :] + Rt * re_s[..., None] / 2.0
    proj = (Rt * re_s_trans).sum(-1)  # R[:, f] . centre_f
    dn_gts = Rt * (-proj[..., None])

    res = (new_dn - dn_gts).abs().mean(-1)  # (B, 3)
    return _select_sum(res, sym_flag, obj_ids), new_n, new_c, new_dn


def _geo_recon_loss_r(f_rot_g, f_rot_r, p_rot_g, p_rot_r, n_up, n_down, sym_flag, obj_ids):
    new_y, new_x = get_vertical_rot_vec(f_rot_g, f_rot_r, p_rot_g, p_rot_r)
    new_z = torch.linalg.cross(new_x, new_y, dim=-1)
    new_normal = torch.stack([new_x, new_y, new_z], dim=-2)  # (B, 3, 3) rows
    res_up = (n_up - new_normal).abs().mean(-1)
    res_down = (n_down + new_normal).abs().mean(-1)
    return (_select_sum(res_up, sym_flag, obj_ids)
            + _select_sum(res_down, sym_flag, obj_ids))


def _geo_recon_loss_t(p_t, n_up, n_down, c_up, c_down, sym_flag, obj_ids):
    p_t_rep = p_t[:, None, :].expand(n_up.shape)
    dis_up = (batch_dot(n_up, p_t_rep, keepdim=True) + c_up).abs()[..., 0]  # (B, 3)
    dis_down = (batch_dot(n_down, p_t_rep, keepdim=True) + c_down).abs()[..., 0]
    res = (dis_down - dis_up).abs()
    return _select_sum(res, sym_flag, obj_ids), dis_up, dis_down


def _geo_recon_loss_s(pre_s, dis_up, dis_down, sym_flag, obj_ids):
    res_up = _select_sum((pre_s / 2.0 - dis_up).abs(), sym_flag, obj_ids)
    res_down = _select_sum((pre_s / 2.0 - dis_down).abs(), sym_flag, obj_ids)
    return res_up + res_down


def _geo_recon_loss_self_cal(n_up, n_down, sym_flag, obj_ids):
    res_parallel = _select_sum((n_up + n_down).abs().mean(-1), sym_flag, obj_ids)
    y_up = n_up[:, [1, 1, 1]]
    y_down = n_down[:, [1, 1, 1]]
    res_v_up = _select_sum(batch_dot(y_up, n_up).abs(), sym_flag, obj_ids, xz_only=True)
    res_v_down = _select_sum(batch_dot(y_down, n_down).abs(), sym_flag, obj_ids,
                             xz_only=True)
    return res_parallel + res_v_up + res_v_down


def recon_loss_vote(pc, face_normal, face_dis, face_c, p_rot_g, f_rot_g, p_rot_r,
                    f_rot_r, p_t, p_s, gt_R, gt_t, gt_s, mean_shape, sym, obj_ids):
    """The five vote-loss scalars."""
    bs = pc.shape[0]
    re_s = gt_s + mean_shape
    pre_s = p_s + mean_shape

    remap = list(FACE_REMAP)
    f_n = face_normal[:, :, remap]
    f_d = face_dis[:, :, remap]
    f_c = face_c[:, :, remap]

    pc_on_plane = pc[:, :, None, :] + f_d[..., None] * f_n  # (B, N, 6, 3)

    sym_flag = sym[:, 0]
    res_vote_plus, n_up, c_up, _ = _recon_geo_loss(pc_on_plane[:, :, :3], f_c[:, :, :3],
                                                   gt_t, gt_R, re_s, sym_flag, obj_ids)
    res_vote_minus, n_down, c_down, _ = _recon_geo_loss(pc_on_plane[:, :, 3:],
                                                        f_c[:, :, 3:], gt_t, -gt_R,
                                                        re_s, sym_flag, obj_ids)

    res_vote = (res_vote_minus + res_vote_plus) / 6.0 / bs
    res_r = _geo_recon_loss_r(f_rot_g, f_rot_r, p_rot_g, p_rot_r, n_up, n_down,
                              sym_flag, obj_ids) / 6.0 / bs
    res_t, dis_up, dis_down = _geo_recon_loss_t(p_t, n_up, n_down, c_up, c_down,
                                                sym_flag, obj_ids)
    res_t = res_t / 6.0 / bs
    res_s = _geo_recon_loss_s(pre_s, dis_up, dis_down, sym_flag, obj_ids) / 6.0 / bs
    res_self = _geo_recon_loss_self_cal(n_up, n_down, sym_flag, obj_ids) / 6.0 / bs
    return res_vote, res_r, res_t, res_s, res_self


def recon_6face_loss(cfg: LossConfig, name_list, pred, gt, sym, obj_ids):
    out = {}
    if "Per_point" in name_list:
        res_normal, res_dis, res_f = recon_loss_point(
            gt["Points"], pred["F_n"], pred["F_d"], pred["F_c"], gt["R"], gt["T"],
            gt["Size"], gt["Mean_shape"], sym, obj_ids)
        out["recon_per_p"] = cfg.recon_n_w * res_normal + cfg.recon_d_w * res_dis
        out["recon_p_f"] = cfg.recon_f_w * res_f
    if "Point_voting" in name_list:
        # the confidences are detached for the vote loss
        vote, r, t, s, self_cal = recon_loss_vote(
            gt["Points"], pred["F_n"], pred["F_d"], pred["F_c"].detach(), pred["Rot1"],
            pred["Rot1_f"], pred["Rot2"], pred["Rot2_f"], pred["Tran"], pred["Size"],
            gt["R"], gt["T"], gt["Size"], gt["Mean_shape"], sym, obj_ids)
        out["recon_point_vote"] = cfg.recon_v_w * vote
        out["recon_point_r"] = cfg.recon_bb_r_w * r
        out["recon_point_t"] = cfg.recon_bb_t_w * t
        out["recon_point_s"] = cfg.recon_bb_s_w * s
        out["recon_point_self"] = cfg.recon_bb_self_w * self_cal
    return out
