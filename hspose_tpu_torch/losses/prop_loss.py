"""Prop losses: point matching and symmetry matching (counterpart of
``hspose_tpu/losses/prop_loss.py``)."""

from __future__ import annotations

import torch

from hspose_tpu_torch.config import LossConfig
from hspose_tpu_torch.geometry.rotations import (
    batch_dot,
    get_rot_mat_y_first,
    get_vertical_rot_vec,
)
from hspose_tpu_torch.losses.fs_net_loss import l1
from hspose_tpu_torch.utils.consts import const

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


def _reflection_signs(like):
    """The y and yx reflections' signs per axis, of ``like``'s type and device."""
    return (const(_Y_REF, like.device, like.dtype), const(_YX_REF, like.device, like.dtype))


def prop_sym_matching_loss(PC, PC_re, p_g_vec, p_r_vec, p_t, gt_R, gt_t, sym):
    """Returns (res_p_recon, res_p_rt)."""
    cano = _project(gt_R, gt_t, PC)

    y_flag = _y_reflection_flag(sym)[:, None, None]
    yx_flag = _yx_reflection_flag(sym)[:, None, None]
    no_flag = ((sym[:, 0] == 0) & (sym[:, 1] != 1))[:, None, None]

    y_sign, yx_sign = _reflection_signs(cano)
    y_ref = cano * y_sign
    yx_ref = cano * yx_sign
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
