"""6-face bounding-box reconstruction losses (counterpart of
``hspose_tpu/losses/recon_loss.py``).

* ``Per_point``: per-point face-normal, face-distance and confidence losses;
* ``Point_voting``: per-face planes fitted by weighted least squares, with
  the rotation, translation, size and self-calibration terms derived from them.

The prediction stores faces as (y+, x+, z+, x-, z-, y-); the remap
``FACE_REMAP`` makes them axis-major (x+, y+, z+, x-, y-, z-), so faces 0..2
align with the +R columns and 3..5 with -R.  Masking: y faces always count,
x and z faces only for non-axis-symmetric samples, x faces also not for mugs
(obj_id 5).  Per-sample sums are divided by 6*bs.  A degenerate plane fit
gives NaN losses, which the train step's NaN guard skips.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.config import LossConfig
from hspose_tpu_torch.geometry.planes import fit_plane_weighted
from hspose_tpu_torch.geometry.rotations import batch_dot, get_vertical_rot_vec
from hspose_tpu_torch.utils.spans import span

FACE_REMAP = (1, 0, 2, 3, 5, 4)


def _remapped(*faces):
    """Each (B, N, 6, ...) face tensor with its faces in ``FACE_REMAP`` order;
    each index is a list the host copies to the device first, a sync."""
    out = []
    for f in faces:
        with span("sync.upload"):
            out.append(f[:, :, list(FACE_REMAP)])
    return out


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
    f_n, f_d, f_f = _remapped(face_normal, face_dis, face_f)

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
    with span("sync.upload"):  # the list index is copied to the device first
        y_up = n_up[:, [1, 1, 1]]
    with span("sync.upload"):
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

    f_n, f_d, f_c = _remapped(face_normal, face_dis, face_c)

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
