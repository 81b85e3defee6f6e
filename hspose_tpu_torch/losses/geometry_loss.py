"""Geometric consistency loss (counterpart of
``hspose_tpu/losses/geometry_loss.py``): the cloud in the gt object frame
against its projection on the predicted axes, L1; the x term masked to
non-axis-symmetric samples with the bs/valid rescale."""

from __future__ import annotations

import torch

from hspose_tpu_torch.config import LossConfig
from hspose_tpu_torch.losses.fs_net_loss import _rescale_by_valid, l1


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
