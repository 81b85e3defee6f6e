"""FS-Net pose losses (counterpart of ``hspose_tpu/losses/fs_net_loss.py``):
L1 (or SmoothL1) on the two rotation axes (red masked to non-axis-symmetric
samples with a bs/valid rescale), cosine variants, the |green . red|
orthogonality regulariser, translation/size L1, and confidence regression
against exp(-13.7 |err|^2) targets."""

from __future__ import annotations

from typing import Dict

import torch

from hspose_tpu_torch.config import LossConfig
from hspose_tpu_torch.geometry.rotations import batch_dot


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
