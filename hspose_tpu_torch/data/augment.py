"""Batched on-device point-cloud augmentation (counterpart of
``hspose_tpu/data/augment.py``).

Four Bernoulli-gated transforms, in this order: bounding-box rescale
(p=0.3), rigid R/t perturbation (p=0.3), box-cage taper (p=0.3, bowl and mug
only), per-point radial jitter (p=0.2).  The random draws are explicit
(``AugmentDraws``); ``draw_augment`` makes them from a ``torch.Generator``.
The JAX package draws them from a PRNG key instead, so the two agree only
when they are handed the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hspose_tpu_torch.config import AugConfig
from hspose_tpu_torch.utils.consts import const


class AugmentedBatch(NamedTuple):
    pc: torch.Tensor
    gt_R: torch.Tensor
    gt_t: torch.Tensor
    gt_s: torch.Tensor


class AugmentDraws(NamedTuple):
    flags: torch.Tensor    # (4, B, 1) U[0, 1): bb, rt, bc, pc gates
    ey_up: torch.Tensor    # (B, 1) U[0.8, 1.2): box-cage scale at the top
    ey_down: torch.Tensor  # (B, 1) U[0.8, 1.2): box-cage scale at the bottom
    defor: torch.Tensor    # (B, N, 3) U[0, 1): per-point jitter before * pc_r


def draw_augment(generator: torch.Generator, bs: int, n: int) -> AugmentDraws:
    """The draws of one batch, on the generator's device."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    return AugmentDraws(u(4, bs, 1), 0.8 + 0.4 * u(bs, 1), 0.8 + 0.4 * u(bs, 1), u(bs, n, 3))


def _to_object(R, t, pc):
    return (pc - t[:, None, :]) @ R


def _to_world(R, t, pc):
    return pc @ R.transpose(-1, -2) + t[:, None, :]


def _xz_swapped(aug_bb):
    """(B, 3) with the x and z scales swapped."""
    return aug_bb[:, const((2, 1, 0), aug_bb.device)]


def defor_bb(pc, model_point, R, t, s, sym, aug_bb):
    """Anisotropic box rescale, x/z averaged for axis-symmetric objects.
    ``s`` is the full size (gt_s + mean_shape)."""
    pc_obj = _to_object(R, t, pc)
    sym_aug = (aug_bb + _xz_swapped(aug_bb)) / 2.0
    ex = torch.where((sym[:, 0] == 1)[:, None], sym_aug, aug_bb)
    pc_new = _to_world(R, t, pc_obj * ex[:, None, :])
    return pc_new, s * ex, model_point * ex[:, None, :]


def defor_rt(pc, R, t, aug_rt_t, aug_rt_r):
    """Rigid perturbation."""
    pc_new = (pc + aug_rt_t[:, None, :]) @ aug_rt_r.transpose(-1, -2)
    R_new = aug_rt_r @ R
    t_new = (aug_rt_r @ (t + aug_rt_t)[..., None])[..., 0]
    return pc_new, R_new, t_new


def defor_bc(pc, R, t, s, model_point, nocs_scale, ey_up, ey_down):
    """Box-cage taper along y (bowls and mugs)."""
    pc_obj = _to_object(R, t, pc)
    s_y = s[:, 1:2]
    per_point = (pc_obj[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    pc_obj = torch.stack([pc_obj[..., 0] * per_point, pc_obj[..., 1],
                          pc_obj[..., 2] * per_point], dim=-1)
    pc_new = _to_world(R, t, pc_obj)

    mp = model_point
    mp_resize = (mp[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    mp = torch.stack([mp[..., 0] * mp_resize, mp[..., 1], mp[..., 2] * mp_resize], dim=-1)
    s_new = (mp.amax(1) - mp.amin(1)) * nocs_scale[:, None]
    return pc_new, s_new


def defor_pc(pc, gt_t, defor):
    """Per-point radial jitter: pc + defor * (pc - t)."""
    return pc + defor * (pc - gt_t[:, None, :])


@torch.no_grad()
def augment_batch(cfg: AugConfig, pc, gt_R, gt_t, gt_s, mean_shape, sym, aug_bb,
                  aug_rt_t, aug_rt_r, model_point, nocs_scale, obj_ids,
                  draws: AugmentDraws) -> AugmentedBatch:
    """The four transforms in order.  gt_s is the FS-Net size residual; the
    transforms act on the full size gt_s + mean_shape."""
    flags = draws.flags

    # 1. bounding-box rescale
    flag = flags[0] < cfg.bb_pro
    pc_new, s_new, mp_new = defor_bb(pc, model_point, gt_R, gt_t, gt_s + mean_shape,
                                     sym, aug_bb)
    pc = torch.where(flag[..., None], pc_new, pc)
    gt_s = torch.where(flag, s_new - mean_shape, gt_s)
    model_point = torch.where(flag[..., None], mp_new, model_point)

    # 2. rigid perturbation
    flag = flags[1] < cfg.rt_pro
    pc_new, R_new, t_new = defor_rt(pc, gt_R, gt_t, aug_rt_t, aug_rt_r)
    pc = torch.where(flag[..., None], pc_new, pc)
    gt_R = torch.where(flag[..., None], R_new, gt_R)
    gt_t = torch.where(flag, t_new, gt_t)

    # 3. box-cage taper: only mug (5) and bowl (1)
    is_bc_class = ((obj_ids == 5) | (obj_ids == 1))[:, None]
    flag = (flags[2] < cfg.bc_pro) & is_bc_class
    pc_new, s_new = defor_bc(pc, gt_R, gt_t, gt_s + mean_shape, model_point, nocs_scale,
                             draws.ey_up, draws.ey_down)
    pc = torch.where(flag[..., None], pc_new, pc)
    gt_s = torch.where(flag, s_new - mean_shape, gt_s)

    # 4. per-point jitter
    flag = flags[3] < cfg.pc_pro
    pc = torch.where(flag[..., None], defor_pc(pc, gt_t, draws.defor * cfg.pc_r), pc)

    return AugmentedBatch(pc, gt_R, gt_t, gt_s)
