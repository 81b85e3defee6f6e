"""Learning-rate schedules as pure functions of the step (counterpart of
``hspose_tpu/engine/schedule.py``), computed in float32 as the JAX package
does on the device."""

from __future__ import annotations

import math

import numpy as np

from hspose_tpu_torch.config import OptimConfig

f32 = np.float32


def flat_and_anneal(step: int, total_iters: int, warmup_iters: int = 1000,
                    warmup_factor: float = 1e-3, anneal_point: float = 0.72,
                    anneal_method: str = "cosine", target_lr_factor: float = 0.0,
                    poly_power: float = 1.0) -> float:
    """Linear warmup from ``warmup_factor`` over ``warmup_iters``, flat at 1
    until ``anneal_point * total_iters``, then an anneal to
    ``target_lr_factor``."""
    step = f32(step)
    anneal_start = anneal_point * total_iters
    if step < warmup_iters:
        alpha = step / f32(max(warmup_iters, 1))
        return float(f32(warmup_factor) * (f32(1) - alpha) + alpha)
    if step < anneal_start:
        return 1.0
    frac = (step - f32(anneal_start)) / f32(max(total_iters - anneal_start, 1e-8))
    t = f32(target_lr_factor)
    if anneal_method == "cosine":
        ann = t + f32(0.5) * (f32(1) - t) * (f32(1) + np.cos(f32(math.pi) * frac))
    elif anneal_method == "linear":
        ann = t + (f32(1) - t) * (f32(1) - frac)
    elif anneal_method == "poly":
        ann = t + (f32(1) - t) * (f32(1) - frac) ** f32(poly_power)
    elif anneal_method == "exp":
        ann = f32(max(target_lr_factor, 5e-3)) ** frac
    elif anneal_method == "none":
        ann = f32(1)
    else:
        raise ValueError(f"unsupported anneal_method {anneal_method}")
    return float(ann)


def _warmup(step, warmup_iters: int, warmup_factor: float, warmup_method: str):
    if step >= warmup_iters:
        return f32(1)
    if warmup_method == "constant":
        return f32(warmup_factor)
    if warmup_method == "linear":
        alpha = step / f32(max(warmup_iters, 1))
        return f32(warmup_factor) * (f32(1) - alpha) + alpha
    raise ValueError(f"unsupported warmup_method {warmup_method}")


def warmupmultisteplr(step: int, total_iters: int, rel_steps, gamma: float = 0.1,
                      warmup_iters: int = 1000, warmup_factor: float = 1e-3,
                      warmup_method: str = "linear") -> float:
    """Step decay by ``gamma`` at each milestone ``rel * total_iters``."""
    step = f32(step)
    passed = sum(f32(step >= rel * total_iters) for rel in rel_steps)
    return float(_warmup(step, warmup_iters, warmup_factor, warmup_method)
                 * f32(gamma) ** f32(passed))


def warmupcosinelr(step: int, total_iters: int, warmup_iters: int = 1000,
                   warmup_factor: float = 1e-3, warmup_method: str = "linear") -> float:
    """Half-cosine from the base rate to 0 over the whole run."""
    step = f32(step)
    warm = _warmup(step, warmup_iters, warmup_factor, warmup_method)
    return float(warm * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * step / f32(total_iters))))


def learning_rate(cfg: OptimConfig, total_iters: int, step: int) -> float:
    """lr * lr_pose * the schedule named by ``cfg.lr_scheduler_name`` at ``step``."""
    name = cfg.lr_scheduler_name.lower()
    if name == "warmupmultisteplr":
        f = warmupmultisteplr(step, total_iters, cfg.rel_steps, cfg.gamma,
                              cfg.warmup_iters, cfg.warmup_factor, cfg.warmup_method)
    elif name == "warmupcosinelr":
        f = warmupcosinelr(step, total_iters, cfg.warmup_iters, cfg.warmup_factor,
                           cfg.warmup_method)
    elif name == "flat_and_anneal":
        f = flat_and_anneal(step, total_iters, cfg.warmup_iters, cfg.warmup_factor,
                            cfg.anneal_point, cfg.anneal_method, 0.0, cfg.poly_power)
    else:
        raise ValueError(f"Unknown LR scheduler: {cfg.lr_scheduler_name}")
    return float(f32(cfg.lr * cfg.lr_pose) * f32(f))
