"""The train step (counterpart of ``hspose_tpu/engine/train_step.py``):
augmentation, the train forward, four loss families, backward, clip to 5,
Ranger with its schedule, and the NaN skip.

A non-finite total loss leaves everything as it was: the parameters, the
BatchNorm running statistics (which the forward has already moved, so they
are put back from a copy) and the optimizer state and count.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from hspose_tpu_torch.config import HSPoseConfig
from hspose_tpu_torch.engine.optimizer import Ranger
from hspose_tpu_torch.models.hspose import TrainDraws, train_forward
from hspose_tpu_torch.models.posenet import PoseNet9D


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy batch of ``synthetic_train_batch`` as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(cfg: HSPoseConfig, model: PoseNet9D, generator: torch.Generator
                     ) -> Callable[..., Dict[str, float]]:
    """Returns ``step(batch, draws=None) -> metrics``, with the optimizer as
    ``step.optimizer``.  ``model`` is built with ``train_heads`` and is put
    in train mode; the randomness of each step comes from ``generator``
    unless ``draws`` gives it.  Metrics: ``total_loss``, ``skipped_nan`` and
    ``<family>/<term>`` for every loss term, as floats."""
    if cfg.train.accumulate != 1:
        raise NotImplementedError("train.accumulate > 1 is not ported")
    total_iters = cfg.train.train_steps * cfg.train.total_epoch // cfg.train.accumulate
    optimizer = Ranger(model.parameters(), cfg.optim, total_iters)
    model.train()
    bn_buffers = [b for name, b in model.named_buffers()
                  if name.endswith(("running_mean", "running_var"))]

    def step(batch: Dict[str, torch.Tensor], draws: TrainDraws | None = None
             ) -> Dict[str, float]:
        saved = [b.clone() for b in bn_buffers]
        optimizer.zero_grad(set_to_none=True)
        total, loss_dicts = train_forward(cfg, model, batch, generator, draws)
        ok = bool(torch.isfinite(total))
        if ok:
            total.backward()
            optimizer.step()
        else:
            with torch.no_grad():
                for b, s in zip(bn_buffers, saved):
                    b.copy_(s)
        metrics = {"total_loss": float(total.detach()), "skipped_nan": float(not ok)}
        for fam, d in loss_dicts.items():
            for k, v in d.items():
                metrics[f"{fam}/{k}"] = float(v.detach())
        return metrics

    step.optimizer = optimizer
    return step
