"""The train step (counterpart of ``hspose_tpu/engine/train_step.py``):
augmentation, the train forward, four loss families, backward, clip to 5,
Ranger with its schedule, and the NaN skip.

A non-finite total loss leaves everything as it was: the parameters, the
BatchNorm running statistics (which the forward has already moved, so they
are put back from a copy), the optimizer state and count, and with
``train.accumulate`` > 1 the gradient accumulator and its micro-step count.

``train.accumulate`` = k > 1 is ``optax.MultiSteps(tx, every_k_schedule=k)``
around the optimizer, as the JAX package builds it: each finite micro-batch
moves the running mean of the gradients, acc + (g - acc) / (m + 1) at
micro-step m, and the BatchNorm statistics; every k-th one hands that mean
to the optimizer (clip, GC, RAdam, lookahead) and resets it, and only then
do the parameters move.  The schedule counts optimizer steps.
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


def check_finite_metrics(metrics: Dict[str, float]) -> None:
    """Raise naming the loss families whose ``finite/<family>`` flag is not
    1.0 (the step emits them with ``train.debug_nan``), so that a poisoned
    batch stops a run (hspose_tpu/engine/train_step.py:25-39)."""
    bad = [k.split("/", 1)[1] for k, v in metrics.items()
           if k.startswith("finite/") and float(v) != 1.0]
    if bad:
        raise FloatingPointError(
            f"non-finite loss detected in families: {', '.join(sorted(bad))}")


def build_train_step(cfg: HSPoseConfig, model: PoseNet9D, generator: torch.Generator
                     ) -> Callable[..., Dict[str, float]]:
    """Returns ``step(batch, draws=None) -> metrics``, with the optimizer as
    ``step.optimizer``.  ``model`` is built with ``train_heads`` and is put
    in train mode; the randomness of each step comes from ``generator``
    unless ``draws`` gives it.  Metrics: ``total_loss``, ``skipped_nan`` and
    ``<family>/<term>`` for every loss term, as floats, and with
    ``train.debug_nan`` ``finite/<family>`` (1.0 when every term of the
    family is finite, else 0.0).  With ``train.accumulate`` > 1 the
    micro-step count is ``step.mini_step`` and the running mean of the
    gradients ``step.accumulator`` (one tensor per parameter)."""
    k_steps = cfg.train.accumulate
    if k_steps < 1:
        raise ValueError(f"train.accumulate must be >= 1, got {k_steps}")
    total_iters = cfg.train.train_steps * cfg.train.total_epoch // k_steps
    optimizer = Ranger(model.parameters(), cfg.optim, total_iters)
    model.train()
    params = list(model.parameters())
    bn_buffers = [b for name, b in model.named_buffers()
                  if name.endswith(("running_mean", "running_var"))]
    acc = [torch.zeros_like(p) for p in params] if k_steps > 1 else []

    def accumulate() -> None:
        """MultiSteps' update: fold this micro-batch's gradients into the
        running mean; every k-th micro-batch, step the optimizer on it."""
        with torch.no_grad():
            for a, p in zip(acc, params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.add_((g - a) / (step.mini_step + 1))
        if step.mini_step == k_steps - 1:
            for a, p in zip(acc, params):
                p.grad = a.clone()
            optimizer.step()
            for a in acc:
                a.zero_()
        step.mini_step = (step.mini_step + 1) % k_steps

    def step(batch: Dict[str, torch.Tensor], draws: TrainDraws | None = None
             ) -> Dict[str, float]:
        saved = [b.clone() for b in bn_buffers]
        optimizer.zero_grad(set_to_none=True)
        total, loss_dicts = train_forward(cfg, model, batch, generator, draws)
        ok = bool(torch.isfinite(total))
        if ok:
            total.backward()
            if k_steps > 1:
                accumulate()
            else:
                optimizer.step()
        else:
            with torch.no_grad():
                for b, s in zip(bn_buffers, saved):
                    b.copy_(s)
        metrics = {"total_loss": float(total.detach()), "skipped_nan": float(not ok)}
        for fam, d in loss_dicts.items():
            for k, v in d.items():
                metrics[f"{fam}/{k}"] = float(v.detach())
        if cfg.train.debug_nan:
            for fam, d in loss_dicts.items():
                metrics[f"finite/{fam}"] = float(all(bool(torch.isfinite(v).all())
                                                     for v in d.values()))
        return metrics

    step.optimizer = optimizer
    step.mini_step = 0
    step.accumulator = acc
    return step
