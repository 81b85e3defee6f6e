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

On a (dp, mp) mesh (``parallel/mesh.py``) the step is the one-process step
on the global batch, as the JAX package's GSPMD step is: ``distribute``
lays the model out (BatchNorm over the dp group, the wide Dense layers'
output channels over the mp group), the train forward draws the global
batch's randomness and computes the global losses on every rank
(``models/hspose.py::train_forward``), and after the backward each
parameter's gradient is summed over its dp group (``parallel/dp.py::
reduce_gradients``; a sharded parameter's group holds the ranks with the
same shard).  Every rank's loss is the global one, so the NaN skip takes the
same branch on every rank, and every rank then puts its BatchNorm buffers
back.  The replicated parameters' gradients then go from the first rank of
each mp group to the others (``parallel/dp.py::broadcast_gradients``: a
backward whose scatters add in a run-dependent order would let the mp
ranks' copies drift apart).  The accumulator's running mean is over the
reduced gradients, and the optimizer clips by the global norm
(``engine/optimizer.py``).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from hspose_tpu_torch.config import HSPoseConfig
from hspose_tpu_torch.engine.optimizer import Ranger
from hspose_tpu_torch.models.hspose import TrainDraws, train_forward
from hspose_tpu_torch.models.posenet import PoseNet9D
from hspose_tpu_torch.parallel.dp import broadcast_gradients, reduce_gradients
from hspose_tpu_torch.parallel.mesh import Mesh
from hspose_tpu_torch.parallel.mp import distribute, group_of
from hspose_tpu_torch.utils.spans import span


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy batch of ``synthetic_train_batch`` as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _finite(v: torch.Tensor) -> bool:
    """Whether every entry of ``v`` is finite: a read that waits for the device."""
    with span("sync.finite"):
        return bool(torch.isfinite(v).all())


def check_finite_metrics(metrics: Dict[str, float]) -> None:
    """Raise naming the loss families whose ``finite/<family>`` flag is not
    1.0 (the step emits them with ``train.debug_nan``), so that a poisoned
    batch stops a run (hspose_tpu/engine/train_step.py:25-39)."""
    bad = [k.split("/", 1)[1] for k, v in metrics.items()
           if k.startswith("finite/") and float(v) != 1.0]
    if bad:
        raise FloatingPointError(
            f"non-finite loss detected in families: {', '.join(sorted(bad))}")


def build_train_step(cfg: HSPoseConfig, model: PoseNet9D, generator: torch.Generator,
                     mesh: Mesh | None = None) -> Callable[..., Dict[str, float]]:
    """Returns ``step(batch, draws=None) -> metrics``, with the optimizer as
    ``step.optimizer``.  ``model`` is built with ``train_heads`` and is put
    in train mode; the randomness of each step comes from ``generator``
    unless ``draws`` gives it.  Metrics: ``total_loss``, ``skipped_nan`` and
    ``<family>/<term>`` for every loss term, as floats, and with
    ``train.debug_nan`` ``finite/<family>`` (1.0 when every term of the
    family is finite, else 0.0).  With ``train.accumulate`` > 1 the
    micro-step count is ``step.mini_step`` and the running mean of the
    gradients ``step.accumulator`` (one tensor per parameter).

    ``mesh`` trains on a (dp, mp) layout (module docstring): ``model`` is
    laid out on it here, before the optimizer takes its parameters, and
    each ``batch`` is this rank's rows (``parallel/mesh.py::
    batch_sharding``) of the global batch, ``draws`` the global batch's."""
    k_steps = cfg.train.accumulate
    if k_steps < 1:
        raise ValueError(f"train.accumulate must be >= 1, got {k_steps}")
    dp_group = mp_group = None
    if mesh is not None:
        distribute(model, mesh)
        dp_group, mp_group = mesh.dp_group, mesh.mp_group
    total_iters = cfg.train.train_steps * cfg.train.total_epoch // k_steps
    optimizer = Ranger(model.parameters(), cfg.optim, total_iters)
    model.train()
    params = list(model.parameters())
    replicated = [p for p in params if group_of(p) is None]
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

    def run(batch: Dict[str, torch.Tensor], draws: TrainDraws | None) -> Dict[str, float]:
        saved = [b.clone() for b in bn_buffers]
        optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            total, loss_dicts = train_forward(cfg, model, batch, generator, draws, dp_group)
        ok = _finite(total)
        if ok:
            with span("train.backward"):
                total.backward()
            reduce_gradients(params, dp_group)
            broadcast_gradients(replicated, mp_group)
            if k_steps > 1:
                accumulate()
            else:
                optimizer.step()
        else:
            with torch.no_grad():
                for b, s in zip(bn_buffers, saved):
                    b.copy_(s)
        with span("train.metrics"):
            with span("sync.total"):
                metrics = {"total_loss": float(total.detach()), "skipped_nan": float(not ok)}
            for fam, d in loss_dicts.items():
                for k, v in d.items():
                    with span("sync.term"):
                        metrics[f"{fam}/{k}"] = float(v.detach())
            if cfg.train.debug_nan:
                for fam, d in loss_dicts.items():
                    metrics[f"finite/{fam}"] = float(all(_finite(v) for v in d.values()))
        return metrics

    def step(batch: Dict[str, torch.Tensor], draws: TrainDraws | None = None
             ) -> Dict[str, float]:
        with span("train.step"):  # the step's autograd graph is freed inside it too
            return run(batch, draws)

    step.optimizer = optimizer
    step.mini_step = 0
    step.accumulator = acc
    return step
