"""The train step (counterpart of ``hspose_tpu/engine/train_step.py``):
augmentation, the train forward, four loss families, backward, clip to 5,
Ranger with its schedule, and the NaN skip.

A non-finite total loss leaves everything as it was: the parameters, the
BatchNorm running statistics (which the forward has already moved, so they
are put back from a copy), the optimizer state and count, and with
``train.accumulate`` > 1 the gradient accumulator and its micro-step count.

Every step runs its forward, losses and backward, then reads the total
loss, every term and the finiteness flags from the card in one copy
(``metric_values``; Ranger's clip decision is the step's one other read),
and only then decides: a finite step's gradients go to the optimizer or the
accumulator, a non-finite step's are never read.  Under autograd's anomaly
mode (the train CLI's ``train.debug_nan``), which raises on the NaN
gradients of a non-finite loss, the backward runs after the decision, and
only for a finite loss.  On the CUDA card a step on a batch of clouds on
one process replays that pass as one CUDA graph (``engine/graphed_step.py``);
every other step runs it op by op.

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
from hspose_tpu_torch.engine import graphed_step
from hspose_tpu_torch.engine.graphed_step import Pass
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


def metric_values(total: torch.Tensor, loss_dicts, debug_nan: bool) -> torch.Tensor:
    """The step's metrics as one float32 vector on the card, to be read in one
    go: the total loss, every term of ``loss_dicts`` in its order, whether the
    total is finite, and with ``debug_nan`` whether each family's terms are."""
    total = total.detach()
    terms = [v.detach() for d in loss_dicts.values() for v in d.values()]
    flags = [torch.isfinite(total).all()]
    if debug_nan:
        flags += [torch.stack([torch.isfinite(v.detach()).all() for v in d.values()]).all()
                  for d in loss_dicts.values()]
    return torch.stack([v.float().reshape(()) for v in [total, *terms, *flags]])


def layout_of(loss_dicts) -> tuple:
    """((family, (term, ...)), ...): the order of ``metric_values``."""
    return tuple((fam, tuple(d)) for fam, d in loss_dicts.items())


def read_metrics(values: list, terms: tuple, debug_nan: bool) -> tuple[Dict[str, float], bool]:
    """(metrics, whether the total loss is finite) from the host's copy of
    ``metric_values``."""
    it = iter(values)
    metrics = {"total_loss": next(it), "skipped_nan": 0.0}  # placed second, set below
    for fam, names in terms:
        for k in names:
            metrics[f"{fam}/{k}"] = next(it)
    ok = next(it) == 1.0
    metrics["skipped_nan"] = float(not ok)
    if debug_nan:
        for fam, _ in terms:
            metrics[f"finite/{fam}"] = next(it)
    return metrics, ok


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
    gradients ``step.accumulator`` (one tensor per parameter).  The graphs
    of the graphed route, with their counts, are ``step.graphs``.

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
    state = params + bn_buffers  # what a graph reads by address
    graphs = graphed_step.Graphs()
    debug_nan = cfg.train.debug_nan

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

    def forward_backward(batch: Dict[str, torch.Tensor], draws: TrainDraws | None,
                         backward: bool = True) -> Pass:
        """The eager pass; inside a capture, the graph's (``graphed_step.py``).
        Without ``backward`` the loss is left ``pending``."""
        saved = [b.clone() for b in bn_buffers]
        optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            total, loss_dicts = train_forward(cfg, model, batch, generator, draws, dp_group)
        if backward:
            with span("train.backward"):
                total.backward()
        return Pass(metric_values(total, loss_dicts, debug_nan), layout_of(loss_dicts), saved,
                    [p.grad for p in params], None if backward else total)

    def run(batch: Dict[str, torch.Tensor], draws: TrainDraws | None) -> Dict[str, float]:
        graphed = graphed_step.eligible(batch, mesh)
        if graphed:
            out = graphed_step.run(graphs, model, batch, draws, generator, state,
                                   forward_backward)
        else:
            # anomaly mode raises on the NaN gradients of a non-finite loss:
            # its backward waits for the decision
            out = forward_backward(batch, draws, backward=not torch.is_anomaly_enabled())
        with span("train.metrics"):
            with span("sync.metrics"):
                values = out.values.tolist()
            metrics, ok = read_metrics(values, out.terms, debug_nan)
        if ok:
            if out.pending is not None:
                with span("train.backward"):
                    out.pending.backward()
            if graphed:  # the graph writes its own gradients
                for p, g in zip(params, out.grads):
                    if p.grad is not g:
                        p.grad = g
            reduce_gradients(params, dp_group)
            broadcast_gradients(replicated, mp_group)
            if k_steps > 1:
                accumulate()
            else:
                optimizer.step()
        else:
            with torch.no_grad():
                torch._foreach_copy_(bn_buffers, list(out.saved))
        return metrics

    def step(batch: Dict[str, torch.Tensor], draws: TrainDraws | None = None
             ) -> Dict[str, float]:
        with span("train.step"):  # the step's autograd graph is freed inside it too
            return run(batch, draws)

    step.optimizer = optimizer
    step.mini_step = 0
    step.accumulator = acc
    step.graphs = graphs
    return step
