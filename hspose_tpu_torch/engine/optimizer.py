"""Ranger: clip, gradient centralization, rectified RAdam, schedule and
lookahead, in the JAX package's chain order (counterpart of
``hspose_tpu/engine/optimizer.py::build_optimizer``, clip(5) -> GC ->
RAdam -> -lr(t) -> lookahead).

* Clip by global norm as optax does: g * max_norm / |g| when |g| >= max_norm,
  with no +1e-6.  The gradients are the global batch's (reduced over dp by
  the train step); a parameter sharded over an mp group
  (``parallel/mp.py``) adds its shard's square to the sum over the group,
  so each shard counts once and every rank takes the same decision.
* GC subtracts each gradient's mean over every dim but 0, for ndim >= 2.
  The port keeps torch layouts (Linear weights (out, in), the HS layers'
  ``weights`` / ``directions`` as in the flax tree), which is the axis choice
  of the JAX package's ``_gc_axes`` for both kinds.
* RAdam with the rectification term and the bias terms 1 - beta^t taken as
  -expm1(t log beta) in float32 (the naive form flips the branch at t=5).
* The learning rate is the schedule at the optimizer's own count, from 0.
* Lookahead: every k steps the slow weights move alpha of the way to the
  fast ones and the fast weights are set to them, as p + (slow' - p).
"""

from __future__ import annotations

import math

import torch

from hspose_tpu_torch.config import OptimConfig
from hspose_tpu_torch.engine.schedule import learning_rate
from hspose_tpu_torch.parallel.dp import all_reduce_sum
from hspose_tpu_torch.parallel.mp import group_of
from hspose_tpu_torch.utils.spans import span


class Ranger(torch.optim.Optimizer):
    """One parameter group; ``step()`` reads each parameter's ``.grad``.
    A parameter without a gradient counts as a zero gradient, as in the
    JAX package where every leaf gets one."""

    def __init__(self, params, cfg: OptimConfig, total_iters: int):
        super().__init__(params, {})
        self.cfg = cfg
        self.total_iters = total_iters
        self.count = 0  # optimizer steps taken
        for p in self._params():
            st = self.state[p]
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
            st["slow"] = p.detach().clone()

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def lr(self) -> float:
        """The learning rate of the next step."""
        return learning_rate(self.cfg, self.total_iters, self.count)

    def _scalars(self, t: int):
        """step size and whether the adaptive branch is taken, in float32."""
        b1, b2 = self.cfg.betas
        tt = torch.tensor(float(t), dtype=torch.float32)
        one_minus_b2t = -torch.expm1(tt * math.log(b2))
        beta2_t = 1.0 - one_minus_b2t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * tt * beta2_t / one_minus_b2t
        rect = torch.sqrt(one_minus_b2t * (n_sma - 4.0) / (n_sma_max - 4.0)
                          * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0))
        bias1 = -torch.expm1(tt * math.log(b1))
        adaptive = bool(n_sma > self.cfg.n_sma_threshold)
        step_size = rect / bias1 if adaptive else 1.0 / bias1
        return float(step_size), adaptive

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter, as multi-tensor (``_foreach``) ops:
        the same elementwise arithmetic in the same order, in a few launches
        instead of a few per parameter."""
        if closure is not None:
            raise ValueError("Ranger.step takes no closure")
        cfg = self.cfg
        b1, b2 = cfg.betas
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        states = [self.state[p] for p in params]

        # clip by global norm (optax.clip_by_global_norm)
        norms = torch.stack(torch._foreach_norm(grads))
        groups = [group_of(p) for p in params]
        mp_group = next((g for g in groups if g is not None), None)
        if mp_group is None:
            norm = torch.linalg.vector_norm(norms)
        else:
            # each mp shard counted once: the shards' squares summed over the group
            sq = norms.square()
            sharded = torch.tensor([g is not None for g in groups], device=sq.device)
            norm = torch.sqrt(all_reduce_sum(sq[sharded].sum(), mp_group) + sq[~sharded].sum())
        with span("sync.clip"):
            clip = bool(norm >= cfg.clip_grad_norm)
        if clip:
            grads = torch._foreach_mul(torch._foreach_div(grads, norm), cfg.clip_grad_norm)
        if cfg.use_gc:
            grads = [g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True) if g.dim() >= 2
                     else g for g in grads]

        lr = self.lr()
        self.count += 1
        step_size, adaptive = self._scalars(self.count)
        ms = [st["exp_avg"] for st in states]
        vs = [st["exp_avg_sq"] for st in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))
        d = (torch._foreach_div(ms, torch._foreach_add(torch._foreach_sqrt(vs), cfg.eps))
             if adaptive else ms)
        if cfg.weight_decay != 0.0:
            d = torch._foreach_add(d, torch._foreach_mul(params, cfg.weight_decay))
        u = torch._foreach_mul(torch._foreach_mul(d, step_size), -lr)
        if self.count % cfg.lookahead_k == 0:
            slows = [st["slow"] for st in states]
            fast = torch._foreach_add(params, u)
            new_slow = torch._foreach_add(
                slows, torch._foreach_mul(torch._foreach_sub(fast, slows), cfg.lookahead_alpha))
            u = torch._foreach_sub(new_slow, params)
            torch._foreach_copy_(slows, new_slow)
        torch._foreach_add_(params, u)
        return None
