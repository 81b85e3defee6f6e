"""Model construction and the serving forward (counterpart of
``hspose_tpu/models/hspose.py::build_model`` / ``eval_forward``)."""

from __future__ import annotations

from typing import Sequence

import torch

from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.models.posenet import PoseNet9D, PoseNetOutput


def build_model(cfg: ModelConfig, device="cpu") -> PoseNet9D:
    """PoseNet9D on ``device``, in eval mode.

    The fp32 tier is the reference semantics, so this turns TF32 off for
    matrix products and cuDNN process-wide: with TF32 on, KNN order and pose
    geometry drift.  Only ``compute_dtype="float32"`` is ported."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: only 'float32' is ported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PoseNet9D(cfg, device=device).eval()


def draw_pool_samples(n: int, generator: torch.Generator | None = None,
                      device="cpu") -> list[torch.Tensor]:
    """Kept-row indices of the two 4x pools of an n-point cloud: the first
    n // 4 entries of one permutation of n, then of n // 4.  One draw serves
    the whole batch.  ``generator`` must live on ``device``."""
    samples = []
    for _ in range(2):
        perm = torch.randperm(n, generator=generator, device=device)
        n //= 4
        samples.append(perm[:n])
    return samples


@torch.no_grad()
def eval_forward(model: PoseNet9D, pc: torch.Tensor, obj_id: torch.Tensor,
                 generator: torch.Generator | None = None,
                 pool_samples: Sequence[torch.Tensor] | None = None) -> PoseNetOutput:
    """Inference forward: pc (B, N, 3) float32, obj_id (B,) 0-based.

    The pooling permutations are drawn from ``generator`` unless
    ``pool_samples`` gives the kept rows (the counterpart of the JAX
    ``pool_key``; tests pass the same samples to both packages)."""
    if pool_samples is None:
        pool_samples = draw_pool_samples(pc.shape[1], generator, pc.device)
    return model(pc, obj_id, pool_samples)
