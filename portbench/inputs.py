"""The benchmark's inputs, made from the seed: train batches, the train
step's random draws, and the serving harness's detection crops.

* ``train_batches``: the arithmetic of ``hspose_tpu_torch/utils/synthetic.py::
  synthetic_train_batch`` (itself a copy of ``hspose_tpu/utils/synthetic.py``)
  for ``count`` batches at once: the same 12 keys, distributions and
  shapes, drawn with one ``torch.Generator`` on the device (a batch's
  draws in the copied order) instead of numpy on the host.
* ``train_draws``: one step's randomness as ``models/hspose.py::draw_train``
  and ``data/augment.py::draw_augment`` lay it out (hspose_tpu_torch/models/
  hspose.py:103-117 and :56-62 of augment.py): the four gates (4, B, 1), the
  box-cage scales, the per-point jitter, the two pools' kept rows, the three
  dropout keep-masks.
* ``serve_crops``: a pool of host-sampled clouds (``pcl_in``, N points,
  N(0, 0.2) as the synthetic batch's, shifted by a translation of scale
  0.1), their categories, symmetry flags and mean shapes, made on the device
  and copied to the host once, as the harness's records carry numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

KEEP_PROB = 0.8
N_CATEGORIES = 6


class Draws(NamedTuple):
    """One train step's randomness: aug = (flags, ey_up, ey_down, defor)."""

    aug: tuple
    pools: List[torch.Tensor]
    keep: tuple


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def train_batches(bs: int, n: int, count: int, seed: int, device,
                  model_points: int = 1024) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches of ``synthetic_train_batch(bs, n)``'s layout."""
    g = _gen(seed, device)
    out = []
    for _ in range(count):
        def normal(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device=device) * scale

        # 3x3 QR on the host: the card's solver library takes seconds to load
        Q, _ = torch.linalg.qr(normal(bs, 3, 3).cpu())
        Q = (Q * torch.sign(torch.linalg.det(Q))[:, None, None]).to(device)
        out.append({
            "pcl_in": normal(bs, n, 3, scale=0.2),
            "cat_id": (torch.arange(bs, device=device) % N_CATEGORIES).float(),
            "rotation": Q,
            "translation": normal(bs, 3, scale=0.1),
            "fsnet_scale": normal(bs, 3, scale=0.01),
            "mean_shape": normal(bs, 3).abs() * 0.1 + 0.1,
            "sym_info": torch.tensor([[0.0, 1.0, 0.0, 0.0]], device=device).repeat(bs, 1),
            "aug_bb": 0.8 + 0.4 * torch.rand((bs, 3), generator=g, device=device),
            "aug_rt_t": normal(bs, 3, scale=0.01),
            "aug_rt_R": torch.eye(3, device=device).repeat(bs, 1, 1),
            "model_point": normal(bs, model_points, 3, scale=0.1),
            "nocs_scale": normal(bs).abs() + 0.5,
        })
    return out


def pool_samples(n: int, g: torch.Generator) -> List[torch.Tensor]:
    """The kept rows of the two 4x pools: the first n // 4 of a permutation
    of n, then of n // 4 (models/hspose.py:65-79)."""
    samples = []
    for _ in range(2):
        perm = torch.randperm(n, generator=g, device=g.device)
        n //= 4
        samples.append(perm[:n])
    return samples


def train_draws(bs: int, n: int, g: torch.Generator) -> Draws:
    dev = g.device

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev)

    aug = (u(4, bs, 1), 0.8 + 0.4 * u(bs, 1), 0.8 + 0.4 * u(bs, 1), u(bs, n, 3))
    pools = pool_samples(n, g)
    keep = tuple(u(bs, 256) < KEEP_PROB for _ in range(3))
    return Draws(aug, pools, keep)


# the NOCS categories' symmetry flags and mean shapes, metres (bottle, bowl,
# camera, can, laptop, mug with its handle seen): hspose_tpu_torch/geometry/
# symmetry.py:29-74
SYM = [[1, 1, 0, 1], [1, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 0, 0], [0, 1, 0, 0]]
MEAN_SHAPE_MM = [[87, 220, 89], [165, 80, 165], [88, 128, 156], [68, 146, 72],
                 [346, 200, 335], [146, 83, 114]]


def serve_crops(count: int, n: int, seed: int, device) -> dict:
    """``count`` crops as numpy arrays: pcl_in (count, n, 3) float32,
    cat_id_0base (count,) int, sym_info (count, 4), mean_shape (count, 3)."""
    g = _gen(seed, device)
    pc = torch.randn((count, n, 3), generator=g, device=device) * 0.2
    pc += torch.randn((count, 1, 3), generator=g, device=device) * 0.1
    cat = torch.randint(0, N_CATEGORIES, (count,), generator=g, device=device)
    sym = torch.tensor(SYM, dtype=torch.float32, device=device)[cat]
    mean = torch.tensor(MEAN_SHAPE_MM, dtype=torch.float32, device=device)[cat] / 1000.0
    return {"pcl_in": pc.cpu().numpy(), "cat_id_0base": cat.cpu().numpy(),
            "sym_info": sym.cpu().numpy(), "mean_shape": mean.cpu().numpy()}
