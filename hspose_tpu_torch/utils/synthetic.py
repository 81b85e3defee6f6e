"""Deterministic synthetic train batch (copy of
``hspose_tpu/utils/synthetic.py``): the 12-key batch dict the train step
takes, as numpy arrays drawn from ``seed`` in a fixed order."""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_train_batch(bs: int, n: int, model_points: int = 1024,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bs, 3, 3))
    Q, _ = np.linalg.qr(A)
    Q *= np.sign(np.linalg.det(Q))[:, None, None]
    return {
        "pcl_in": rng.normal(scale=0.2, size=(bs, n, 3)).astype(np.float32),
        "cat_id": (np.arange(bs) % 6).astype(np.float32),
        "rotation": Q.astype(np.float32),
        "translation": rng.normal(scale=0.1, size=(bs, 3)).astype(np.float32),
        "fsnet_scale": rng.normal(scale=0.01, size=(bs, 3)).astype(np.float32),
        "mean_shape": (np.abs(rng.normal(size=(bs, 3))) * 0.1
                       + 0.1).astype(np.float32),
        "sym_info": np.tile(np.array([[0, 1, 0, 0]], np.float32), (bs, 1)),
        "aug_bb": rng.uniform(0.8, 1.2, (bs, 3)).astype(np.float32),
        "aug_rt_t": rng.normal(scale=0.01, size=(bs, 3)).astype(np.float32),
        "aug_rt_R": np.tile(np.eye(3, dtype=np.float32), (bs, 1, 1)),
        "model_point": rng.normal(
            scale=0.1, size=(bs, model_points, 3)).astype(np.float32),
        "nocs_scale": (np.abs(rng.normal(size=(bs,))) + 0.5).astype(np.float32),
    }
