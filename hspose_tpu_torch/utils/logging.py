"""Logging + metric writers (a copy of ``hspose_tpu/utils/logging.py``).

Replaces the reference's three duplicated ``setup_logger``s (tools/eval_utils.py:15,
evaluation/eval_utils.py:15, evaluation/eval_utils_v1.py:20) and its TF1
``summary.FileWriter`` scalars (engine/train.py:37-38,132-150) with one console/file
logger and a JSONL scalar writer.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


def setup_logger(name: str, log_file: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Scalar writer: one JSON record per ``write`` in ``metrics.jsonl``.
    The JAX package also writes TensorBoard events where it can; the port
    does not, since torch's ``SummaryWriter`` imports TensorFlow where that
    is installed, and with it Keras and cv2."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, scalars: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
