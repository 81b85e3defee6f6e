"""Logging (``setup_logger``, a copy of ``hspose_tpu/utils/logging.py``'s; its
``MetricWriter`` comes with the training loop).

Replaces the reference's three duplicated ``setup_logger``s (tools/eval_utils.py:15,
evaluation/eval_utils.py:15, evaluation/eval_utils_v1.py:20) with one
console/file logger.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


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
