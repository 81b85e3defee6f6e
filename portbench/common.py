"""What the serve and train runners share: seeds, the cell, the outcome of a
run, the port's configuration, and the comparison of numbers with limits."""

from __future__ import annotations

import dataclasses
import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from portbench.readings import Readings

# the sections of the port's HSPoseConfig that a configuration file may set
PORT_SECTIONS = ("data", "model", "aug", "loss", "optim", "train", "eval", "parallel")


def sub_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed (any
    whole number) and the purpose's numbers."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *purpose])
    lo, hi = ss.generate_state(2, dtype=np.uint32)
    return int(hi & 0x7FFFFFFF) << 32 | int(lo)


def rng(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *purpose))


@dataclass
class Cell:
    name: str
    config: dict  # the configuration file: its HSPoseConfig sections ("model", "data", ...)
    traffic: dict  # the traffic file, with the configuration's num_points
    limits: Dict[str, float]  # the numbers compared and their limits

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def dtype(self) -> str:
        return self.model["compute_dtype"]

    @property
    def points(self) -> int:
        return self.config["data"]["num_points"]


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    readings: Readings
    attempted: int
    failed: int
    checks: List[Check] = field(default_factory=list)
    memory_peak_bytes: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        """Every number within its limit, and no request or step of the
        window failed (a non-finite pose, a step skipped for a NaN loss)."""
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def port_config(cell: Cell, **traffic_sections: dict):
    """The port's HSPoseConfig of a cell: its defaults, with each section
    that the configuration file sets, then what the traffic kind sets
    (``eval={"eval_batch": 96}``)."""
    from hspose_tpu_torch.config import HSPoseConfig

    cfg = HSPoseConfig()
    parts = {}
    for name in PORT_SECTIONS:
        keys = {**cell.config.get(name, {}), **traffic_sections.get(name, {})}
        if keys:
            keys = {k: tuple(v) if isinstance(v, list) else v for k, v in keys.items()}
            parts[name] = dataclasses.replace(getattr(cfg, name), **keys)
    return cfg.replace(**parts)


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Every number that has a limit, in the limits' order."""
    return [Check(k, float(numbers[k]), float(v)) for k, v in limits.items()]


def median(xs) -> float:
    return float(statistics.median(xs))


def device_of(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def free_device_memory(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
