"""What a run hands to the metric readers, and how the harness finds them.

Each metric of ``BENCHMARK.json`` has a reader of its own,
``portbench/metrics/<name>.py``, with ``read(r: Readings) -> float | None``:
the number, or None where the run has nothing for it to read (the harness
then leaves the metric out of the result).  A reader reads only what is
here: the window's counts and host-clock times, the set-up time, the
traced window (``trace.py``) and the cell's shapes (``counts.py``).
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from portbench import counts
from portbench.trace import Trace

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclass
class Readings:
    kind: str  # "serve" or "train"
    dtype: str  # the configuration's compute_dtype
    model: dict  # the configuration's model keys
    traffic: dict
    setup_s: float
    window: dict  # units, elapsed_s, and per kind: crops, latencies_s / samples
    trace: Optional[Trace] = None  # the device-only pass
    trace_host: Optional[Trace] = None  # the pass with the host's ranges
    host: dict = field(default_factory=dict)  # host-clock numbers of the traced run

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def points(self) -> int:
        return self.traffic["num_points"]

    def per_unit_batches(self) -> int:
        """Batches of the model per traced unit (a request's batches, or one step)."""
        t = self.traffic
        return t["crops_per_request"] // t["batch"] if self.kind == "serve" else 1

    def model_flops_per_unit(self) -> float:
        m, n = self.model, self.points
        if self.kind == "serve":
            return self.traffic["crops_per_request"] * counts.model_flops_per_crop(
                n, m["gcn_n_num"], m["gcn_sup_num"], m["obj_c"])
        return self.batch * counts.train_flops_per_sample(
            n, m["gcn_n_num"], m["gcn_sup_num"], m["obj_c"], m["face_recon_c"])

    def kernel_least_s_per_unit(self) -> float:
        m = self.model
        return self.per_unit_batches() * counts.kernel_least_seconds(
            self.batch, self.points, m["gcn_n_num"], m["gcn_sup_num"], self.dtype,
            self.kind == "train")


def reader(name: str, directory: Path = METRICS_DIR) -> Callable[[Readings], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
