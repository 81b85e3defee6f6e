"""The traced window: ``torch.profiler`` over a fixed number of requests or
steps, reduced to device intervals, kernel times and host ranges.

Two passes of the same number of units: one records the device alone
(busy time, kernels, launches: the profiler's cost on the host stays
small), one records the host's ranges too, for the names of the idle gaps.
The arithmetic of ``hspose_tpu_torch/tools/profile_train.py:159-185``
(device time = the CUDA events that are not user annotations; launches =
their count) is copied here and extended: the busy time is the union of
the device intervals (kernels, copies and sets), so that overlapping
streams count once, and the idle gaps between them are named by what the
host was doing in their middle.

A kernel is the port's unless its name is PyTorch's or a library's
(``LIBRARY``): the port's kernels carry the names of
``hspose_tpu_torch/csrc/*.cu`` (``knn_kernel``, ``surface_kernel``,
``hsp::gemm_kernel`` ...), the groups of ``profile_train.py:43-80``, and a
kernel renamed or added by a later change of the port counts as the
port's, not as a library's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

LIBRARY = ("at::", "at_cuda_detail", "cub::", "c10::", "cublas", "cutlass", "xmma", "cudnn",
           "nccl", "nvjet", "gemv", "gemmSN", "splitKreduce", "Memcpy", "Memset", "memcpy",
           "memset", "sm90_", "sm80_", "ampere_")
TOP = 10
NAME_CHARS = 120


def is_port_kernel(name: str) -> bool:
    return not any(p in name for p in LIBRARY)


@dataclass
class Trace:
    """One traced window: ``units`` requests or steps over ``window_s``
    seconds of host clock, ending in a synchronize."""

    units: int
    window_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end (s)
    device: List[Tuple[float, float]] = field(default_factory=list)  # every device interval
    host: List[Tuple[str, float, float, int]] = field(default_factory=list)  # name, start, end, thread

    def busy_s(self) -> float:
        total, end = 0.0, None
        for s, e in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def kernel_s(self, port_only: bool = False) -> float:
        return sum(e - s for n, s, e in self.kernels if not port_only or is_port_kernel(n))

    def top_ops(self) -> List[list]:
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:NAME_CHARS], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The longest gaps between device intervals, each named by the
        outermost and innermost host ranges of the main thread around its
        middle."""
        merged: List[List[float]] = []
        for s, e in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(merged, merged[1:])),
                      reverse=True)[:TOP]
        threads = {}
        for n, s, e, t in self.host:
            threads[t] = threads.get(t, 0.0) + (e - s)
        main = max(threads, key=threads.get) if threads else None
        out = []
        for length, mid in gaps:
            around = [(s, e, n) for n, s, e, t in self.host if t == main and s <= mid <= e]
            if around:
                outer = min(around)[2]
                inner = min(around, key=lambda r: r[1] - r[0])[2]
                label = outer if outer == inner else f"{outer} > {inner}"
            else:
                label = "no host range"
            out.append([label[:NAME_CHARS], length])
        return out


def traced(unit: Callable[[int], None], units: int, host_ranges: bool) -> Trace:
    """Profile ``units`` calls of ``unit(j)`` after one more that the
    profiler discards (its own start-up and the first launches under it).
    ``host_ranges`` records the host's ranges too, which slows the host:
    the device numbers come from a pass without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ranges else [])
    saved = []
    prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=units, repeat=1),
                   on_trace_ready=lambda p: saved.append(list(p.events())))
    window = 0.0
    with prof:
        unit(-1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for j in range(units):
            unit(j)
            if j == units - 1:
                torch.cuda.synchronize()
                window = time.perf_counter() - t0
            prof.step()
    trace = Trace(units, window)
    cuda = torch.autograd.DeviceType.CUDA
    for e in saved[0]:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda:
            if e.is_user_annotation:
                continue
            trace.device.append((s, t))
            if not any(p in e.name for p in ("Memcpy", "Memset")):
                trace.kernels.append((e.name, s, t))
        else:
            trace.host.append((e.name, s, t, e.thread))
    return trace
