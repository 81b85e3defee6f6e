"""The program's own spans in the traced pass with the host's ranges.

``hspose_tpu_torch`` records named spans at the layer boundaries of its
serving harness and train step while a profiler runs
(``hspose_tpu_torch/utils/spans.py``): ``hspose.harness.*``,
``hspose.model.*``, ``hspose.train.*``, and ``hspose.sync.<site>`` around
every read that makes the host wait for the card; the optimizer's step is
PyTorch's own ``Optimizer.step#Ranger.step``.  ``trace.py`` keeps every
host range of that pass (``Readings.trace_host.host``), these among them,
on the clock of the device intervals.

The readers of ``metrics/`` ask this module for a span's self time (its
length less the sync spans nested in it: the host's own work, not its wait
for the card), for counts, and for the time the card sat idle while the
main thread was inside given spans.  The main thread is the one whose
``hspose.*`` spans last longest.  A program that records no ``hspose.*``
span (one from before they were added) gives ``of(...)`` None, and its
readers return None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "hspose."
SYNC = "hspose.sync."
OPTIMIZER = "Optimizer.step#Ranger.step"  # recorded by torch.optim.Optimizer
BATCH = "hspose.harness.forward"  # one a served batch
STEP = "hspose.train.forward"  # one a train step

Interval = Tuple[float, float]


def merged(intervals) -> List[List[float]]:
    """The union of ``intervals`` as disjoint sorted [start, end] pairs."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def minus(a: List[List[float]], b: List[List[float]]) -> List[List[float]]:
    """The parts of the disjoint sorted intervals ``a`` outside those of ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, at = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > at:
                out.append([at, b[k][0]])
            at = max(at, b[k][1])
            k += 1
        if at < e:
            out.append([at, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


class Spans:
    """The main thread's ranges of one traced pass, with its sync spans."""

    def __init__(self, trace, main):
        self.trace = trace
        self.ranges = [(n, s, e) for n, s, e, t in trace.host if t == main]
        self.syncs = sorted((s, e) for n, s, e in self.ranges if n.startswith(SYNC))

    def named(self, *names: str) -> List[Interval]:
        return [(s, e) for n, s, e in self.ranges if n in names]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def sync_count(self) -> int:
        return len(self.syncs)

    def sync_s(self) -> float:
        return length(self.syncs)

    def sync_within_s(self, start: float, end: float) -> float:
        return sum(e - s for s, e in self.syncs if start <= s and e <= end)

    def self_s(self, *names: str) -> float:
        """Seconds inside the spans ``names``, less their sync spans."""
        return sum(e - s - self.sync_within_s(s, e) for s, e in self.named(*names))

    def idle_inside_s(self, *names: str) -> float:
        """Seconds in which no device interval runs while the main thread is
        inside one of the spans ``names`` and outside any sync span."""
        host = minus(merged(self.named(*names)), merged(self.syncs))
        return length(minus(host, merged(self.trace.device)))


def of(r, kind: str) -> Optional[Spans]:
    """The program's spans in ``r``'s pass with host ranges, for a run of
    ``kind``; None where the run has none."""
    t = r.trace_host
    if r.kind != kind or t is None:
        return None
    spent = {}
    for n, s, e, thread in t.host:
        if n.startswith(PREFIX):
            spent[thread] = spent.get(thread, 0.0) + (e - s)
    if not spent:
        return None
    return Spans(t, max(spent, key=spent.get))


def per_unit(r, kind: str, unit: str, value) -> Optional[float]:
    """``value(spans)`` over the count of the span ``unit`` (a batch or a
    step), or None where the run has no such span."""
    sp = of(r, kind)
    if sp is None or sp.count(unit) == 0:
        return None
    return value(sp) / sp.count(unit)
