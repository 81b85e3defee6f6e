"""The readers of the program's spans (``portbench/spans.py`` and the eight
metrics that use it) on hand-built traced passes whose host ranges and
device intervals overlap by known amounts; and None from a pass without
``hspose.*`` spans, as a program from before the spans gives."""

import pytest

from portbench import spans
from portbench.readings import Readings, reader
from portbench.trace import Trace

SERVE = ("harness_host_ms.serve", "forward_host_ms.serve", "idle_in_harness.serve")
TRAIN = ("host_syncs_per_step.train", "sync_wait_ms.train", "forward_host_ms.train",
         "backward_host_ms.train", "optimizer_host_ms.train")
MAIN, OTHER = 11, 12


def serve_trace() -> Trace:
    """One request of two batches on thread MAIN, ms by ms."""
    ms = [("ProfilerStep#1", 0, 100), ("portbench.request", 0, 90),
          ("hspose.harness.ingest", 0, 4), ("hspose.harness.ingest", 4, 10),
          ("hspose.harness.to_device", 10, 16), ("hspose.sync.upload", 12, 13),
          ("hspose.sync.upload", 14, 16),
          ("hspose.harness.forward", 16, 26), ("hspose.model.eval_forward", 17, 24),
          ("hspose.model.generate_RT", 24, 25),
          ("hspose.harness.ingest", 26, 30),
          ("hspose.harness.to_device", 30, 34), ("hspose.sync.upload", 31, 33),
          ("hspose.harness.forward", 34, 40),
          ("hspose.harness.land", 40, 60), ("hspose.sync.fetch", 40, 55),
          ("hspose.sync.fetch", 55, 56),
          ("hspose.harness.ingest", 60, 61),
          ("hspose.harness.land", 61, 70), ("hspose.sync.fetch", 61, 62)]
    host = [(n, s / 1e3, e / 1e3, MAIN) for n, s, e in ms]
    # another thread's ranges count for nothing
    host += [("aten::mm", 0.0, 0.1, OTHER), ("hspose.sync.fetch", 0.0, 0.002, OTHER)]
    device = [(s / 1e3, e / 1e3) for s, e in ((13, 18), (20, 45), (56, 58), (65, 80))]
    return Trace(units=1, window_s=0.1, device=device, host=host)


def train_trace() -> Trace:
    """Two steps of 100 ms on thread MAIN, the backward's ops on OTHER."""
    host = []
    for o in (0, 100):
        ms = [("ProfilerStep#%d" % o, o, o + 100), ("portbench.step", o, o + 95),
              ("hspose.train.forward", o, o + 30), ("hspose.sync.finite", o + 30, o + 32),
              ("hspose.train.backward", o + 32, o + 60),
              ("Optimizer.step#Ranger.step", o + 60, o + 80), ("hspose.sync.clip", o + 61, o + 65),
              ("hspose.train.metrics", o + 80, o + 90), ("hspose.sync.total", o + 80, o + 84),
              ("hspose.sync.term", o + 84, o + 85), ("hspose.sync.term", o + 85, o + 86),
              ("hspose.sync.term", o + 86, o + 87)]
        host += [(n, s / 1e3, e / 1e3, MAIN) for n, s, e in ms]
        host.append(("autograd::engine::evaluate_function", (o + 33) / 1e3, (o + 59) / 1e3, OTHER))
    return Trace(units=2, window_s=0.2, device=[(0.0, 0.05), (0.1, 0.15)], host=host)


def readings(kind, trace):
    return Readings(kind, "float32", {}, {"batch": 96, "crops_per_request": 192},
                    setup_s=1.0, window={}, trace=trace, trace_host=trace)


def without_program_spans(trace: Trace) -> Trace:
    host = [h for h in trace.host if not h[0].startswith("hspose.")]
    return Trace(trace.units, trace.window_s, device=trace.device, host=host)


@pytest.mark.parametrize("name,want", [
    # ingest 4 + 6 + 4 + 1, to_device 6 - 3 and 4 - 2, land 20 - 16 and 9 - 1: 32 ms, 2 batches
    ("harness_host_ms.serve", 16.0),
    ("forward_host_ms.serve", 8.0),  # (10 + 6) / 2
    # harness outside syncs: [0, 12], [13, 14], [26, 31], [33, 34], [56, 61], [62, 70];
    # idle there: [0, 12], [58, 61], [62, 65] = 18 ms of 100
    ("idle_in_harness.serve", 18.0),
])
def test_serve_readers(name, want):
    assert reader(name)(readings("serve", serve_trace())) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,want", [
    ("host_syncs_per_step.train", 6.0),  # finite, clip, total, three terms
    ("sync_wait_ms.train", 13.0),  # 2 + 4 + 4 + 3 x 1
    ("forward_host_ms.train", 30.0),
    ("backward_host_ms.train", 28.0),
    ("optimizer_host_ms.train", 16.0),  # 20 less the clip's 4
])
def test_train_readers(name, want):
    assert reader(name)(readings("train", train_trace())) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_none_without_the_program_spans(name):
    kind = "serve" if name.endswith(".serve") else "train"
    trace = serve_trace() if kind == "serve" else train_trace()
    read = reader(name)
    assert read(readings(kind, without_program_spans(trace))) is None
    assert read(readings(kind, None)) is None
    assert read(readings("train" if kind == "serve" else "serve", trace)) is None


def test_interval_arithmetic():
    a = spans.merged([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert a == [[0, 3], [5, 9]]
    assert spans.minus(a, [[1, 2], [4, 6], [8, 10]]) == [[0, 1], [2, 3], [6, 8]]
    assert spans.length(spans.minus(a, [])) == 7
