"""The reader of ``graph_replays_per_step.train`` on hand-built traced passes:
1.0 where every step replays the train step's graph, 0.0 on the eager
route, a share where some steps replay, and None from a pass without
``hspose.*`` spans (a program from before the spans) or of another kind."""

import pytest

from portbench.readings import Readings, reader
from portbench.trace import Trace

NAME = "graph_replays_per_step.train"
MAIN, OTHER = 11, 12


def train_trace(replayed) -> Trace:
    """One step of 100 ms a flag in ``replayed`` on thread MAIN: a graph
    replay inside the step's forward span where the flag is set, the eager
    forward and backward where not."""
    host = []
    for i, graphed in enumerate(replayed):
        o = 100 * i
        ms = [("portbench.step", o, o + 95), ("hspose.train.step", o, o + 95),
              ("hspose.train.forward", o, o + 30)]
        if graphed:
            ms.append(("hspose.train.graph_replay", o + 2, o + 29))
        else:
            ms.append(("hspose.train.backward", o + 30, o + 60))
        ms += [("hspose.train.metrics", o + 60, o + 70), ("hspose.sync.metrics", o + 60, o + 69),
               ("Optimizer.step#Ranger.step", o + 70, o + 90),
               ("hspose.sync.clip", o + 71, o + 75)]
        host += [(n, s / 1e3, e / 1e3, MAIN) for n, s, e in ms]
    # another thread's replay spans count for nothing
    host.append(("hspose.train.graph_replay", 0.0, 0.001, OTHER))
    return Trace(units=len(replayed), window_s=0.1 * len(replayed),
                 device=[(0.0, 0.05)], host=host)


def readings(kind, trace):
    return Readings(kind, "float32", {}, {"batch": 24}, setup_s=1.0, window={}, trace=trace,
                    trace_host=trace)


@pytest.mark.parametrize("replayed,want", [
    ([True] * 5, 1.0), ([False] * 5, 0.0), ([False, True, True, True], 0.75)])
def test_replays_per_step(replayed, want):
    assert reader(NAME)(readings("train", train_trace(replayed))) == pytest.approx(want)


def test_none_without_the_program_spans():
    trace = train_trace([True] * 3)
    bare = Trace(trace.units, trace.window_s, device=trace.device,
                 host=[h for h in trace.host if not h[0].startswith("hspose.")])
    read = reader(NAME)
    assert read(readings("train", bare)) is None
    assert read(readings("train", None)) is None
    assert read(readings("serve", trace)) is None
