"""The train step's forward, losses and backward as one CUDA graph replay.

``engine/train_step.py`` runs every step that ``eligible`` admits through
``run``: instead of enqueueing the train forward, its losses and
autograd's backward (about 4.4k kernels at B = 24) one Python call at a
time, the host draws the step's randomness, copies it and the batch into
static buffers and replays one ``torch.cuda.CUDAGraph``.  Every other step
takes the eager route unchanged: CPU tensors, a (dp, mp) mesh (BatchNorm
and the loss inputs go through collectives), a batch of crops (device
sampling samples the clouds on the card, ``roi_to_pointcloud``) and
autograd's anomaly mode (its checks read the card).

The randomness is drawn eagerly, outside the graph, from the step's
generator with ``draw_train``, in the order the eager route draws it, or
taken from the caller's ``draws``; so the generator advances as it does
on the eager route.  Kernels, loss arithmetic and the optimizer are those
of the eager route; the optimizer, the NaN guard's decision and gradient
accumulation stay outside the graph, in ``train_step.py``.

Per batch layout (``key``: the batch's shapes, strides, types and device,
train mode, whether cuBLAS may use TF32, and the addresses of the
parameters and BatchNorm statistics): the first eligible step runs eagerly,
on the graphs' own stream, as the warm-up (it builds the kernels' library,
the index constants of ``utils/consts.py`` and cuBLAS's workspace for that
stream); the second captures the pass, ``body(static batch, static
draws)``, into a memory pool of its own, the gradients set to None so that
the backward writes ``.grad`` tensors of the pool, which every replay then
writes again; that step and every later one copies its batch and draws
into the static ones and replays.  The pass's outputs are static tensors:
the metric values, the BatchNorm statistics as they were before the
replay, and the gradients, which ``train_step.py`` puts back as the
parameters' ``.grad`` where something replaced them.  Capture raises on
whatever it cannot hold, a read of the card or a pageable copy; it never
falls back to the eager route.  Moving the model (new addresses) drops the
layout's graph and warms up again.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from hspose_tpu_torch.data.augment import AugmentDraws
from hspose_tpu_torch.models.hspose import TrainDraws, draw_train
from hspose_tpu_torch.utils.spans import span


class Pass(NamedTuple):
    """One forward, losses and backward, as the step reads it."""

    values: torch.Tensor  # total loss, every term, the finiteness flags (train_step.py)
    terms: tuple  # ((family, (term, ...)), ...): the values' layout
    saved: Sequence[torch.Tensor]  # the BatchNorm statistics before the pass
    grads: Sequence[Optional[torch.Tensor]]  # each parameter's ``.grad`` after the pass
    pending: Optional[torch.Tensor] = None  # a loss whose backward waits for the decision


Body = Callable[[dict, Optional[TrainDraws]], Pass]


def eligible(batch: dict, mesh) -> bool:
    """Whether the step runs as a graph replay: a batch of clouds on the card,
    one process (no mesh), autograd's anomaly mode off."""
    return (mesh is None and "pcl_in" in batch and all(t.is_cuda for t in batch.values())
            and not torch.is_anomaly_enabled())


def key(model, batch: dict, tensors: Sequence[torch.Tensor]) -> tuple:
    """(layout, state): the graph that runs this batch, and the addresses of
    ``tensors`` (the parameters and BatchNorm statistics) it reads."""
    layout = (model.training, torch.backends.cuda.matmul.allow_tf32,
              tuple((k, v.shape, v.stride(), v.dtype, v.device) for k, v in batch.items()))
    return layout, tuple(t.data_ptr() for t in tensors)


def flat(draws: TrainDraws) -> list:
    """The draws of a batch of clouds, as one list."""
    return [*draws.aug, *draws.pool_samples, *draws.dropout_keep]


def unflat(ts: Sequence[torch.Tensor], like: TrainDraws) -> TrainDraws:
    n = len(like.pool_samples)
    return TrainDraws(AugmentDraws(*ts[:4]), list(ts[4:4 + n]), list(ts[4 + n:]))


class StepGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    names: tuple  # the batch's keys, in the order of ``inputs``
    inputs: tuple  # the static batch, then the static draws (``flat``)
    out: Pass  # the static outputs


class Graphs:
    """A step's graphs, one a batch layout, with the states they were warmed
    up or captured on, their stream and their counts."""

    def __init__(self):
        self.warmed: dict = {}  # layout -> state of its warm-up
        self.graphs: dict = {}  # layout -> StepGraph
        self.streams: dict = {}  # device -> the stream of warm-ups and captures
        self.captures = self.replays = 0

    def stream(self, device):
        if device not in self.streams:
            self.streams[device] = new_stream(device)
        return self.streams[device]


def new_stream(device):
    return torch.cuda.Stream(device=device)


@contextlib.contextmanager
def side_stream(stream):
    """Run the block on ``stream``, after the current stream's work so far
    and before the current stream's next work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def capture(body: Callable[[], Pass], stream):
    """(graph, outputs) of ``body()`` captured on ``stream``."""
    graph = torch.cuda.CUDAGraph()
    with side_stream(stream):
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = body()
    return graph, out


def capture_step(body: Body, batch: dict, draws: TrainDraws, stream) -> StepGraph:
    """A graph of ``body`` on static copies of ``batch`` and ``draws``."""
    device = batch["pcl_in"].device
    static_batch = {k: v.clone() for k, v in batch.items()}
    static_draws = unflat([x.to(device, copy=True) for x in flat(draws)], draws)
    graph, out = capture(lambda: body(static_batch, static_draws), stream)
    return StepGraph(graph, tuple(static_batch), (*static_batch.values(), *flat(static_draws)),
                     out)


def run(graphs: Graphs, model, batch: dict, draws: Optional[TrainDraws],
        generator: torch.Generator, tensors: Sequence[torch.Tensor], body: Body) -> Pass:
    """The pass of one eligible step: eager the first time a layout is seen
    on this state (the warm-up), else one replay of its graph, captured
    first where there is none.  ``body(batch, draws)`` is the eager pass;
    inside a capture it returns the graph's outputs."""
    layout, state = key(model, batch, tensors)
    device = batch["pcl_in"].device
    if graphs.warmed.get(layout) != state:
        graphs.graphs.pop(layout, None)  # it reads the old state's memory
        graphs.warmed[layout] = state
        with side_stream(graphs.stream(device)):
            return body(batch, draws)
    with span("train.forward"):
        if draws is None:
            draws = draw_train(generator, batch["cat_id"].shape[0], batch["pcl_in"].shape[1])
        g = graphs.graphs.get(layout)
        if g is None:
            with span("train.graph_capture", graphs.captures):
                g = graphs.graphs[layout] = capture_step(body, batch, draws,
                                                         graphs.stream(device))
            graphs.captures += 1
        with span("train.graph_replay"):
            torch._foreach_copy_(list(g.inputs), [batch[k] for k in g.names] + flat(draws))
            g.graph.replay()
        graphs.replays += 1
    return g.out
