"""The served forward as one CUDA graph replay.

``models/hspose.py::eval_forward`` serves a forward that ``eligible``
admits by replaying a ``torch.cuda.CUDAGraph`` of ``model(pc, obj_id,
pool_samples)``, instead of enqueueing its few hundred kernels one Python
call at a time: the host's cost of a batch falls to four input copies, one
``replay()`` and six output clones, so that a batch whose kernels take less
time on the card than their launches take on the host keeps the card busy.
Every other forward takes the eager route unchanged: CPU tensors, train
mode, an sp group, ``with_heads`` (the recon harness) and a model whose
heads multiply the concatenated feature (``PoseNet9D.factored``: a head
layer sharded over mp).

A graph is captured, as ``torch.cuda.graphs`` recommends, after
``WARMUP`` eager forwards on a side stream (they build the kernels'
library, ``FirstLayers``' stacked weights and cuBLAS's workspace for that
stream), from static input buffers, into a memory pool of its own.  A call
copies its inputs into them, replays, and returns clones of the outputs,
so that no caller sees the next replay overwrite them (the harness keeps a
batch's outputs in flight while it submits the next).  Capture raises on
whatever it cannot hold, a host synchronisation or a pageable copy; it
never falls back to the eager route.

The model keeps one graph (``PoseNet9D.graphs``), the last captured,
under ``key``: the device, B, N, the input types, the tier, the pool
samples' lengths and whether cuBLAS may use TF32 (the fp32 tier turns it
off), and ``(data_ptr, _version)`` of every parameter and buffer, as
``heads.py::FirstLayers`` keys its stacked weights.  A served model sees
one key (the harness pads every batch to ``eval.eval_batch``): a new batch
size, ``load_state_dict``, an in-place write or ``.to()`` changes it, and
the next call drops the graph and captures anew.  A write through
``.data`` bumps no version: a replay reads its values in the tensor
itself, but not in the stacked weights, which the eager route does not
rebuild either.  A graph keeps the tensors it reads alive (the
parameters' storages and the stacked weights of its capture), so that no
later tensor takes their addresses while it is kept.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from hspose_tpu_torch.utils.spans import span

WARMUP = 2  # eager forwards on the capture stream before the capture


def eligible(model, pc: torch.Tensor, with_heads: bool, sp_group) -> bool:
    """Whether ``eval_forward`` serves this forward as a graph replay: CUDA
    inputs, eval mode, one process per forward (no sp group), the pose
    outputs alone and the factored heads."""
    return (pc.is_cuda and not model.training and sp_group is None and not with_heads
            and model.factored())


def state_tensors(model) -> list[torch.Tensor]:
    """Every parameter and buffer of ``model``."""
    return [t for m in model.modules() for d in (m._parameters, m._buffers)
            for t in d.values() if t is not None]


def key(model, pc: torch.Tensor, obj_id: torch.Tensor,
        pool_samples: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> tuple:
    """The graph that serves these inputs on this state of ``model``:
    ``tensors`` are its ``state_tensors``."""
    shapes = (pc.device, *pc.shape[:2], pc.dtype, obj_id.dtype, model.face_recon.dtype,
              tuple((len(s), s.dtype) for s in pool_samples),
              torch.backends.cuda.matmul.allow_tf32)
    return shapes, tuple((t.data_ptr(), t._version) for t in tensors)


class Graph(NamedTuple):
    """One captured forward: its graph, static inputs and outputs, and the
    tensors whose memory it reads."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]  # pc, obj_id, the pool samples
    outputs: tuple[torch.Tensor, ...]  # the PoseNetOutput fields
    kept: tuple


class Graphs:
    """A model's graph, the last captured, under its key, and its count of
    captures.  A copy or a pickle of the model gets none: a graph reads the
    memory of the tensors it was captured on."""

    def __init__(self):
        self.key, self.graph = None, None
        self.captures = 0

    def __reduce__(self):
        return Graphs, ()

    def get(self, k: tuple, build: Callable[[], object]):
        """The graph under ``k`` = (inputs, state); under another key the
        graph is dropped, with its memory pool, and ``build()`` captures
        anew."""
        if k != self.key:
            self.key, self.graph = None, None
            self.graph = build()
            self.key = k
            self.captures += 1
        return self.graph


def capture(model, pc: torch.Tensor, obj_id: torch.Tensor,
            pool_samples: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> Graph:
    """A graph of ``model(pc, obj_id, pool_samples)`` on static copies of
    the inputs, after ``WARMUP`` eager forwards on its capture stream."""
    with torch.cuda.device(pc.device):
        inputs = tuple(x.clone() for x in (pc, obj_id, *pool_samples))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(WARMUP):
                model(inputs[0], inputs[1], inputs[2:])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outputs = tuple(model(inputs[0], inputs[1], inputs[2:]))
        torch.cuda.current_stream().wait_stream(stream)
    kept = (tuple(t.detach() for t in tensors), model.first_layers.consts())
    return Graph(graph, inputs, outputs, kept)


def forward(model, pc: torch.Tensor, obj_id: torch.Tensor,
            pool_samples: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """The PoseNetOutput fields of ``model(pc, obj_id, pool_samples)`` by a
    replay of its graph in ``model.graphs``, captured first where there is
    none.  The replay runs on the current stream of the graph's device."""
    tensors = state_tensors(model)
    graphs = model.graphs

    def build() -> Graph:
        with span("model.graph_capture", graphs.captures):
            return capture(model, pc, obj_id, pool_samples, tensors)

    g = graphs.get(key(model, pc, obj_id, pool_samples, tensors), build)
    with span("model.graph_replay"):
        for static, x in zip(g.inputs, (pc, obj_id, *pool_samples)):
            static.copy_(x)
        g.graph.replay()
        return tuple(y.clone() for y in g.outputs)
