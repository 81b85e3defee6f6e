"""The port's profiler spans (``hspose_tpu_torch/utils/spans.py``) on the
CPU: free while no profiler runs; under ``torch.profiler`` one train step
records its forward, backward, metrics and optimizer spans in order on one
thread and one ``hspose.sync.*`` span per read that waits for the device
(the forward's list indices, host constants and solves, counted here by a
``TorchFunctionMode``; the NaN guard, the clip, one ``float()`` a metric),
and a two-batch ``batched_pose_inference`` records each batch's spans with
its batch number, landing each batch after the next is submitted."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from hspose_tpu_torch.config import HSPoseConfig
from hspose_tpu_torch.engine import train_step
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
from hspose_tpu_torch.models.hspose import build_model, train_forward
from hspose_tpu_torch.utils import spans
from hspose_tpu_torch.utils.spans import span
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host
B, N = 4, 128
OPTIMIZER = "Optimizer.step#Ranger.step"


def events(prof, prefix=("hspose.", OPTIMIZER)):
    """(name, start, end, thread, ident) of the profiled spans, by start."""
    out = []
    for e in prof.events():
        if e.name.startswith(prefix):
            ident = e.concrete_inputs[0] if e.concrete_inputs else None
            out.append((e.name, e.time_range.start, e.time_range.end, e.thread, ident))
    return sorted(out, key=lambda r: r[1])


def inside(inner, outer):
    return outer[3] == inner[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


def named(evs, name):
    return [e for e in evs if e[0] == name]


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a span entered the profiler while none runs")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("harness.land", 3) is spans.OFF and span("sync.term") is spans.OFF
    with span("train.forward"):
        with span("train.forward"):  # the shared context nests
            pass


class UploadsAndSolves(TorchFunctionMode):
    """Counts the calls that make the host wait for a CUDA device inside the
    train forward: an index holding a Python list (copied to the device
    first), ``new_tensor`` from host data, and ``torch.linalg.solve`` (its
    error check reads the solver's status)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            self.count += any(isinstance(i, list) for i in index)
        elif func in (torch.Tensor.new_tensor, torch.linalg.solve):
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_train_step_records_its_spans_and_one_sync_span_per_read(monkeypatch):
    cfg = HSPoseConfig()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_points=N),
                      train=dataclasses.replace(cfg.train, batch_size=B))
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu", train_heads=True)
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))
    batch = to_device(synthetic_train_batch(B, N, seed=3), "cpu")
    counted = UploadsAndSolves()

    def counted_forward(*args, **kw):
        with counted:
            return train_forward(*args, **kw)

    monkeypatch.setattr(train_step, "train_forward", counted_forward)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(batch)
    evs = events(prof)
    parts = [named(evs, n) for n in ("hspose.train.forward", "hspose.train.backward",
                                     OPTIMIZER, "hspose.train.metrics")]
    assert [len(p) for p in parts] == [1, 1, 1, 1]
    parts = [p[0] for p in parts]
    assert len({p[3] for p in parts}) == 1
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # in the step's order
    whole = named(evs, "hspose.train.step")
    assert len(whole) == 1 and all(inside(p, whole[0]) for p in parts)
    forward, _, optimizer, fetches = parts
    syncs = [e for e in evs if e[0].startswith("hspose.sync.")]
    in_forward = [e for e in syncs if inside(e, forward)]
    assert counted.count > 0 and len(in_forward) == counted.count
    assert {e[0] for e in in_forward} == {"hspose.sync.upload", "hspose.sync.solve"}
    # then the NaN guard, the clip, and one float() a returned metric but skipped_nan
    syncs = [e for e in syncs if e not in in_forward]
    assert metrics["skipped_nan"] == 0.0
    assert len(syncs) == 2 + len(metrics) - 1
    assert [e[0] for e in syncs[:2]] == ["hspose.sync.finite", "hspose.sync.clip"]
    assert forward[2] <= syncs[0][1] and inside(syncs[1], optimizer)
    assert [e[0] for e in syncs[2:]] == ["hspose.sync.total"] + ["hspose.sync.term"] * (
        len(metrics) - 2)
    assert all(inside(e, fetches) for e in syncs[2:])


def records(sizes, seed=0):
    """The harness's (data, detection, gts) records of random clouds."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        data = {"pcl_in": rng.normal(scale=0.2, size=(n, N, 3)).astype(np.float32),
                "cat_id_0base": rng.integers(0, 6, n),
                "sym_info": np.zeros((n, 4), np.float32),
                "mean_shape": rng.uniform(0.1, 0.3, (n, 3)).astype(np.float32)}
        out.append((data, {}, {}))
    return out


def test_harness_records_each_batch_and_lands_it_after_the_next():
    cfg = HSPoseConfig()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_points=N),
                      eval=dataclasses.replace(cfg.eval, eval_batch=B))
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu").eval()
    sizes = [3, 2, 3]  # two batches of B
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        results, _ = batched_pose_inference(cfg, model, records(sizes), seed=0)
    assert [len(d["pred_RTs"]) for d in results] == sizes
    evs = events(prof)
    # one a record, and the pull that finds the records' end
    assert len(named(evs, "hspose.harness.ingest")) == len(sizes) + 1
    to_dev, fwd, land = (named(evs, "hspose.harness." + n)
                         for n in ("to_device", "forward", "land"))
    for spans_of_batches in (to_dev, fwd, land):
        assert [e[4] for e in spans_of_batches] == [0, 1]
    for b in (0, 1):
        assert to_dev[b][2] <= fwd[b][1]
        assert len([e for e in named(evs, "hspose.sync.upload") if inside(e, to_dev[b])]) == 4
        for model_span in ("hspose.model.eval_forward", "hspose.model.generate_RT"):
            assert len([e for e in named(evs, model_span) if inside(e, fwd[b])]) == 1
        assert len([e for e in named(evs, "hspose.sync.fetch") if inside(e, land[b])]) == 2
    # batch 0 lands once batch 1 has been submitted; batch 1 at the end
    assert fwd[1][2] <= land[0][1] and land[0][2] <= land[1][1]
    whole = named(evs, "hspose.harness.request")
    assert len(whole) == 1
    assert all(inside(e, whole[0]) for e in evs if e[0].startswith("hspose.harness.")
               and e is not whole[0])
    # the CPU's forwards take the eager route, which records no graph span
    assert not [e for e in evs if e[0].startswith("hspose.model.graph_")]


def test_eager_forward_records_its_one_span_and_no_graph_span():
    """An eval forward on the eager route (every CPU forward) records
    ``hspose.model.eval_forward`` alone, as before the graph route."""
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward

    cfg = HSPoseConfig()
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    pc = torch.randn(B, N, 3, generator=g) * 0.2
    obj = torch.arange(B, dtype=torch.int32) % 6
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        eval_forward(model, pc, obj, pool_samples=draw_pool_samples(N, g, "cpu"))
        eval_forward(model, pc, obj, generator=g)
    assert [(e[0], e[4]) for e in events(prof)] == [("hspose.model.eval_forward", None)] * 2


@pytest.mark.parametrize("name,ident", [("harness.to_device", 7), ("sync.fetch", None)])
def test_span_under_a_profiler_names_and_numbers_it(name, ident):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with span(name, ident):
            pass
    evs = events(prof)
    assert [(e[0], e[4]) for e in evs] == [("hspose." + name, ident)]
