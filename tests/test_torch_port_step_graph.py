"""The train step's one read of its metrics and its graphed route
(``engine/graphed_step.py``) on the CPU, which cannot capture a CUDA graph.

* The forward's rewritten sites (cached index tensors in place of Python
  list indices, cached constants in place of ``new_tensor``, ``solve_ex``
  without its error check in place of ``solve``) give the values and
  strides of the expressions they replace, bit for bit, in fp32 and for
  the bf16 tier's inputs.
* A CPU step makes two reads that would wait for a card, ``hspose.sync.
  metrics`` and Ranger's ``hspose.sync.clip`` (counted by the span recorder
  of ``tools/sync_sites.py``), and its metrics are those of a step that
  fetches each term with ``float()``.
* A non-finite batch, whose backward now runs, still leaves the parameters,
  BatchNorm statistics, optimizer state and counts as they were.
* The route's choice, and the graphed route's logic on a stand-in graph
  that runs the pass eagerly at each replay: the first step is the
  warm-up, the second captures, and every step equals the eager route's
  bit for bit, NaN skips and accumulation included.  The capture itself,
  its bits and its kernels are checked on the card (``chip_smoke.py
  --phase train-graph``).
"""

import contextlib
import copy
import dataclasses
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hspose_tpu_torch.config import HSPoseConfig, TrainConfig
from hspose_tpu_torch.data import augment
from hspose_tpu_torch.engine import graphed_step
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.geometry import planes
from hspose_tpu_torch.losses import prop_loss, recon_loss
from hspose_tpu_torch.models.hspose import build_model, draw_train, train_forward
from hspose_tpu_torch.tools.sync_sites import _Recorder
from hspose_tpu_torch.utils import spans
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host
B, N = 4, 128
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def old_fit_plane(pc, w):
    """``geometry/planes.py::fit_plane_weighted`` as it was, with
    ``torch.linalg.solve``."""
    A = torch.cat([pc[..., :2], torch.ones_like(pc[..., :1])], dim=-1)
    Aw = A * w[..., None]
    X = torch.linalg.solve(A.transpose(-1, -2) @ Aw,
                           A.transpose(-1, -2) @ (pc[..., 2:3] * w[..., None]))[..., 0]
    x0, x1, x2 = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    dn_norm = x0 * x0 + x1 * x1 + 1.0
    dn = torch.cat([x0 * x2, x1 * x2, -x2], dim=-1) / (dn_norm + 1e-8)
    return dn / torch.linalg.vector_norm(dn, dim=-1, keepdim=True), dn, x2 / torch.sqrt(dn_norm)


def rewritten(case, dt):
    """(new, old) outputs of one rewritten site on random inputs of type
    ``dt``.  The plane fit takes the bf16 tier's inputs as the tier hands
    them to the losses, widened to fp32 (LU has no bf16 kernel)."""
    g = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dt)

    if case == "defor_bb swap":
        x = rand(B, 3)
        return [augment._xz_swapped(x)], [x[:, [2, 1, 0]]]
    if case == "face remap":
        faces = (rand(B, N, 6, 3), rand(B, N, 6), rand(B, N, 6))
        return (recon_loss._remapped(*faces),
                [f[:, :, list(recon_loss.FACE_REMAP)] for f in faces])
    if case == "y rows":
        n_up, n_down = rand(B, 3, 3), rand(B, 3, 3)
        return ([recon_loss._y_rows(n_up), recon_loss._y_rows(n_down)],
                [n_up[:, [1, 1, 1]], n_down[:, [1, 1, 1]]])
    if case == "prop signs":
        cano = rand(B, N, 3)
        return (list(prop_loss._reflection_signs(cano)),
                [cano.new_tensor(prop_loss._Y_REF), cano.new_tensor(prop_loss._YX_REF)])
    assert case == "plane solve"
    pc, w = rand(B, 3, N, 3).float(), rand(B, 3, N).abs().float()
    return list(planes.fit_plane_weighted(pc, w)), list(old_fit_plane(pc, w))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["defor_bb swap", "face remap", "y rows", "prop signs",
                                  "plane solve"])
def test_rewritten_sites_match_what_they_replace(case, dtype):
    new, old = rewritten(case, DTYPES[dtype])
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride(), case
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num()), case


def config(accumulate=1, debug_nan=False):
    cfg = HSPoseConfig(train=TrainConfig(accumulate=accumulate, debug_nan=debug_nan))
    return cfg.replace(data=dataclasses.replace(cfg.data, num_points=N),
                       optim=dataclasses.replace(cfg.optim, lr=1e-3, warmup_iters=0))


def model_and_step(cfg, seed=0):
    torch.manual_seed(seed)
    model = build_model(cfg.model, device="cpu", train_heads=True)
    return model, build_train_step(cfg, model, torch.Generator().manual_seed(seed + 1))


def batch_of(seed):
    return to_device(synthetic_train_batch(B, N, seed=seed), "cpu")


def nan_batch(seed=3):
    b = batch_of(seed)
    return dict(b, pcl_in=torch.full_like(b["pcl_in"], float("nan")))


class Entered(_Recorder):
    """``tools/sync_sites.py``'s recorder, also keeping every span entered."""

    def __init__(self):
        super().__init__()
        self.entered = []

    def _record_function_with_args_enter(self, name, *args):
        self.entered.append(name)
        return super()._record_function_with_args_enter(name, *args)


def test_cpu_step_reads_the_card_twice(monkeypatch):
    """One read of the metrics and Ranger's clip decision: no other
    ``hspose.sync.*`` span, none inside the forward."""
    model, step = model_and_step(config())
    batch = batch_of(3)
    rec = Entered()
    monkeypatch.setattr(spans, "torch", types.SimpleNamespace(autograd=rec))
    metrics = step(batch)
    syncs = [n for n in rec.entered if n.startswith("hspose.sync.")]
    assert metrics["skipped_nan"] == 0.0 and step.optimizer.count == 1
    assert syncs == ["hspose.sync.metrics", "hspose.sync.clip"]
    assert [n for n in rec.entered if n.startswith("hspose.train.")] == [
        "hspose.train.step", "hspose.train.forward", "hspose.train.backward",
        "hspose.train.metrics"]
    assert rec.open == []


@pytest.mark.parametrize("debug_nan", [False, True])
def test_metrics_are_those_of_a_step_that_reads_each_term(debug_nan):
    """The one read gives the keys, order and values of ``float()`` on the
    total and each term, and 1.0 / 0.0 finiteness flags per family."""
    cfg = config(debug_nan=debug_nan)
    model, step = model_and_step(cfg)
    twin = copy.deepcopy(model).train()
    batch = batch_of(4)
    draws = draw_train(torch.Generator().manual_seed(9), B, N)
    got = step(batch, draws)
    total, loss_dicts = train_forward(cfg, twin, batch, draws=draws)
    want = {"total_loss": float(total.detach()), "skipped_nan": 0.0}
    for fam, d in loss_dicts.items():
        for k, v in d.items():
            want[f"{fam}/{k}"] = float(v.detach())
    if debug_nan:
        for fam, d in loss_dicts.items():
            want[f"finite/{fam}"] = float(all(bool(torch.isfinite(v).all()) for v in d.values()))
    assert list(got) == list(want)
    assert got == want


def snapshot(model, step):
    opt = step.optimizer
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [{k: v.clone() for k, v in opt.state[p].items()} for p in model.parameters()],
            opt.count, step.mini_step, [a.clone() for a in step.accumulator])


def assert_same_snapshot(a, b):
    (sa, oa, ca, ma, aa), (sb, ob, cb, mb, ab) = a, b
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
               for x, y in zip(oa, ob))
    assert (ca, ma) == (cb, mb) and all(torch.equal(x, y) for x, y in zip(aa, ab))


@pytest.mark.parametrize("anomaly", [False, True])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_a_nan_batch_moves_nothing(accumulate, anomaly):
    """The backward of a non-finite loss runs (under anomaly mode, which
    raises on its NaN gradients, it waits for the decision and does not),
    and nothing it gives is read: parameters, BatchNorm statistics,
    Ranger's state and count, the accumulator and its micro-step stay as
    they were."""
    model, step = model_and_step(config(accumulate=accumulate, debug_nan=True))
    step(batch_of(1))  # with accumulate 2, mid-way through an optimizer step
    before = snapshot(model, step)
    with torch.autograd.set_detect_anomaly(anomaly):
        m = step(nan_batch())
    assert m["skipped_nan"] == 1.0 and math.isnan(m["total_loss"])
    assert all(m[f"finite/{f}"] == 0.0 for f in ("fsnet_loss", "recon_loss", "geo_loss",
                                                  "prop_loss"))
    assert_same_snapshot(before, snapshot(model, step))
    assert step(batch_of(2))["skipped_nan"] == 0.0
    assert step.optimizer.count == (2 if accumulate == 1 else 1)


CARD = types.SimpleNamespace(is_cuda=True)  # what ``eligible`` reads of a card's tensor


@pytest.mark.parametrize("case", ["card", "cpu", "mesh", "crops", "anomaly"])
def test_route_choice(case):
    """Only a batch of clouds on the card, on one process, without anomaly
    mode, takes the graph."""
    batch = {k: CARD for k in ("pcl_in", "cat_id", "rotation")}
    mesh = None
    ctx = contextlib.nullcontext()
    if case == "cpu":
        batch = batch_of(0)
    elif case == "mesh":
        mesh = object()
    elif case == "crops":
        batch = {k: CARD for k in ("roi_depth", "roi_mask", "roi_coord", "cam_k", "cat_id")}
    elif case == "anomaly":
        ctx = torch.autograd.set_detect_anomaly(True)
    with ctx:
        assert graphed_step.eligible(batch, mesh) == (case == "card")


class Replayed:
    """A stand-in for a captured pass on the CPU: a replay runs the pass
    eagerly and writes its outputs into the static ones."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        fresh = self.body()
        for s, v in zip([self.out.values, *self.out.saved, *self.out.grads],
                        [fresh.values, *fresh.saved, *fresh.grads]):
            if s is not None:
                s.copy_(v)


@pytest.fixture
def stand_in(monkeypatch):
    """The graphed route on the CPU, with stand-in captures that leave the
    model as they found it (a capture runs nothing); returns the number of
    captures made, one entry a capture."""
    captured = []

    def capture(body, stream):
        out = body()
        with torch.no_grad():  # undo the pass's BatchNorm update
            for b, s in zip(bn_of(captured_model[0]), out.saved):
                b.copy_(s)
        out = out._replace(values=torch.full_like(out.values, float("nan")))
        captured.append(stream)
        return Replayed(body, out), out

    captured_model = []
    monkeypatch.setattr(graphed_step, "capture", capture)
    monkeypatch.setattr(graphed_step, "eligible", lambda batch, mesh: mesh is None)
    monkeypatch.setattr(graphed_step, "new_stream", lambda device: "stream")
    monkeypatch.setattr(graphed_step, "side_stream", lambda stream: contextlib.nullcontext())
    return captured, captured_model


def bn_of(model):
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_graphed_route_steps_as_the_eager_route(stand_in, accumulate):
    """Five steps with a NaN batch in the middle, the step's own draws:
    metrics, parameters, statistics, Ranger's state and the accumulator
    bit for bit the eager route's; one capture, at the second step, and a
    replay at every step after the first."""
    captured, captured_model = stand_in
    cfg = config(accumulate=accumulate)
    model, step = model_and_step(cfg)
    eager_model, eager_step = model_and_step(cfg)
    captured_model.append(model)
    order = [batch_of(1), batch_of(2), nan_batch(), batch_of(3), batch_of(4)]
    for i, batch in enumerate(order):
        got = step(batch)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graphed_step, "eligible", lambda *args: False)
            want = eager_step(batch)
        assert got.keys() == want.keys() and all(
            got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])) for k in got), i
        assert_same_snapshot(snapshot(model, step), snapshot(eager_model, eager_step))
        assert step.graphs.replays == i and len(captured) == min(i, 1)
        assert eager_step.graphs.replays == 0
    assert step.graphs.captures == 1 and captured == ["stream"]
    assert step.optimizer.count == (4 if accumulate == 1 else 2)


def test_graphed_route_takes_the_callers_draws(stand_in):
    """Given draws are copied into the graph's: the step equals the eager
    step on them, and the step's generator is not drawn from."""
    captured, captured_model = stand_in
    cfg = config()
    model, step = model_and_step(cfg)
    eager_model, eager_step = model_and_step(cfg)
    captured_model.append(model)
    for i in range(3):
        draws = draw_train(torch.Generator().manual_seed(20 + i), B, N)
        got = step(batch_of(i), draws)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graphed_step, "eligible", lambda *args: False)
            want = eager_step(batch_of(i), draws)
        assert got == want
    assert_same_snapshot(snapshot(model, step), snapshot(eager_model, eager_step))
    assert step.graphs.replays == 2


def test_a_new_layout_warms_up_and_captures_its_own_graph(stand_in):
    captured, captured_model = stand_in
    model, step = model_and_step(config())
    captured_model.append(model)
    small = {k: v[:2] for k, v in batch_of(1).items()}
    for batch in (batch_of(1), batch_of(2), small, small, batch_of(3)):
        step(batch)
    assert step.graphs.captures == 2 and step.graphs.replays == 3
    assert len(step.graphs.graphs) == 2


def test_graphed_route_records_one_forward_span_a_step(stand_in):
    """``hspose.train.forward`` once a step (``portbench/spans.py::STEP``):
    on the warm-up the eager one with its backward, then around the draws,
    the capture and the replay, with no backward span."""
    captured, captured_model = stand_in
    model, step = model_and_step(config())
    captured_model.append(model)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for i in range(3):
            step(batch_of(i))
    evs = sorted(((e.name, e.time_range.start, e.time_range.end,
                   e.concrete_inputs[0] if e.concrete_inputs else None)
                  for e in prof.events() if e.name.startswith("hspose.train.")),
                 key=lambda r: r[1])
    fwd = [e for e in evs if e[0] == "hspose.train.forward"]
    steps = [e for e in evs if e[0] == "hspose.train.step"]
    capture = [e for e in evs if e[0] == "hspose.train.graph_capture"]
    replay = [e for e in evs if e[0] == "hspose.train.graph_replay"]
    backward = [e for e in evs if e[0] == "hspose.train.backward"]
    # the stand-in capture and replays run the eager pass, spans and all, inside
    outer = [e for e in fwd if not any(o[1] < e[1] and e[2] < o[2] for o in fwd)]
    assert len(steps) == 3 and len(outer) == 3 and len(capture) == 1 and len(replay) == 2
    assert capture[0][3] == 0
    for s, f in zip(steps, outer):
        assert s[1] <= f[1] and f[2] <= s[2]
    assert outer[1][1] <= capture[0][1] and capture[0][2] <= replay[0][1]
    assert replay[0][2] <= outer[1][2] and outer[2][1] <= replay[1][1]
    assert backward[0][2] <= steps[0][2]  # the warm-up's own
    assert np.all([e[1] >= outer[1][1] for e in backward[1:]])
