"""The served forward as a CUDA graph replay (``models/graphed.py``) on the
CPU, which cannot capture one: the route's choice, the graph's key and the
one-graph cache as plain functions, the replay logic on a stand-in
graph that runs the module eagerly, and the eager route that every CPU
forward keeps, bit for bit the module's, in the harness too.  The capture
itself, its bits and its kernels are checked on the card
(``chip_smoke.py --phase graph``)."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
from hspose_tpu_torch.geometry.rotations import generate_RT
from hspose_tpu_torch.models import graphed
from hspose_tpu_torch.models.hspose import build_model, draw_pool_samples, eval_forward

torch.set_num_threads(2)  # the suite runs several workers on one host
B, N = 4, 128
CARD = types.SimpleNamespace(is_cuda=True)  # what ``eligible`` reads of a card's cloud


def inputs(seed=0, b=B, n=N):
    g = torch.Generator().manual_seed(seed)
    pc = torch.randn(b, n, 3, generator=g) * 0.2
    obj = torch.randint(0, 6, (b,), generator=g, dtype=torch.int32)
    return pc, obj, draw_pool_samples(n, g, "cpu")


def model_of(dtype="float32", seed=0, train_heads=False):
    torch.manual_seed(seed)
    return build_model(ModelConfig(compute_dtype=dtype), device="cpu", train_heads=train_heads)


@pytest.mark.parametrize("case", ["served", "cpu", "train_mode", "sp_group", "mp_layer",
                                  "with_heads"])
def test_route_choice(case):
    """Only a served forward on the card takes the graph: not CPU tensors,
    train mode, an sp group, a head layer sharded over mp or ``with_heads``
    (asked, as eval_forward asks, without gradients)."""
    model = model_of()
    pc, sp_group, with_heads = CARD, None, False
    if case == "cpu":
        pc = inputs()[0]
    elif case == "train_mode":
        model.train()
    elif case == "sp_group":
        sp_group = object()
    elif case == "mp_layer":
        model.rot_red.vec.conv1.mp_group = object()
    elif case == "with_heads":
        with_heads = True
    with torch.no_grad():
        assert graphed.eligible(model, pc, with_heads, sp_group) == (case == "served")


@pytest.mark.parametrize("case", ["served", "with_heads", "train_mode"])
def test_cpu_forwards_take_the_eager_route(case, monkeypatch):
    """eval_forward on the CPU never reaches the graph route."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU forward reached the graph route")

    monkeypatch.setattr(graphed, "forward", refuse)
    model = model_of(train_heads=case != "served")
    if case == "train_mode":
        model.train()
    pc, obj, smp = inputs()
    eval_forward(model, pc, obj, pool_samples=smp, with_heads=case == "with_heads")
    assert model.graphs.graph is None and model.graphs.captures == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_on_the_cpu_is_the_module_bit_for_bit(dtype):
    model = model_of(dtype)
    pc, obj, smp = inputs(1)
    with torch.no_grad():
        want = model(pc, obj, smp)
    got = eval_forward(model, pc, obj, pool_samples=smp)
    assert type(got) is type(want)
    for name, x, y in zip(want._fields, got, want):
        assert torch.equal(x, y), name


def key_of(model, pc, obj, smp):
    return graphed.key(model, pc, obj, smp, graphed.state_tensors(model))


def test_state_tensors_are_every_parameter_and_buffer():
    model = model_of()
    want = {id(t) for t in (*model.parameters(), *model.buffers())}
    assert {id(t) for t in graphed.state_tensors(model)} == want


@pytest.mark.parametrize("write", ["load_state_dict", "in_place_parameter",
                                   "batch_norm_buffer", "new_storage"])
def test_key_changes_after_a_write(write):
    model = model_of()
    pc, obj, smp = inputs()
    before = key_of(model, pc, obj, smp)
    if write == "load_state_dict":
        model.load_state_dict(model_of(seed=3).state_dict())
    elif write == "in_place_parameter":
        with torch.no_grad():
            model.ts.vec.conv4.weight.mul_(1.5)
    elif write == "batch_norm_buffer":
        with torch.no_grad():
            model.rot_green.vec.bn2.running_var.add_(0.25)
    else:  # what ``.to()`` does to a parameter
        model.rot_green.vec.conv3.weight.data = model.rot_green.vec.conv3.weight.data.clone()
    after = key_of(model, pc, obj, smp)
    assert after[0] == before[0] and after[1] != before[1]


def test_key_is_the_same_across_calls_with_new_inputs():
    model = model_of()
    pc, obj, smp = inputs(0)
    first = key_of(model, pc, obj, smp)
    eval_forward(model, pc, obj, pool_samples=smp)
    pc2, obj2, smp2 = inputs(1)
    assert key_of(model, pc2, obj2, smp2) == first


@pytest.mark.parametrize("change", ["batch", "points", "obj_dtype", "samples", "tier"])
def test_key_tells_shapes_and_types_apart(change):
    model = model_of()
    pc, obj, smp = inputs()
    first = key_of(model, pc, obj, smp)
    if change == "batch":
        pc, obj = pc[:2], obj[:2]
    elif change == "points":
        pc, obj, smp = inputs(n=2 * N)
    elif change == "obj_dtype":
        obj = obj.long()
    elif change == "samples":
        smp = [smp[0][:-1], smp[1]]
    else:
        model = model_of("bfloat16")
        first = (first[0], key_of(model, pc, obj, smp)[1])
    assert key_of(model, pc, obj, smp)[0] != first[0]


def test_one_graph_kept_and_captured_anew_when_the_key_changes():
    """The model keeps the last graph: a call under its key replays it, a
    call under another drops it before the capture (its pool is freed
    first) and keeps the new one."""
    cache = graphed.Graphs()
    built = []

    def build(k):
        def run():
            assert cache.graph is None and cache.key is None  # the old one dropped
            built.append(k)
            return f"graph {k}"
        return run

    for k in (("B=96", 1), ("B=96", 1), ("B=24", 1), ("B=96", 1), ("B=96", 2), ("B=96", 2)):
        assert cache.get(k, build(k)) == f"graph {k}"
        assert cache.key == k
    assert built == [("B=96", 1), ("B=24", 1), ("B=96", 1), ("B=96", 2)]
    assert cache.captures == 4


@pytest.mark.parametrize("draw", ["given", "drawn"])
def test_pool_samples_reach_the_graph_on_the_clouds_device(draw, monkeypatch):
    """Pool samples kept or drawn on the host (``fast_mode_parity.predict``'s
    ``pool_device="cpu"``) go to the graph route on the cloud's device: a
    capture would raise on their pageable copy.  The "meta" device, which
    keeps shapes and no values, stands in for the card's."""
    got = []
    monkeypatch.setattr(graphed, "eligible", lambda *args: True)
    monkeypatch.setattr(graphed, "forward",
                        lambda model, pc, obj, smp: got.append(smp) or [None] * 6)
    model = model_of()
    pc, obj, smp = inputs()
    g = torch.Generator().manual_seed(5)
    want = smp if draw == "given" else draw_pool_samples(N, torch.Generator().manual_seed(5))
    eval_forward(model, pc.to("meta"), obj.to("meta"),
                 pool_samples=smp if draw == "given" else None, generator=g)
    (samples,) = got
    assert [s.device.type for s in samples] == ["meta", "meta"]
    assert [(s.shape, s.dtype) for s in samples] == [(s.shape, s.dtype) for s in want]


class Replayed:
    """A stand-in for a captured graph on the CPU: a replay runs the module
    on the static inputs and writes the static outputs."""

    def __init__(self, model, inputs, outputs):
        self.model, self.inputs, self.outputs = model, inputs, outputs

    def replay(self):
        out = self.model(self.inputs[0], self.inputs[1], self.inputs[2:])
        for o, v in zip(self.outputs, out):
            o.copy_(v)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph route on the CPU, with stand-in captures; returns the
    models captured, one entry a capture."""
    captured = []

    def capture(model, pc, obj_id, pool_samples, tensors):
        ins = tuple(x.clone() for x in (pc, obj_id, *pool_samples))
        outs = tuple(torch.full_like(o, float("nan"))
                     for o in model(ins[0], ins[1], ins[2:]))
        captured.append(model)
        return graphed.Graph(Replayed(model, ins, outs), ins, outs, ())

    monkeypatch.setattr(graphed, "capture", capture)
    monkeypatch.setattr(graphed, "eligible", lambda *args: True)
    return captured


def test_replays_return_fresh_outputs_and_recapture_after_new_weights(stand_in):
    model = model_of()
    (pc, obj, smp), (pc2, obj2, smp2) = inputs(0), inputs(1)
    with torch.no_grad():
        want, want2 = model(pc, obj, smp), model(pc2, obj2, smp2)
    first = eval_forward(model, pc, obj, pool_samples=smp)
    kept = [x.clone() for x in first]
    second = eval_forward(model, pc2, obj2, pool_samples=smp2)
    assert len(stand_in) == 1  # one capture serves both calls
    for name, a, b, k, x, y in zip(want._fields, first, second, kept, want, want2):
        assert torch.equal(a, x) and torch.equal(b, y), name
        assert torch.equal(a, k), name  # the second replay left the first outputs alone
        assert a.data_ptr() != b.data_ptr(), name
    model.load_state_dict(model_of(seed=3).state_dict())
    with torch.no_grad():
        want3 = model(pc, obj, smp)
    third = eval_forward(model, pc, obj, pool_samples=smp)
    assert len(stand_in) == 2 and model.graphs.captures == 2  # the old state's dropped
    for name, x, y in zip(want._fields, third, want3):
        assert torch.equal(x, y), name


def test_graph_route_records_its_spans_inside_eval_forward(stand_in):
    model = model_of()
    pc, obj, smp = inputs()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            eval_forward(model, pc, obj, pool_samples=smp)
    evs = sorted(((e.name, e.time_range.start, e.time_range.end,
                   e.concrete_inputs[0] if e.concrete_inputs else None)
                  for e in prof.events() if e.name.startswith("hspose.model.")),
                 key=lambda r: r[1])
    fwd = [e for e in evs if e[0] == "hspose.model.eval_forward"]
    cap = [e for e in evs if e[0] == "hspose.model.graph_capture"]
    rep = [e for e in evs if e[0] == "hspose.model.graph_replay"]
    assert len(fwd) == 2 and len(cap) == 1 and len(rep) == 2
    assert cap[0][3] == 0  # the model's first capture
    assert fwd[0][1] <= cap[0][1] and cap[0][2] <= rep[0][1] and rep[0][2] <= fwd[0][2]
    assert fwd[1][1] <= rep[1][1] and rep[1][2] <= fwd[1][2]


def test_a_copy_of_the_model_keeps_no_graph(stand_in):
    """A graph reads the memory of the tensors it was captured on: a deep
    copy or a pickle of the model starts with none."""
    import copy
    import pickle

    model = model_of()
    pc, obj, smp = inputs()
    want = eval_forward(model, pc, obj, pool_samples=smp)
    for other in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert other.graphs.graph is None and other.graphs.captures == 0
        got = eval_forward(other, pc, obj, pool_samples=smp)
        assert other.graphs.captures == 1 and all(map(torch.equal, got, want))
    assert model.graphs.captures == 1 and model.graphs.graph is not None


def records(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [({"pcl_in": rng.normal(scale=0.2, size=(n, N, 3)).astype(np.float32),
              "cat_id_0base": rng.integers(0, 6, n),
              "sym_info": np.stack([rng.integers(0, 2, n), np.zeros(n), np.zeros(n),
                                    np.zeros(n)], 1).astype(np.float32),
              "mean_shape": rng.uniform(0.1, 0.3, (n, 3)).astype(np.float32)}, {}, {})
            for n in sizes]


def test_harness_on_the_cpu_serves_the_forwards_poses():
    """``batched_pose_inference`` (its uploads unpinned on the CPU) returns
    the poses of ``eval_forward`` and ``generate_RT`` on its padded batches,
    bit for bit."""
    cfg = HSPoseConfig()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_points=N),
                      eval=dataclasses.replace(cfg.eval, eval_batch=B))
    model = model_of()
    sizes = [3, 2, 3, 1]  # batches of 4, 4 and 1 padded with its crop 0
    recs = records(sizes)
    smp = inputs()[2]
    results, _ = batched_pose_inference(cfg, model, recs, seed=0, pool_samples=smp)
    crops = {k: np.concatenate([r[0][k] for r in recs]) for k in recs[0][0]}
    RT, scales = [], []
    for at in range(0, len(crops["pcl_in"]), B):
        rows = list(range(at, min(at + B, len(crops["pcl_in"]))))
        rows += [rows[0]] * (B - len(rows))

        def t(k, dtype=torch.float32):
            return torch.from_numpy(crops[k][rows]).to(dtype)

        out = eval_forward(model, t("pcl_in"), t("cat_id_0base", torch.int32), pool_samples=smp)
        RT.append(generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                              out.pred_T, t("sym_info")).numpy())
        scales.append((out.pred_s + t("mean_shape")).numpy())
    n = sum(sizes)
    got_RT = np.concatenate([d["pred_RTs"] for d in results])
    got_s = np.concatenate([d["pred_scales"] for d in results])
    assert np.array_equal(got_RT, np.concatenate(RT)[:n].astype(np.float64))
    assert np.array_equal(got_s, np.concatenate(scales)[:n].astype(np.float64))
