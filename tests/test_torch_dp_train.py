"""The port's data-parallel train step (``parallel.dp``,
``hspose_tpu_torch/parallel``) on the CPU, against the JAX package's dp
step and against the port's one-process step on the same global batch.

Process groups are real: ``tests/_torch_dist_worker.py`` starts two ranks
of a ``gloo`` group (dp = 2), each with the pytest process's thread count,
and every rank steps on its 4 rows of a global batch of 8 at N = 128 with
the global batch's draws pinned.  Both sides start from one initial tree:
the port's initialisation as flax trees (``utils/convert.py::
flax_variables``), carried back into the port by ``load_jax_params``.

Gates, each with its reason:

* against JAX's dp step on the 8-device CPU mesh (``make_mesh`` and
  ``shard_batch``, tests/test_parallel.py:45-76): the gates of
  tests/test_torch_port_step.py: every loss term within 1e-3 relative, the
  BatchNorm statistics within 1e-3 of each buffer's largest value, the
  parameter update within norm_rel 5e-2 and cosine 0.999 (the train
  forward's KNN and max selections flip under fp32 summation order);
* against the port's one-process step on the same batch and draws (run in
  a process of its own beside the group, or after it for the resume): the dp
  step sums BatchNorm's moments per rank and adds the ranks' gradient
  shares, so it differs from one process by summation order only.  The
  cases measured loss terms within 2.0e-5 relative, BatchNorm statistics
  within 2.3e-6 of their largest and the update within norm_rel 4.6e-3
  and cosine 0.999989 (a selection flip moves the update most); the gates
  are the tighter LOSS_REL, BN_REL, UPDATE_REL and UPDATE_COS below, four
  to ten times those;
* every rank's state (parameters, BatchNorm buffers, Ranger's moments and
  slow weights, the accumulator, the counts) bit for bit rank 0's: the
  ranks compute the same global losses and reduce to the same gradient;
* the NaN skip: a NaN in one rank's rows skips the step on every rank and
  leaves the state bit for bit as it was;
* a resume: a dp = 2 checkpoint resumed under dp = 2 steps bit for bit as
  the unbroken run, and resumed in one process within the one-process
  gates (the port of tests/test_parallel.py::test_cross_mesh_shape_resume).
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from hspose_tpu.config import ParallelConfig as JParallelConfig
from hspose_tpu.engine.optimizer import build_optimizer
from hspose_tpu.engine.train_step import TrainState, make_train_step
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.parallel.mesh import make_mesh as j_make_mesh
from hspose_tpu.parallel.mesh import replicate_state, shard_batch as j_shard_batch
from hspose_tpu_torch.config import DataConfig, HSPoseConfig
from hspose_tpu_torch.data import dataset as pds
from hspose_tpu_torch.data.augment import AugmentDraws
from hspose_tpu_torch.engine.checkpoint import restore_checkpoint
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models.hspose import TrainDraws, build_model, draw_train
from hspose_tpu_torch.parallel.mesh import Mesh, batch_sharding
from hspose_tpu_torch.utils.convert import flax_variables, load_jax_params, port_name
from test_data_pipeline import nocs_root  # noqa: F401  (fixture)
from test_torch_port_step import configs
from test_torch_port_train import N, Pinned, _flat, train_batch

import _torch_dist_worker as worker

torch.set_num_threads(2)  # the suite runs several workers on one host
B, DP = 8, 2  # the global batch and the data axis
LOSS_REL, BN_REL, UPDATE_REL, UPDATE_COS = 1e-4, 2e-5, 2e-2, 0.9999


def global_batch(seed: int, sym_rows=(1, 2, 5)) -> dict:
    """Two of tests/test_torch_port_train.py's batches of 4 as one of 8,
    with the axis-symmetric samples (sym[:, 0] == 1, which the red-axis and
    geometry terms leave out) at ``sym_rows``."""
    batch = {k: np.concatenate([a, b]) for (k, a), b in
             zip(train_batch(seed).items(), train_batch(seed + 1).values())}
    sym = np.zeros((B, 4), np.float32)
    sym[list(sym_rows), 0] = 1.0
    sym[::3, 1] = 1.0
    batch["sym_info"] = sym
    return batch


def draws(seed: int) -> TrainDraws:
    return Pinned(seed, True, B).port()


CFG = configs()[1]
CFG_ACC = configs(accumulate=2)[1]


def nan_rows(batch: dict) -> dict:
    """``batch`` with rank 1's clouds all NaN."""
    pc = batch["pcl_in"].copy()
    pc[B // DP:] = np.nan
    return dict(batch, pcl_in=pc)


def cases() -> dict:
    """name -> (config, [(global batch, global draws or None)], options).
    ``run``: step 1 (the JAX comparison), its checkpoint, step 2, and a
    batch with NaN in rank 1's rows."""
    one, two = (global_batch(4), draws(6)), (global_batch(8), draws(7))
    return {
        "run": (CFG, [one, two, (nan_rows(two[0]), two[1])], {"save_after": 0}),
        # rank 0 holds every symmetric sample, and then no valid row at all
        "sym_one_rank": (CFG, [(global_batch(4, (0, 2)), draws(6))], {}),
        "no_valid_row": (CFG, [(global_batch(4, (0, 1, 2, 3)), draws(6))], {}),
        "drawn": (CFG, [(one[0], None)], {}),  # the step's own generator, at global B
        "accumulate": (CFG_ACC, [one, two], {}),
        "resume": (CFG, [two], {}),
    }


def jax_start(jcfg):
    """(JAX model, optimizer, initial train state, the port's state dict)
    from one initial tree: the port's initialisation, written out as flax
    trees (``flax_variables``) and carried back into the port by
    ``load_jax_params``, so that both sides start from the same numbers
    without the JAX model's initialisation."""
    torch.manual_seed(0)
    model = build_model(HSPoseConfig().model, device="cpu", train_heads=True)
    params, stats = flax_variables(model)
    load_jax_params(model, params, stats)
    tx = build_optimizer(jcfg.optim, jcfg.train.train_steps * jcfg.train.total_epoch)
    state = TrainState(step=np.zeros([], np.int32), params=params, batch_stats=stats,
                       opt_state=jax.device_get(tx.init(params)))
    return j_build_model(jcfg), tx, state, model.state_dict()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The initial tree and the JAX package's dp = 2 step on ``global_batch
    (4)`` with ``Pinned(6, True, 8)``'s draws, and the two gloo ranks' runs
    of every case from the same tree (started first, and run meanwhile):
    a dict of the start state dict, the checkpoint, the ranks' per-step
    results, and JAX's (start params, state after the step, metrics)."""
    d = tmp_path_factory.mktemp("dp_train")
    jcfg, _ = configs()
    with pytest.MonkeyPatch.context() as mp:
        Pinned(6, True, B).patch_jax(mp)
        jmodel, tx, host, start = jax_start(jcfg)
        tasks = {name: {"kind": "train", "cfg": cfg, "dp": DP, "mp": 1, "state_dict": start,
                        "batches": steps, **opts}
                 for name, (cfg, steps, opts) in cases().items()}
        tasks["run"]["save"] = str(d / "ckpt")
        tasks["resume"]["resume"] = str(d / "ckpt" / "model_000")
        ranks = worker.start(d, DP, {"tasks": tasks})
        # the one-process references of the cases' first steps, meanwhile
        one = tmp_path_factory.mktemp("one_process")
        refs = {name: dict(tasks[name], dp=1, batches=tasks[name]["batches"][:1], save=None)
                for name in ("run", "sym_one_rank", "no_valid_row", "drawn")}
        refs["accumulate"] = dict(tasks["accumulate"], dp=1)
        reference = worker.start(one, 1, {"tasks": refs})
        mesh = j_make_mesh(JParallelConfig(dp=DP))
        state, metrics = make_train_step(jcfg, jmodel, tx)(
            replicate_state(mesh, host), j_shard_batch(mesh, global_batch(4)),
            jax.random.key(1))
    return {"start": start, "ckpt": d / "ckpt" / "model_000", "outs": ranks(),
            "one": reference()[0],
            "jax": (host.params, jax.device_get(state), jax.device_get(metrics))}


def one_process(start, cfg, steps, resume=None):
    """The port's one-process step on the global batches: per step (metrics,
    state)."""
    model = build_model(cfg.model, device="cpu", train_heads=True)
    model.load_state_dict(start)
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))
    if resume is not None:
        restore_checkpoint(str(resume), model, step)
    return [(step(to_device(b, "cpu"), d), worker.state(model, step)) for b, d in steps]


def same_metrics(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def assert_same_on_every_rank(outs, name):
    """Every rank's metrics and state (parameters, BatchNorm buffers,
    Ranger's moments and slow weights, accumulator, counts) rank 0's bits."""
    for r, out in enumerate(outs[1:], 1):
        for i, (a, b) in enumerate(zip(out[name], outs[0][name])):
            assert same_metrics(a["metrics"], b["metrics"]), (name, r, i)
            assert same_state(a["state"], b["state"]), (name, r, i)


def same_state(a: dict, b: dict) -> bool:
    return (a["digest"] == b["digest"] and a["count"] == b["count"]
            and a["mini_step"] == b["mini_step"])


def gaps(got: dict, want: dict, start: dict) -> dict:
    """The worst BatchNorm statistic gap as a share of its buffer's largest
    value, and the parameter update's norm_rel and cosine against
    ``want``'s, all leaves as one vector."""
    got, want = got["model"], want["model"]
    bn = max(((got[k] - v).abs().max() / v.abs().max()).item() for k, v in want.items()
             if "running" in k)
    names = [k for k in want if "running" not in k and "num_batches" not in k]
    g = torch.cat([(got[k] - start[k]).double().ravel() for k in names])
    w = torch.cat([(want[k] - start[k]).double().ravel() for k in names])
    return {"bn": bn, "norm_rel": ((g - w).norm() / w.norm()).item(),
            "cos": (g @ w / (g.norm() * w.norm())).item(), "moved": w.norm().item()}


def assert_close_to_one_process(got, want, start, what,
                                gates=(LOSS_REL, BN_REL, UPDATE_REL, UPDATE_COS)):
    """(metrics, state) against the one-process step's, at ``gates``: the
    loss terms' relative gap, BatchNorm's gap as a share of each buffer's
    largest value, the update's norm_rel and cosine."""
    (gm, gs), (wm, ws) = got, want
    loss_rel, bn_rel, update_rel, update_cos = gates
    assert set(gm) == set(wm), what
    for k, v in wm.items():
        np.testing.assert_allclose(gm[k], v, rtol=loss_rel, atol=1e-7, err_msg=f"{what} {k}")
    gap = gaps(gs, ws, start)
    assert gap["bn"] <= bn_rel, (what, gap)
    if gap["moved"] > 0:
        assert gap["norm_rel"] <= update_rel and gap["cos"] >= update_cos, (what, gap)
    assert (gs["count"], gs["mini_step"]) == (ws["count"], ws["mini_step"]), what


def test_dp_step_matches_the_jax_dp_step(group):
    assert_matches_jax(group["outs"][0]["run"][0], group["jax"])


def assert_matches_jax(got: dict, jax_step: tuple):
    """One step's (metrics, state) against JAX's (start params, state,
    metrics), at tests/test_torch_port_step.py's gates."""
    params, jstate, jm = jax_step
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-3, err_msg=k)
    for path, v in _flat(jstate.batch_stats).items():
        name, _ = port_name(path, stats=True)
        np.testing.assert_allclose(got["state"]["model"][name].numpy(), v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=name)
    start, moved, want = _flat(params), [], []
    for path, v in _flat(jstate.params).items():
        name, transpose = port_name(path)
        p = got["state"]["model"][name].numpy()
        moved.append(((p.T if transpose else p) - start[path]).ravel())
        want.append((v - start[path]).ravel())
    g, w = np.concatenate(moved).astype(np.float64), np.concatenate(want).astype(np.float64)
    assert np.linalg.norm(w) > 0
    assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)
    assert g @ w >= 0.999 * np.linalg.norm(g) * np.linalg.norm(w)


@pytest.mark.parametrize("name", ["run", "sym_one_rank", "no_valid_row", "drawn"])
def test_dp_step_matches_one_process(group, name):
    """One step on dp = 2 against one process on the same 8 rows: the
    losses (the bs / valid rescale counts the valid rows of every rank,
    also where one rank has none), BatchNorm statistics and update; every
    rank with rank 0's bits."""
    start, outs = group["start"], group["outs"]
    _, steps, _ = cases()[name]
    valid = steps[0][0]["sym_info"][:, 0] == 0  # the rows the red-axis terms count
    if name == "sym_one_rank":
        assert valid[B // DP:].all() and not valid[:B // DP].all()
    if name == "no_valid_row":
        assert not valid[:B // DP].any()
    want, got = group["one"][name][0], outs[0][name][0]
    assert_same_on_every_rank(outs, name)
    assert_close_to_one_process((got["metrics"], got["state"]), (want["metrics"], want["state"]),
                                start, name)


def test_nan_in_one_rank_s_rows_skips_on_every_rank(group):
    """The run's third batch holds NaN in rank 1's rows: the global loss is
    NaN on both ranks, both skip, and the state keeps step 2's bits."""
    for out in group["outs"]:
        _, second, skipped = out["run"]
        assert skipped["metrics"]["skipped_nan"] == 1.0
        assert not np.isfinite(skipped["metrics"]["total_loss"])
        assert same_state(skipped["state"], second["state"])


def test_accumulate_two_matches_one_process(group):
    """train.accumulate=2 under dp = 2: the first micro-batch moves the
    BatchNorm statistics and the accumulator only (the parameters keep
    their bits), the second steps the optimizer on the running mean of the
    two global gradients."""
    start, outs = group["start"], group["outs"]
    want = [(o["metrics"], o["state"]) for o in group["one"]["accumulate"]]
    assert_same_on_every_rank(outs, "accumulate")
    first, second = outs[0]["accumulate"]
    assert first["state"]["mini_step"] == 1 and first["state"]["count"] == 0
    for k, v in start.items():
        if "running" not in k and "num_batches" not in k:
            assert torch.equal(first["state"]["model"][k], v), k
    g = torch.cat([a.double().ravel() for a in first["state"]["acc"]])
    w = torch.cat([a.double().ravel() for a in want[0][1]["acc"]])
    assert (g - w).norm() <= UPDATE_REL * w.norm() and g @ w >= UPDATE_COS * g.norm() * w.norm()
    for i, (o, w_) in enumerate(zip((first, second), want)):
        assert_close_to_one_process((o["metrics"], o["state"]), w_, start, f"micro-batch {i}")
    assert second["state"]["count"] == 1 and second["state"]["mini_step"] == 0


def test_dp_checkpoint_resumes_under_dp_and_in_one_process(group):
    """Step 1 on dp = 2, its checkpoint, step 2: resumed under dp = 2 the
    second step has the unbroken run's bits on every rank; resumed in one
    process it lies within the one-process gates of the unbroken run."""
    start, outs = group["start"], group["outs"]
    assert_same_on_every_rank(outs, "run")
    unbroken = outs[0]["run"][1]
    for out in outs:
        resumed = out["resume"][0]
        assert same_metrics(resumed["metrics"], unbroken["metrics"])
        assert same_state(resumed["state"], unbroken["state"])
    _, steps, _ = cases()["resume"]
    one = one_process(start, CFG, steps, resume=group["ckpt"])
    shutil.rmtree(group["ckpt"])  # the state of a full-width model and its optimizer
    assert_close_to_one_process((unbroken["metrics"], unbroken["state"]), one[0], start,
                                "resumed in one process")


@pytest.mark.parametrize("sample_mode", ["host", "device"])
def test_each_rank_s_rows_and_draws_are_the_one_process_slices(nocs_root, sample_mode):  # noqa: F811
    """Every rank makes the whole batch of (seed, step) on its own loader and
    keeps its rows, and draws the whole batch's randomness and keeps its
    rows: concatenated in rank order they are the one-process batch and
    draws bit for bit, the pool samples the same on every rank."""
    data = DataConfig(dataset_dir=nocs_root, num_points=N, num_workers=0)
    bs, seed = 4, 11

    def batch():
        ds = pds.PoseTrainDataset(data, mode="train", sample_mode=sample_mode)
        return next(iter(pds.train_batches(ds, bs, 1, seed=seed)))

    def draw():
        one = batch()
        pixels = one["roi_depth"][0].size if sample_mode == "device" else 0
        return draw_train(torch.Generator().manual_seed(seed), bs, N, pixels)

    whole, whole_draws = batch(), draw()
    ranks = []
    for r in range(DP):
        mesh = Mesh(DP, 1, r, 0, None, True)
        rows = batch_sharding(mesh, bs)
        ranks.append(({k: v[rows] for k, v in batch().items()}, draw().rows(rows)))
    for k, v in whole.items():
        np.testing.assert_array_equal(np.concatenate([b[k] for b, _ in ranks]), v, err_msg=k)
    parts = [d for _, d in ranks]
    for d in parts:
        assert all(torch.equal(a, b) for a, b in zip(d.pool_samples, whole_draws.pool_samples))
    aug = [d.aug for d in parts]
    joined = TrainDraws(
        AugmentDraws(torch.cat([a.flags for a in aug], 1),
                     *(torch.cat([getattr(a, f) for a in aug]) for f in ("ey_up", "ey_down",
                                                                          "defor"))),
        whole_draws.pool_samples, [torch.cat(k) for k in zip(*(d.dropout_keep for d in parts))],
        None if sample_mode == "host" else torch.cat([d.sample_scores for d in parts]))
    for got, want in zip(jax.tree_util.tree_leaves(joined),
                         jax.tree_util.tree_leaves(whole_draws)):
        assert torch.equal(got, want)
    assert (whole_draws.sample_scores is None) == (sample_mode == "host")


@pytest.mark.parametrize("world,dp,mp,batch,want,warned", [
    (1, -1, 1, 16, (1, 1), []),
    (4, -1, 1, 16, (4, 1), []),
    (4, -1, 2, 16, (2, 2), []),
    (4, 4, 1, 6, (3, 1), ["data axis shrunk dp=4 -> dp=3 (batch 6 not divisible by 4)",
                          "uses 3 of the 4 processes"]),
    (4, 2, 1, 16, (2, 1), ["uses 2 of the 4 processes"]),
    (4, 4, 2, 16, None, []),
    (2, -1, 4, 16, None, [])])
def test_resolve_mesh_sizes_dp_as_the_jax_loop(monkeypatch, caplog, world, dp, mp, batch,
                                               want, warned):
    """dp = -1 takes every rank off the mp axis, dp shrinks until it divides
    the batch, and a layout larger than the group raises, with the JAX
    loop's warnings (hspose_tpu/engine/train.py:38-80); the train loop and
    the harness both size their layout here."""
    import logging
    import types

    from hspose_tpu_torch.config import ParallelConfig
    from hspose_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "dist", types.SimpleNamespace(
        is_initialized=lambda: True, get_world_size=lambda: world))
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda d, s, m: (d, m))
    logger = logging.getLogger("resolve_mesh_test")
    cfg = ParallelConfig(dp=dp, mp=mp)
    if want is None:
        with pytest.raises(ValueError, match="does not fit"):
            mesh_mod.resolve_mesh(cfg, batch, logger)
        return
    with caplog.at_level(logging.WARNING, logger="resolve_mesh_test"):
        assert mesh_mod.resolve_mesh(cfg, batch, logger) == want
    assert len(caplog.records) == len(warned)
    for rec, text in zip(caplog.records, warned):
        assert text in rec.getMessage()
