"""The port's model parallelism (``parallel.mp``, ``hspose_tpu_torch/
parallel/mp.py``) on the CPU: the train step at mp = 2 and at dp = 2 x
mp = 2 against the JAX package's step on its 2-D (dp, mp) mesh, the train
step at mp = 2 against the port's one-process step, the eval harness at
mp = 2 against the one-process harness, and an mp = 2 checkpoint in one
process.

Process groups are real: ``tests/_torch_dist_worker.py`` starts four ranks
of a ``gloo`` group, each with the pytest process's thread count; an mp = 2
layout takes ranks 0 and 1 and leaves the others idle, as the JAX loop
leaves devices outside its mesh.  The batches, draws and initial tree are
tests/test_torch_dp_train.py's (a global batch of 8 at N = 128).

Gates, each with its reason:

* against JAX's step on the (dp = 2, mp = 2) mesh (tests/test_parallel.py:
  191-231, which holds it to the one-device step): the gates of
  tests/test_torch_port_step.py, as in tests/test_torch_dp_train.py;
* mp = 2 against the one-process step: an mp rank forms its own output
  columns of each wide Dense product and the input's cotangent is the sum
  of the two ranks' shares, so they differ by summation order only:
  measured loss terms within 2.3e-6 relative, BatchNorm statistics within
  4.5e-7 of their largest and the update within norm_rel 5.6e-5 (cosine
  0.9999999984); the gates ``MP_GATES`` are about ten times those;
* the ranks of a layout hold the same full state bit for bit (the sharded
  tensors gathered);
* the harness at mp = 2 (dp = 1, and dp = 2 x mp = 2) against the
  one-process harness: measured at most 3.0e-7 on ``pred_RTs`` and 1.5e-8
  on ``pred_scales``, so the gates are 1e-6 and 1e-7, tighter than the JAX
  test's 1e-5 and 1e-6 (tests/test_parallel.py:271-272);
* the train loop (``engine/train.py::train``) for two steps on dp = 2 x
  mp = 2 against the one-process loop on the same tree: the step losses
  and the final BatchNorm statistics at the one-process gates (measured
  4.7e-7 to 1.2e-6 on the statistics; the tree's scenes vary with the
  process's hash seed), rank 0 alone writing the log, the metrics and the
  checkpoint.  The warm-up update (about 1e-6 in norm) lies below the
  parameters' fp32 resolution, so the step tests gate the update;
* an mp = 2 checkpoint holds full tensors: restored in one process it
  gives the mp = 2 run's state bit for bit, and the eval CLI's loader
  (``load_params``) reads it.
"""

import json
import shutil

import flax
import jax
import numpy as np
import pytest
import torch

from hspose_tpu.config import ParallelConfig as JParallelConfig
from hspose_tpu.engine.train_step import make_train_step
from hspose_tpu.parallel.mesh import make_mesh as j_make_mesh
from hspose_tpu.parallel.mesh import shard_batch as j_shard_batch
from hspose_tpu.parallel.mesh import shard_state, state_sharding
from hspose_tpu_torch.config import ModelConfig, parse_overrides
from hspose_tpu_torch.engine.checkpoint import restore_checkpoint
from hspose_tpu_torch.engine.train_step import build_train_step
from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
from hspose_tpu_torch.models.hspose import build_model
from hspose_tpu_torch.parallel import mp
from hspose_tpu_torch.utils.convert import flax_variables, port_name
from hspose_tpu_torch.utils.params_io import load_params
from test_data_pipeline import nocs_root  # noqa: F401  (fixture)
from test_torch_dp_train import (
    BN_REL,
    CFG,
    LOSS_REL,
    B,
    assert_close_to_one_process,
    assert_matches_jax,
    configs,
    draws,
    gaps,
    global_batch,
    jax_start,
    same_state,
)
from test_torch_parallel import EVAL_BATCH, pool_samples, records
from test_torch_port_train import Pinned

import _torch_dist_worker as worker

torch.set_num_threads(2)  # the suite runs several workers on one host
WORLD = 4
MP_GATES = (2e-5, 5e-6, 5e-4, 0.9999999)  # loss, BatchNorm, update norm_rel and cosine
RT_ATOL, S_ATOL = 1e-6, 1e-7


def serving_state():
    torch.manual_seed(3)
    return build_model(ModelConfig(), device="cpu").state_dict()


def loop_overrides(root, out, *extra) -> list:
    return [f"data.dataset_dir={root}", "data.num_points=128", "data.num_workers=0",
            "train.batch_size=4", "train.train_steps=2", "train.total_epoch=1",
            "train.log_every=1", "train.seed=5", f"train.model_save={out}", *extra]


@pytest.fixture(scope="module")
def group(tmp_path_factory, nocs_root):  # noqa: F811
    """The initial tree, the JAX package's step on the (2, 2) mesh on
    ``global_batch(4)`` with ``Pinned(6, True, 8)``'s draws, the four gloo
    ranks' runs (started first, and run meanwhile) and the one-process
    step's (in a process of its own)."""
    d = tmp_path_factory.mktemp("mp")
    jcfg, _ = configs()
    one = (global_batch(4), draws(6))
    with pytest.MonkeyPatch.context() as patch:
        Pinned(6, True, B).patch_jax(patch)
        jmodel, tx, host, start = jax_start(jcfg)
        train = {"kind": "train", "cfg": CFG, "state_dict": start, "batches": [one]}
        harness = {"kind": "harness", "records": records(1), "seed": 0,
                   "samples": pool_samples(2)}
        tasks = {
            "mp2": dict(train, dp=1, mp=2, save=str(d / "ckpt"), save_after=0),
            "dp2mp2": dict(train, dp=2, mp=2),
            "harness_mp2": dict(harness, overrides=[f"eval.eval_batch={EVAL_BATCH}",
                                                    "parallel.dp=1", "parallel.mp=2"]),
            "harness_dp2mp2": dict(harness, overrides=[f"eval.eval_batch={EVAL_BATCH}",
                                                       "parallel.mp=2"]),
            "loop": {"kind": "loop", "overrides": loop_overrides(
                nocs_root, d / "loop", "parallel.dp=2", "parallel.mp=2")},
        }
        ranks = worker.start(d, WORLD, {"model": {}, "state_dict": serving_state(),
                                        "tasks": tasks})
        one_dir = tmp_path_factory.mktemp("one_process")
        reference = worker.start(one_dir, 1, {"tasks": {
            "one": dict(train, dp=1, mp=1),
            "loop": {"kind": "loop", "overrides": loop_overrides(nocs_root, one_dir / "loop")}}})
        mesh = j_make_mesh(JParallelConfig(dp=2, mp=2))
        specs = jax.tree_util.tree_leaves(state_sharding(mesh, host.params),
                                          is_leaf=lambda x: hasattr(x, "spec"))
        assert any(s.spec == jax.sharding.PartitionSpec(None, "mp") for s in specs)
        state, metrics = make_train_step(jcfg, jmodel, tx)(
            shard_state(mesh, host), j_shard_batch(mesh, one[0]), jax.random.key(1))
    one = reference()[0]
    yield {"start": start, "ckpt": d / "ckpt" / "model_000", "outs": ranks(),
           "one": one["one"][0], "loop": (d / "loop", one["loop"]), "loop_one": one_dir / "loop",
           "jax": (host.params, jax.device_get(state), jax.device_get(metrics))}
    for big in (d / "ckpt", d / "loop", one_dir / "loop"):  # full-width model states
        shutil.rmtree(big, ignore_errors=True)


@pytest.mark.parametrize("name", ["mp2", "dp2mp2"])
def test_mp_step_matches_the_jax_2d_mesh_step(group, name):
    outs = group["outs"]
    active = [o[name] for o in outs if o[name] is not None]
    assert len(active) == (2 if name == "mp2" else 4)
    for r, out in enumerate(active[1:], 1):
        assert same_state(out[0]["state"], active[0][0]["state"]), r
    assert_matches_jax(active[0][0], group["jax"])


def test_mp_step_matches_one_process(group):
    got, want = group["outs"][0]["mp2"][0], group["one"]
    assert_close_to_one_process((got["metrics"], got["state"]),
                                (want["metrics"], want["state"]), group["start"], "mp2",
                                MP_GATES)


@pytest.mark.parametrize("mp_size", [2, 4])
def test_mp_shards_what_the_jax_rule_shards(mp_size):
    """The layers whose weights ``distribute`` shards are those whose kernels
    the JAX package's ``state_sharding`` shards on a (1, mp) mesh."""
    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    params, _ = flax_variables(model)
    mesh = j_make_mesh(JParallelConfig(dp=1, mp=mp_size))
    rule = flax.traverse_util.flatten_dict(state_sharding(mesh, params))
    want = {port_name(path)[0] for path, sh in rule.items()
            if sh.spec == jax.sharding.PartitionSpec(None, "mp")}
    got = {f"{n}.weight" for n, m in model.named_modules() if mp.shards(m, mp_size)}
    assert got == want and len(got) > 0


@pytest.mark.parametrize("name", ["harness_mp2", "harness_dp2mp2"])
def test_mp_harness_matches_one_process(group, name):
    model = build_model(ModelConfig(), device="cpu")
    model.load_state_dict(serving_state())
    cfg = parse_overrides([f"eval.eval_batch={EVAL_BATCH}", "parallel.dp=1"])
    want, _ = batched_pose_inference(cfg, model, records(1), 0, pool_samples=pool_samples(2))
    for out in group["outs"]:
        got = out[name]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a["pred_RTs"], b["pred_RTs"], rtol=0, atol=RT_ATOL)
            np.testing.assert_allclose(a["pred_scales"], b["pred_scales"], rtol=0, atol=S_ATOL)


def test_mp_checkpoint_resumes_and_serves_in_one_process(group):
    ckpt, got = group["ckpt"], group["outs"][0]["mp2"][0]["state"]
    model = build_model(CFG.model, device="cpu", train_heads=True)
    step = build_train_step(CFG, model, torch.Generator())
    restore_checkpoint(str(ckpt), model, step)
    assert same_state(worker.state(model, step), got)
    serving = build_model(ModelConfig(), device="cpu")
    load_params(serving, str(ckpt))
    for k, v in serving.state_dict().items():
        assert torch.equal(v, got["model"][k]), k


def test_train_loop_on_dp2_mp2_matches_one_process(group):
    """``engine/train.py::train`` on four ranks (``parallel.dp=2
    parallel.mp=2``; every rank makes the whole batch and keeps its rows)
    for two steps against the one-process loop: the same final state within
    the one-process gates, every rank rank 0's bits, and rank 0 alone wrote
    the log, the metrics (two steps and the epoch record) and the
    checkpoint."""
    (out, want), one_out = group["loop"], group["loop_one"]
    got = [o["loop"] for o in group["outs"]]
    for r, g in enumerate(got[1:], 1):
        assert same_state(g, got[0]), r
    assert got[0]["count"] == want["count"] == 2
    # the BatchNorm statistics; the update itself is gated by the step tests:
    # at the loop's warm-up rate (about 1e-7) it lies below the parameters'
    # fp32 resolution, and rounding alone moves it by up to 2e-2 norm_rel
    gap = gaps(got[0], want, want["model"])
    assert gap["bn"] <= BN_REL, gap
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    one = [json.loads(x) for x in (one_out / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == len(one) == 3 and (out / "model_000" / "state.pt").exists()
    for a, b in zip(lines[:2], one[:2]):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=LOSS_REL)
    assert "mesh: dp=2 x mp=2" in (out / "log.txt").read_text()
