"""The port's multi-GPU serving layout (``hspose_tpu_torch/parallel``) and the
data-parallel eval harness (``parallel.dp``) on the CPU.

Process groups are real: ``tests/_torch_dist_worker.py`` starts two ranks
of a ``gloo`` group joined through a file store under ``tmp_path`` (no port
to race for), each with a join timeout, and a group that does not finish in
time is killed and fails the test.  Tolerances, each with its reason:

* the collectives (gather, mean, max over the ranks): gathered and maxed
  values are copies, bit for bit; the mean of two values is one rounded
  addition and division, so the same on every rank and equal to
  ``(a + b) / 2`` in that order;
* the dp = 2 harness against the one-device harness: each crop sees the same
  draws and every layer is row by row, so the poses are the one-device
  harness's bit for bit.  That needs the ranks to run as many threads as
  this process (the worker takes its count): torch's CPU products block by
  thread count, and with one thread against two the poses moved by 8.4e-8.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hspose_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from hspose_tpu.parallel.sp import sp_points_per_device as j_sp_points_per_device
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, parse_overrides
from hspose_tpu_torch.evaluation import evaluate as port_eval
from hspose_tpu_torch.models.hspose import build_model
from hspose_tpu_torch.parallel import mesh, sp

import _torch_dist_worker as worker

torch.set_num_threads(2)  # the suite runs several workers on one host
REPO = Path(__file__).resolve().parents[1]
N_PTS, EVAL_BATCH = 128, 4


def records(seed: int, sizes=(3, 5, 2)) -> list:
    """In-memory eval records (tests/test_sequence_parallel.py's shape):
    clouds, categories, symmetry and mean shapes, one record per size."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        data = {"pcl_in": rng.normal(scale=0.2, size=(n, N_PTS, 3)).astype(np.float32),
                "cat_id_0base": (np.arange(n) % 6).astype(np.int32),
                "sym_info": np.tile(np.array([[0, 1, 0, 0]], np.float32), (n, 1)),
                "mean_shape": np.abs(rng.normal(size=(n, 3))).astype(np.float32) * 0.1}
        out.append((data, {}, {}))
    return out


def pool_samples(seed: int, n: int = N_PTS) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.permutation(n)[:n // 4]),
            torch.from_numpy(rng.permutation(n // 4)[:n // 16])]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(the one-device model, the outputs of two gloo ranks) for the tasks
    below: the collectives and the dp = 2 harness."""
    torch.manual_seed(3)
    model = build_model(ModelConfig(), device="cpu")
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    job = {"model": {}, "state_dict": model.state_dict(), "tasks": {
        "collectives": {"kind": "collectives", "x": x},
        "dp2": {"kind": "harness", "records": records(1),
                "overrides": [f"eval.eval_batch={EVAL_BATCH}", "parallel.dp=2"],
                "seed": 0, "samples": pool_samples(2)},
        "dp_default": {"kind": "harness", "records": records(1),
                       "overrides": ["eval.eval_batch=3"], "seed": 0,
                       "samples": pool_samples(2)}}}
    return model, worker.launch(tmp_path_factory.mktemp("dp"), 2, job)


def test_collectives_over_two_ranks(group):
    _, outs = group
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    for out in outs:
        got = out["collectives"]
        for dtype in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(got[dtype]["gather"],
                                       torch.cat([x.to(dtype), (x + 1).to(dtype)], dim=1),
                                       rtol=0, atol=0)
            torch.testing.assert_close(got[dtype]["max"], (x + 1).to(dtype), rtol=0, atol=0)
            torch.testing.assert_close(got[dtype]["mean"],
                                       (x.to(dtype) + (x + 1).to(dtype)) / 2, rtol=0, atol=0)


def test_dp_harness_gives_the_one_device_poses(group):
    """parallel.dp=2: each rank serves 2 of the 4 rows of every padded batch
    (10 crops: 3 batches, the last padded), and every rank returns every
    result, equal to the one-device harness's."""
    model, outs = group
    cfg = parse_overrides([f"eval.eval_batch={EVAL_BATCH}", "parallel.dp=1"])
    want, _ = port_eval.batched_pose_inference(cfg, model, records(1), 0,
                                               pool_samples=pool_samples(2))
    for out in outs:
        got = out["dp2"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for key in ("pred_RTs", "pred_scales"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dp_default_takes_every_rank_and_shrinks_to_the_batch(group):
    """parallel.dp=-1 over two ranks with eval_batch=3: dp 2 shrinks to 1
    (the JAX harness's rule), and the poses are the one-device harness's."""
    model, outs = group
    cfg = parse_overrides(["eval.eval_batch=3", "parallel.dp=1"])
    want, _ = port_eval.batched_pose_inference(cfg, model, records(1), 0,
                                               pool_samples=pool_samples(2))
    for out in outs:
        for a, b in zip(out["dp_default"], want):
            np.testing.assert_array_equal(a["pred_RTs"], b["pred_RTs"])  # dp 1: the same rows


def test_one_process_is_one_rank():
    m = mesh.make_mesh(1, 1)
    assert m == mesh.Mesh(1, 1, 0, 0, None, True)
    with pytest.raises(ValueError, match="dp\\*sp=2\\*1 > 1 processes"):
        mesh.make_mesh(2, 1)
    assert sp.all_gather_points(torch.ones(2, 3), None) is not None
    x = torch.randn(2, 3)
    assert sp.mean_over_shards(x, None) is x and sp.max_over_shards(x, None) is x


def test_batch_rows_of_a_dp_rank():
    layout = mesh.Mesh(dp=4, sp=2, dp_index=2, sp_index=1, sp_group=None, active=True)
    assert mesh.batch_sharding(layout, 24) == slice(12, 18)
    batch = {"a": torch.arange(24), "b": torch.arange(48).reshape(24, 2)}
    got = mesh.shard_batch(layout, batch)
    assert torch.equal(got["a"], torch.arange(12, 18))
    assert torch.equal(got["b"], batch["b"][12:18])


@pytest.mark.parametrize("n", [10, 16, 1])
def test_pad_to_multiple_matches_jax(n):
    batch = {"x": np.arange(n, dtype=np.float32), "y": np.arange(2 * n).reshape(n, 2)}
    got, want = mesh.pad_to_multiple(batch, 8), j_pad_to_multiple(batch, 8)
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n,s", [(4096, 2), (4096, 8), (1028, 4), (2056, 2)])
def test_sp_points_per_device_matches_jax(n, s):
    try:
        want = j_sp_points_per_device(n, s)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("*", "\\*").replace("(", "\\(")
                           .replace(")", "\\)")):
            sp.sp_points_per_device(n, s)
        return
    assert sp.sp_points_per_device(n, s) == want


def test_cli_without_torchrun_names_the_command(monkeypatch, tmp_path):
    """parallel.sp > 1 with no process group raises before anything is
    loaded, naming the torchrun command; it never serves on one device."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("HSPOSE_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node"):
        port_eval.main(["parallel.sp=2", "data.num_points=4096",
                        f"train.model_save={tmp_path}"])
    assert not list(tmp_path.iterdir())


def test_init_distributed_needs_a_card_per_local_rank(monkeypatch):
    """No device named: cuda:LOCAL_RANK, which must exist; no CPU instead."""
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=0 has no CUDA device"):
        mesh.init_distributed()


def test_config_keeps_the_jax_axes():
    p = HSPoseConfig().parallel
    assert (p.dp, p.mp, p.sp) == (-1, 1, 1)


def test_parallel_modules_import_neither_jax_nor_hspose_tpu():
    code = ("import importlib, sys\n"
            "for m in ('parallel', 'parallel.mesh', 'parallel.sp', 'evaluation.evaluate'):\n"
            "    importlib.import_module('hspose_tpu_torch.' + m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hspose_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
