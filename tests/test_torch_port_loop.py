"""The port's train loop (``hspose_tpu_torch/engine/train.py``), its
checkpoints (``engine/checkpoint.py``) and the eval CLI on them, on the CPU
at a small batch and cloud: a checkpoint round trip bit for bit, an
interrupted run resumed from its checkpoint against an unbroken one bit for
bit, the train CLI -> checkpoint -> eval CLI chain, the refusals, and
``train.debug_nan`` on a poisoned batch (device sampling's loop:
tests/test_torch_port_device_sampling.py; the loop under dp and mp:
tests/test_torch_dp_train.py and tests/test_torch_mp.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, parse_overrides
from hspose_tpu_torch.data import dataset as pds
from hspose_tpu_torch.engine import train as port_train
from hspose_tpu_torch.engine.checkpoint import (
    latest_checkpoint,
    read_meta,
    restore_checkpoint,
    save_checkpoint,
)
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models.hspose import build_model
from hspose_tpu_torch.utils.params_io import load_params
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch
from test_data_pipeline import nocs_root  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 128  # points per cloud, the smallest the pools and searches take
torch.set_num_threads(2)  # the suite runs several workers on one host


def loop_args(root, out, *extra):
    return [f"data.dataset_dir={root}", f"data.num_points={N}", "data.num_workers=0",
            "train.batch_size=2", "train.train_steps=2", "train.total_epoch=2",
            "train.save_every=1", "train.log_every=1", "train.seed=5",
            f"train.model_save={out}", *extra]


def train_state(model, step):
    """Every tensor and count a checkpoint holds, by name."""
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    for i, p in enumerate(step.optimizer._params()):
        for k, v in step.optimizer.state[p].items():
            out[f"opt.{i}.{k}"] = v
    out.update({f"acc.{i}": a for i, a in enumerate(step.accumulator)})
    out["count"] = torch.tensor(step.optimizer.count)
    out["mini_step"] = torch.tensor(step.mini_step)
    return out


def assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    """Weights, BatchNorm statistics, Ranger's moments and slow weights, its
    count, and train.accumulate's micro-step and gradient mean come back
    with their bits into a freshly built model and step."""
    cfg = parse_overrides(["train.accumulate=2", "train.train_steps=10", "train.total_epoch=3"])
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu", train_heads=True)
    step = build_train_step(cfg, model, torch.Generator().manual_seed(1))
    batch = to_device(synthetic_train_batch(2, N, seed=2), "cpu")
    for _ in range(3):
        step(batch)
    assert step.optimizer.count == 1 and step.mini_step == 1
    path = save_checkpoint(str(tmp_path), model, step, epoch=4, seed=123, decode="numpy")
    assert path == str(tmp_path / "model_004") and latest_checkpoint(str(tmp_path)) == path
    assert read_meta(path) == {"epoch": 4, "seed": 123, "decode": "numpy"}

    torch.manual_seed(9)
    fresh = build_model(cfg.model, device="cpu", train_heads=True)
    fresh_step = build_train_step(cfg, fresh, torch.Generator())
    assert restore_checkpoint(path, fresh, fresh_step) == (4, 123)
    assert_states_equal(train_state(fresh, fresh_step), train_state(model, step))
    assert fresh_step.optimizer.lr() == step.optimizer.lr()

    serving = build_model(ModelConfig(), device="cpu")  # no train heads
    load_params(serving, path)
    saved = model.state_dict()
    for k, v in serving.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_resumed_run_equals_unbroken_run(nocs_root, tmp_path):  # noqa: F811
    """Two epochs straight against epoch 0's checkpoint resumed for epoch
    1: the same parameters, BatchNorm buffers and Ranger state, bit for bit,
    and the same checkpoint of epoch 1."""
    unbroken = parse_overrides(loop_args(nocs_root, tmp_path / "a"))
    model, step = port_train.train(unbroken, device="cpu")
    assert step.optimizer.count == 4
    resumed = parse_overrides(loop_args(nocs_root, tmp_path / "b", "train.resume=true",
                                        "train.seed=77",
                                        f"train.resume_model={tmp_path / 'a' / 'model_000'}"))
    model_b, step_b = port_train.train(resumed, device="cpu")
    assert_states_equal(train_state(model_b, step_b), train_state(model, step))
    assert "model_000" not in os.listdir(tmp_path / "b")
    a = torch.load(tmp_path / "a" / "model_001" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "model_001" / "state.pt", weights_only=True)
    assert a["seed"] == b["seed"] == 5 and a["epoch"] == b["epoch"] == 1
    decode = pds.decode_path(unbroken.data)
    assert read_meta(tmp_path / "a" / "model_001")["decode"] == decode
    assert read_meta(tmp_path / "b" / "model_001")["decode"] == decode
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


def test_train_cli_checkpoint_eval_cli(nocs_root, tmp_path):  # noqa: F811
    """``HSPOSE_PLATFORM=cpu python -m hspose_tpu_torch.engine.train`` with
    the spawned worker pool, then the eval CLI on its last checkpoint."""
    env = dict(os.environ, HSPOSE_PLATFORM="cpu")
    out = tmp_path / "run"
    args = loop_args(nocs_root, out, "train.total_epoch=1")
    args[2] = "data.num_workers=1"
    proc = subprocess.run([sys.executable, "-m", "hspose_tpu_torch.engine.train", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loader workers: 1" in proc.stdout and "decode: " in proc.stdout
    ckpt = latest_checkpoint(str(out))
    assert ckpt == str(out / "model_000")
    det = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    proc = subprocess.run([sys.executable, "-m", "hspose_tpu_torch.evaluation.evaluate",
                           f"data.dataset_dir={nocs_root}", f"data.detection_dir={det}",
                           f"data.num_points={N}", "data.num_workers=0", "eval.eval_batch=4",
                           "eval.eval_seed=3", f"train.resume_model={ckpt}",
                           f"train.model_save={tmp_path / 'eval'}"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "3D IoU at 25:" in proc.stdout
    assert (tmp_path / "eval" / "eval_result_model_000" / "pred_result.pkl").exists()


@pytest.mark.parametrize("overrides,error,match", [
    (["parallel.dp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.mp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.dp=2", "parallel.mp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.sp=2"], ValueError, "eval-only; training uses a \\(dp, mp\\) mesh")])
def test_train_refuses_what_it_does_not_run(overrides, error, match, tmp_path):
    """Refused at once, nothing built or written: sp, as the JAX loop
    refuses it, and dp or mp above 1 without a process group, naming the
    torchrun command instead of training on one device."""
    cfg = parse_overrides([*overrides, f"train.model_save={tmp_path / 'out'}"])
    with pytest.raises(error, match=match):
        port_train.train(cfg, device="cpu")
    assert not (tmp_path / "out").exists()


def test_debug_nan_stops_on_a_poisoned_batch(nocs_root, tmp_path, monkeypatch):  # noqa: F811
    """With train.debug_nan a batch with a NaN in its cloud raises
    FloatingPointError; anomaly detection is on during the run only."""
    make = pds._make_batch_from
    seen = []

    def poisoned(dataset, seed, step, batch_size):
        batch = make(dataset, seed, step, batch_size)
        seen.append(torch.is_anomaly_enabled())
        if step == 1:
            batch["pcl_in"][0, 0, 0] = np.nan
        return batch

    monkeypatch.setattr(pds, "_make_batch_from", poisoned)
    cfg = parse_overrides(loop_args(nocs_root, tmp_path, "train.debug_nan=true"))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        port_train.train(cfg, device="cpu")
    assert seen == [True, True] and not torch.is_anomaly_enabled()
    assert not os.path.exists(tmp_path / "model_000")


def test_load_params_names_what_it_does_not_read(tmp_path):
    orbax = tmp_path / "model_000"
    (orbax / "state").mkdir(parents=True)
    (orbax / "meta.json").write_text('{"epoch": 0, "seed": 1}')
    model = build_model(HSPoseConfig().model, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        load_params(model, str(orbax))


def test_step_seeds_differ_by_step_and_seed():
    seeds = {port_train.step_seed(s, i) for s in (0, 1) for i in range(50)}
    assert len(seeds) == 100 and all(0 <= s < 2 ** 63 for s in seeds)
