"""The port's train step against the JAX package's on the CPU: gradient
accumulation (``train.accumulate``, optax.MultiSteps in the JAX package),
the ``train.debug_nan`` metrics and their check, the k cap where the model
is built (tests/test_torch_port_step_flags.py holds the fp32 step under
each training flag alone).

Randomness is pinned on both sides as in tests/test_torch_port_train.py.
Gates, each with its reason:

* accumulation: the parameters bit-identical to the start on the micro-
  batches that do not step (both sides add nothing), the BatchNorm
  statistics within 1e-3 of each buffer's largest value after every
  micro-batch (the train forward's KNN and max selections flip under fp32
  summation order, tests/test_torch_port_train.py; measured 2.4e-5
  absolute, 1.4e-4 of the largest, before the first optimizer step, and
  after it the parameters differ by the update's gap below), the
  micro-step and optimizer counts
  equal, every loss within 1e-3 relative; after the two optimizer steps the
  parameter update within norm_rel 5e-2 and cosine 0.999 of JAX's, the
  gates of test_train_step_matches_jax_for_six_steps_and_skips_nan; a NaN
  micro-batch leaves the parameters, statistics, accumulator, counts and
  optimizer state bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hspose_tpu.config import default_config
from hspose_tpu.engine.train_step import build_train_step as j_build_train_step
from hspose_tpu.engine.train_step import check_finite_metrics as j_check_finite_metrics
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, OptimConfig, TrainConfig
from hspose_tpu_torch.engine.train_step import build_train_step, check_finite_metrics, to_device
from hspose_tpu_torch.models.hspose import build_model
from hspose_tpu_torch.ops.cuda_knn import MAX_K
from hspose_tpu_torch.utils.convert import load_jax_params, port_name
from test_torch_port_train import N, Pinned, _flat, train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host


def configs(accumulate=1, debug_nan=False, **flags):
    """(JAX config, port config) with lr=1e-3, no warm-up, N points."""
    jcfg = default_config()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, bwd_exact=True, **flags),
        optim=dataclasses.replace(jcfg.optim, lr=1e-3, warmup_iters=0),
        train=dataclasses.replace(jcfg.train, accumulate=accumulate, debug_nan=debug_nan),
        data=dataclasses.replace(jcfg.data, num_points=N))
    cfg = HSPoseConfig(model=ModelConfig(**flags),
                       optim=dataclasses.replace(OptimConfig(), lr=1e-3, warmup_iters=0),
                       train=TrainConfig(accumulate=accumulate, debug_nan=debug_nan))
    return jcfg, cfg


def both_steps(jcfg, cfg, monkeypatch):
    """(jax state, jax step, port model, port step, start params) from the
    same initial tree, draws pinned."""
    Pinned(6, True).patch_jax(monkeypatch)
    _, state, jstep = j_build_train_step(jcfg, j_build_model(jcfg), jax.random.key(0))
    model = build_model(cfg.model, device="cpu", train_heads=True)
    load_jax_params(model, jax.device_get(state.params), jax.device_get(state.batch_stats))
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))
    return state, jstep, model, step, _flat(state.params)


def assert_update_close(model, jparams, start):
    """The parameter update, all leaves as one vector: norm_rel <= 5e-2 and
    cosine >= 0.999 against JAX's."""
    params = dict(model.named_parameters())
    got, want = [], []
    for path, v in _flat(jparams).items():
        name, transpose = port_name(path)
        p = params[name].detach().numpy()
        got.append(((p.T if transpose else p) - start[path]).ravel())
        want.append((v - start[path]).ravel())
    got, want = np.concatenate(got).astype(np.float64), np.concatenate(want).astype(np.float64)
    assert np.linalg.norm(want) > 0
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)
    assert got @ want >= 0.999 * np.linalg.norm(got) * np.linalg.norm(want)


def assert_stats_close(model, jstats):
    """BatchNorm statistics within 1e-3 of each buffer's largest value."""
    buffers = dict(model.named_buffers())
    for path, v in _flat(jstats).items():
        name, _ = port_name(path, stats=True)
        np.testing.assert_allclose(buffers[name].numpy(), v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=name)


def test_accumulate_matches_multisteps_and_skips_a_nan_micro_batch(monkeypatch):
    """``train.accumulate=2`` over four micro-batches (two optimizer steps)
    with a NaN micro-batch after the second, against ``make_train_step``
    around ``optax.MultiSteps``, ``debug_nan`` on in both."""
    jcfg, cfg = configs(accumulate=2, debug_nan=True)
    state, jstep, model, step, start = both_steps(jcfg, cfg, monkeypatch)
    # seeds whose single step lies within 3e-3 of JAX's: at seeds 5, 7 and 9
    # the port's fp32 summation order flips a KNN or max selection and moves
    # even one unaccumulated step's update by up to 0.14 (module docstring of
    # tests/test_torch_port_train.py)
    batches = [train_batch(seed=s) for s in (4, 6, 8, 10)]
    jprev = start
    nan = dict(batches[0], pcl_in=np.full_like(batches[0]["pcl_in"], np.nan))
    for i, batch in enumerate(batches[:2] + [nan] + batches[2:]):
        port_before = {k: v.clone() for k, v in model.state_dict().items()}
        acc_before = [st.clone() for st in step.accumulator]
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(1))
        m = step(to_device(batch, "cpu"), Pinned(6, True).port())
        assert set(m) == set(jm), i
        for k in m:
            if k.startswith("finite/") or k == "skipped_nan":
                assert m[k] == float(jm[k]), (i, k)
        opt = state.opt_state
        assert step.mini_step == int(opt.mini_step), i
        assert step.optimizer.count == int(opt.gradient_step), i
        if batch is nan:
            assert m["skipped_nan"] == 1.0
            with pytest.raises(FloatingPointError, match="non-finite loss"):
                check_finite_metrics(m)
            for k, v in model.state_dict().items():
                assert torch.equal(v, port_before[k]), k
            assert all(torch.equal(a, b) for a, b in zip(step.accumulator, acc_before))
            continue
        check_finite_metrics(m)
        np.testing.assert_allclose(m["total_loss"], float(jm["total_loss"]), rtol=1e-3,
                                   err_msg=f"micro-batch {i}")
        assert_stats_close(model, state.batch_stats)
        if step.mini_step == 1:  # no optimizer step: no parameter moved on either side
            for name, p in model.named_parameters():
                assert torch.equal(p.detach(), port_before[name]), name
            assert all(np.array_equal(v, jprev[path]) for path, v in _flat(state.params).items())
        jprev = _flat(state.params)
    assert step.optimizer.count == 2 and step.mini_step == 0
    assert all(float(a.abs().max()) == 0.0 for a in step.accumulator)
    assert_update_close(model, state.params, start)


def test_check_finite_metrics_matches_jax():
    """The finite flags' check raises as the JAX package's does, naming the
    families whose flag is not 1.0, and passes the others."""
    good = {"total_loss": 1.0, "finite/fsnet_loss": 1.0, "finite/recon_loss": 1.0}
    check_finite_metrics(good)
    j_check_finite_metrics(good)
    bad = dict(good, **{"finite/recon_loss": 0.0, "finite/prop_loss": 0.0})
    for fn in (check_finite_metrics, j_check_finite_metrics):
        with pytest.raises(FloatingPointError, match="prop_loss, recon_loss"):
            fn(bad)


@pytest.mark.parametrize("field", ["gcn_n_num", "serve_k"])
def test_build_model_refuses_k_above_the_kernel_cap(field):
    with pytest.raises(ValueError, match=f"{field}=32.*MAX_K = 31"):
        build_model(ModelConfig(**{field: MAX_K + 1}), device="cpu")
    build_model(ModelConfig(**{field: MAX_K}), device="cpu")
