"""The port's fp32 train step under ``bwd_store=False`` alone and
``train_v4_small=True`` alone against the JAX package's on the CPU, the JAX
layers on their kernel route (tests/test_torch_port_train_v4.py::
kernel_route), randomness pinned as in tests/test_torch_port_train.py.
Gates: those of tests/test_torch_port_train_v4.py::
test_v4_recompute_train_step_matches_jax_for_six_steps (each step's loss
within 1e-3 relative; the parameter update within norm_rel 5e-2 and cosine
0.999 of JAX's), over three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hspose_tpu_torch.engine.train_step import to_device
from test_torch_port_step import assert_update_close, both_steps, configs
from test_torch_port_train import Pinned, train_batch
from test_torch_port_train_v4 import kernel_route  # noqa: F401

torch.set_num_threads(2)  # the suite runs several workers on one host


@pytest.mark.parametrize("flags", [{"bwd_store": False}, {"train_v4_small": True}],
                         ids=["recompute", "v4"])
def test_fp32_step_with_one_flag_matches_jax(kernel_route, monkeypatch, flags):
    """Three fp32 steps with one flag alone against ``make_train_step`` with
    the same flag on the kernel route: ``bwd_store=False`` takes K11 without
    winner values and K14 at conv_1 .. conv_4; ``train_v4_small=True`` the
    fused ops at conv_1 .. conv_4 (at N = 128 every HS layer but conv_0 is
    at N <= 512) with K11/K13 nowhere."""
    jcfg, cfg = configs(**flags)
    state, jstep, model, step, start = both_steps(jcfg, cfg, monkeypatch)
    batch = train_batch(seed=4)
    jbatch, tbatch = {k: jnp.asarray(v) for k, v in batch.items()}, to_device(batch, "cpu")
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.key(1))
        m = step(tbatch, Pinned(6, True).port())
        assert m["skipped_nan"] == 0.0
        np.testing.assert_allclose(m["total_loss"], float(jm["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {i}")
    assert step.optimizer.count == 3
    assert_update_close(model, state.params, start)
