"""The port's bf16 train forward and backward under ``bwd_store=False``
alone, ``train_v4_small=True`` alone and both, against the JAX package's
bf16 step on the kernel route (its Pallas kernels in interpret mode,
tests/test_torch_port_train_v4.py::kernel_route), on the CPU.  The bf16
step is chaotic, so it is held to ``SPREAD_MULT`` = 3 times the JAX
package's own spread under a 1e-6 relative move of the input cloud, and to
as far from the port's fp32 step with the same flags as the JAX bf16 step
lies: the gates and the reasons of tests/test_torch_port_train_bf16.py.
"""

import pytest
import torch

from test_torch_port_train_bf16 import check_bf16_step_within_jax_spread
from test_torch_port_train_v4 import kernel_route  # noqa: F401

torch.set_num_threads(2)  # the suite runs several workers on one host


@pytest.mark.parametrize("flags", [{"bwd_store": False}, {"train_v4_small": True},
                                   {"bwd_store": False, "train_v4_small": True}],
                         ids=["recompute", "v4", "both"])
def test_bf16_train_step_with_flags_lies_within_the_jax_spread(kernel_route, monkeypatch, flags):
    check_bf16_step_within_jax_spread(monkeypatch, **flags)
