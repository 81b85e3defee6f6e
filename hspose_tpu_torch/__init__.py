"""hspose_tpu_torch — the PyTorch / CUDA (Hopper, sm_90a) port of hspose_tpu.

The JAX package ``hspose_tpu`` is the reference this package is held against;
nothing here imports it (its ``__init__`` imports JAX and flips JAX's global
matmul precision, and the port must run where JAX is not installed).  Module names mirror
``hspose_tpu`` so each counterpart is easy to find.

Slice ported so far: the fp32 serving forward — ``PoseNet9D`` in eval mode and
``generate_RT`` — with its four hand-written CUDA kernels (KNN, HS surface,
HS support, ORL global) built at first use by ``ops/_build.py``.
"""

from hspose_tpu_torch.config import ModelConfig

__version__ = "0.1.0"
__all__ = ["ModelConfig", "__version__"]
