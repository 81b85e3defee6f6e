"""hspose_tpu_torch — the PyTorch / CUDA (Hopper, sm_90a) port of hspose_tpu.

The JAX package ``hspose_tpu`` is the reference this package is held against;
nothing here imports it (its ``__init__`` imports JAX and flips JAX's global
matmul precision, and the port must run where JAX is not installed).  Module names mirror
``hspose_tpu`` so each counterpart is easy to find.

Slices ported so far, each with hand-written CUDA kernels built at first use
by ``ops/_build.py``:

* the fp32 serving forward, ``PoseNet9D`` in eval mode and ``generate_RT``
  (KNN, HS surface, HS support and ORL global kernels);
* the fp32 train step, ``engine/train_step.py::build_train_step``: the
  augmentation, the train forward with its heads, four loss families and
  Ranger, with the HS training kernels forward and backward
  (``ops/cuda_hs.py``) and the KNN kernel;
* both in the bf16 tier too, and the ``bwd_store=False`` /
  ``train_v4_small=True`` training routes (``ops/cuda_hs_fused.py``);
* the eval harness, ``evaluation/evaluate.py``, with reference ``.pth``
  loading and the recon-metric tier (``ops/chamfer.py``, ``ops/emd.py``);
* the train loop, ``engine/train.py``: the NOCS train loader
  (``data/dataset.py``, numpy decode where libpng is missing), the CLI and
  checkpoints with resume (``engine/checkpoint.py``);
* device sampling (``data/preprocess.py``, ``ops/sampling.py``) and the
  training and tier probes (``tools/``);
* multi-GPU serving (``parallel/``): the harness's crops over
  ``parallel.dp`` ranks and each crop's points over ``parallel.sp`` ranks,
  one process per GPU under ``torchrun``, with the query-sharded branches
  of the KNN, HS surface, HS support and ORL kernels.
"""

from hspose_tpu_torch.config import ModelConfig

__version__ = "0.1.0"
__all__ = ["ModelConfig", "__version__"]
