"""Multi-GPU serving (counterpart of ``hspose_tpu/parallel``): one process per
GPU under ``torchrun``, crops sharded over ``parallel.dp`` and each crop's
points over ``parallel.sp`` (``mesh.py``, ``sp.py``)."""

from hspose_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
from hspose_tpu_torch.parallel.sp import (
    all_gather_points,
    max_over_shards,
    mean_over_shards,
    sp_eval_fn,
    sp_points_per_device,
)

__all__ = ["Mesh", "all_gather_points", "batch_sharding", "init_distributed", "make_mesh",
           "max_over_shards", "mean_over_shards", "pad_to_multiple", "shard_batch",
           "sp_eval_fn", "sp_points_per_device"]
