"""Multi-GPU serving and training (counterpart of ``hspose_tpu/parallel``):
one process per GPU under ``torchrun``, crops sharded over ``parallel.dp``,
each crop's points over ``parallel.sp`` in serving, and the wide Dense
layers' output channels over ``parallel.mp`` (``mesh.py``, ``sp.py``,
``dp.py``, ``mp.py``)."""

from hspose_tpu_torch.parallel.dp import (
    all_reduce_sum,
    broadcast_gradients,
    copy_to_group,
    gather,
    reduce_gradients,
)
from hspose_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    resolve_mesh,
    shard_batch,
)
from hspose_tpu_torch.parallel.mp import distribute
from hspose_tpu_torch.parallel.sp import (
    all_gather_points,
    max_over_shards,
    mean_over_shards,
    sp_eval_fn,
    sp_points_per_device,
)

__all__ = ["Mesh", "all_gather_points", "all_reduce_sum", "batch_sharding",
           "broadcast_gradients", "copy_to_group",
           "distribute", "gather", "init_distributed", "make_mesh", "max_over_shards",
           "mean_over_shards", "pad_to_multiple", "reduce_gradients", "resolve_mesh",
           "shard_batch",
           "sp_eval_fn", "sp_points_per_device"]
