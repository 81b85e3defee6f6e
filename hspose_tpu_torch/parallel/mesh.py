"""Process groups and the (dp, sp) and (dp, mp) rank layouts (counterpart of
``hspose_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(dp, sp)`` mesh for serving
(hspose_tpu/parallel/sp.py:31-36) and a ``(dp, mp)`` mesh for training and
serving (hspose_tpu/parallel/mesh.py:38-52) in one process.  Here each GPU
has a process of its own, launched by ``torchrun``:

* ``(dp, sp)``: ``dp * sp`` ranks, rank ``dp_index * sp + sp_index``; one
  sp process group per dp row, over which a crop's point shards gather and
  reduce (``sp.py``);
* ``(dp, mp)``: ``dp * mp`` ranks, rank ``dp_index * mp + mp_index``; one
  mp group per dp row, over which the Dense layers' output channels are
  sharded and gathered (``mp.py``), and one dp group per mp column, over
  which the train step reduces its BatchNorm sums, loss inputs and
  gradients (``dp.py``);
* each dp row serves or trains on its ``B / dp`` rows of every batch
  (``batch_sharding``, ``shard_batch``).

sp and mp are mutually exclusive, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# every join and collective of a group gives up after this long instead of
# waiting for a rank that is gone
TIMEOUT = timedelta(seconds=300)


def init_distributed(device=None, backend: Optional[str] = None, init_method: str = "env://",
                     rank: int = -1, world_size: int = -1,
                     timeout: timedelta = TIMEOUT) -> torch.device:
    """Join the default process group and return this rank's device.

    Under ``torchrun`` the rank, world size and rendezvous come from the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; -1 reads them there); pass them, with an
    ``init_method`` such as ``file://<path>``, to start a group by hand.  The device is ``device``
    if given, else ``cuda:LOCAL_RANK``, which must exist; the backend is
    ``backend`` if given, else ``nccl`` on a GPU and ``gloo`` on the CPU.  On
    a GPU the local rank 0 builds the kernels while the others wait at a
    barrier, so that one ``nvcc`` runs per host."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK={local_rank} has no CUDA device ({torch.cuda.device_count()} "
                "visible): run one process per GPU, or HSPOSE_PLATFORM=cpu for the CPU")
        device = f"cuda:{local_rank}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    if device.type == "cuda":
        from hspose_tpu_torch.ops import _build

        if local_rank == 0:
            _build.build()
        dist.barrier()
    return device


class Mesh(NamedTuple):
    """This rank's place in the (dp, sp) or (dp, mp) layout.  A group is
    None when its axis has size 1 (nothing to gather or reduce) or when the
    rank lies outside the layout (``active`` False: dp was shrunk, and the
    rank serves and trains on nothing).  ``dp_group`` holds the ranks of
    this rank's mp column, one per dp row; ``mp_group`` those of its dp
    row."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    sp_group: Optional[dist.ProcessGroup]
    active: bool
    mp: int = 1
    mp_index: int = 0
    mp_group: Optional[dist.ProcessGroup] = None
    dp_group: Optional[dist.ProcessGroup] = None


_GROUPS: Dict[tuple, dict] = {}


def _groups(dp: int, sp: int, mp: int) -> dict:
    """The layout's groups, made once per (dp, sp, mp) and kept: the sp or
    mp group of each dp row, then the dp group of each column."""
    key = (dp, sp, mp)
    if key not in _GROUPS:
        cols = sp * mp

        def new(ranks):
            return dist.new_group(ranks, timeout=TIMEOUT)

        _GROUPS[key] = {
            "row": [new(list(range(r * cols, (r + 1) * cols))) for r in range(dp)]
            if cols > 1 else None,
            # only the (dp, mp) layout reduces over dp
            "col": [new([r * mp + c for r in range(dp)]) for c in range(mp)]
            if dp > 1 and sp == 1 else None}
    return _GROUPS[key]


def make_mesh(dp: int, sp: int = 1, mp: int = 1) -> Mesh:
    """The (dp, sp) or (dp, mp) layout over the ranks 0 .. dp * sp * mp - 1
    of the default group, and its groups.  Every rank must call it, in the
    same order, since each group's creation is collective."""
    if sp > 1 and mp > 1:
        raise ValueError("parallel.sp and parallel.mp are mutually exclusive")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    cols = sp * mp
    if dp * cols > world:
        what = f"dp*mp={dp}*{mp}" if mp > 1 else f"dp*sp={dp}*{sp}"
        raise ValueError(f"{what} > {world} processes")
    groups = _groups(dp, sp, mp) if dp * cols > 1 else {"row": None, "col": None}
    active = rank < dp * cols
    row, col = divmod(rank, cols) if active else (0, 0)
    row_group = groups["row"][row] if groups["row"] and active else None
    col_group = groups["col"][col] if groups["col"] and active else None
    if mp > 1:
        return Mesh(dp, 1, row, 0, None, active, mp, col, row_group, col_group)
    return Mesh(dp, sp, row, col, row_group, active, dp_group=col_group)


def resolve_mesh(parallel, batch_size: int, logger: logging.Logger,
                 batch_name: str = "batch") -> Mesh:
    """The (dp, sp) or (dp, mp) layout of ``parallel`` (a ``ParallelConfig``)
    over the process group's ranks (one rank without a group), sized as the
    JAX package sizes its meshes (hspose_tpu/engine/train.py:38-80): dp =
    ``parallel.dp``, or every rank not on the sp or mp axis for -1, shrunk
    until it divides ``batch_size``, with the JAX package's warnings."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    sp, mp = max(parallel.sp, 1), max(parallel.mp, 1)
    axis, cols = ("mp", mp) if mp > 1 else ("sp", sp)
    dp_req = parallel.dp if parallel.dp > 0 else world // cols
    if dp_req < 1 or dp_req * cols > world:
        raise ValueError(f"parallel.dp={parallel.dp} x parallel.{axis}={cols} does not fit "
                         f"{world} process(es)")
    dp = dp_req
    while batch_size % dp:
        dp -= 1
    if dp < dp_req:
        logger.warning("data axis shrunk dp=%d -> dp=%d (%s %d not divisible by %d)",
                       dp_req, dp, batch_name, batch_size, dp_req)
    if dp * cols < world:
        logger.warning("mesh dp=%d x %s=%d uses %d of the %d processes; the rest sit idle",
                       dp, axis, cols, dp * cols, world)
    return make_mesh(dp, sp, mp)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a batch of ``batch_size`` (a multiple of dp) that this
    rank's dp row serves."""
    per = batch_size // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's rows of every array of ``batch`` (leading axis the batch)."""
    rows = batch_sharding(mesh, next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


def pad_to_multiple(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the leading axis up to a multiple (for ragged eval batches)."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
            for k, v in batch.items()}
