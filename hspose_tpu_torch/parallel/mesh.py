"""Process groups and the (dp, sp) rank layout (counterpart of
``hspose_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(dp, sp)`` mesh in one process
(hspose_tpu/parallel/sp.py:31-36).  Here each GPU has a process of its own,
launched by ``torchrun``:

* ``world_size = dp * sp`` ranks, rank ``dp_index * sp + sp_index``;
* one sp process group per dp row (``torch.distributed.new_group``), over
  which a crop's point shards gather and reduce (``sp.py``);
* each dp row serves its ``B / dp`` rows of every padded batch
  (``batch_sharding``, ``shard_batch``).

The ``mp`` sharding of Dense outputs (``state_sharding``) is not ported:
``parallel.mp > 1`` raises where it is read.
"""

from __future__ import annotations

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
    """This rank's place in the (dp, sp) layout.  ``sp_group`` is None when
    sp == 1 (nothing to gather) or when the rank lies outside the layout
    (``active`` False: dp was shrunk, and the rank serves nothing)."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    sp_group: Optional[dist.ProcessGroup]
    active: bool


_GROUPS: Dict[tuple, list] = {}


def make_mesh(dp: int, sp: int) -> Mesh:
    """The (dp, sp) layout over the ranks 0 .. dp * sp - 1 of the default
    group, and its sp groups, made once per (dp, sp) and kept.  Every rank
    must call it, in the same order, since each group's creation is
    collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp * sp > world:
        raise ValueError(f"dp*sp={dp}*{sp} > {world} processes")
    if sp > 1 and (dp, sp) not in _GROUPS:
        _GROUPS[(dp, sp)] = [dist.new_group(list(range(row * sp, (row + 1) * sp)),
                                            timeout=TIMEOUT) for row in range(dp)]
    active = rank < dp * sp
    row, col = divmod(rank, sp) if active else (0, 0)
    group = _GROUPS[(dp, sp)][row] if sp > 1 and active else None
    return Mesh(dp, sp, row, col, group, active)


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
