"""Small constant tensors of the train forward, made once per device and type.

An index that is a Python list, or ``new_tensor`` of host numbers, copies
host memory to the card at every call: a pageable copy that makes the host
wait for the card, and one that a CUDA graph capture refuses.  ``const``
makes such a tensor the first time it is asked for on a device and hands
out that same tensor afterwards, so that a train step's first run, which is
eager (``engine/graphed_step.py``), makes it before a graph is captured.

Indexing by the cached int64 tensor is the op that indexing by the list
runs (the list becomes an int64 tensor first), so the result has the same
values and strides; a cached float tensor holds what ``new_tensor`` would.
The tensors are shared: nothing may write to them.
"""

from __future__ import annotations

import torch

_MADE: dict = {}


def const(values: tuple, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once."""
    key = (values, torch.device(device), dtype)
    t = _MADE.get(key)
    if t is None:
        t = _MADE[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
