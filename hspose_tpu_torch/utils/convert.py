"""Load the JAX package's flax variables into the port's modules.

The port's submodules are named after the flax tree
(``face_recon.conv_0.directions``, ``rot_green.vec.conv1``, ...), so the
mapping is mechanical:

* a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
* BatchNorm ``scale`` / ``bias`` become ``weight`` / ``bias``, and the
  ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` / ``running_var``;
* the HS layers' ``weights`` / ``bias`` / ``directions`` keep their layout.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Fill ``model`` in place from flax trees given as nested dicts of numpy
    arrays (what ``jax.device_get(variables["params"])`` returns).

    Raises on a flax leaf with no place in the port, on a shape mismatch, and
    on any port parameter or buffer left unset (BatchNorm's
    ``num_batches_tracked`` has no flax counterpart and is not counted)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()

    def put(flax_path, name, value):
        if name not in targets:
            raise KeyError(f"flax leaf {'/'.join(flax_path)} has no place in the "
                           f"port (looked for {name})")
        t = targets[name]
        v = torch.from_numpy(np.array(value)).to(t.dtype)
        if v.shape != t.shape:
            raise ValueError(f"{'/'.join(flax_path)} -> {name}: shape "
                             f"{tuple(v.shape)} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v)
        filled.add(name)

    for path, leaf in _leaves(params):
        *mod, last = path
        if last == "kernel":
            put(path, ".".join(mod + ["weight"]), np.asarray(leaf).T)
        elif last == "scale":
            put(path, ".".join(mod + ["weight"]), leaf)
        else:
            put(path, ".".join(path), leaf)
    for path, leaf in _leaves(batch_stats):
        *mod, last = path
        if last not in _STATS:
            raise KeyError(f"batch_stats leaf {'/'.join(path)} has no place in the port")
        put(path, ".".join(mod + [_STATS[last]]), leaf)

    unset = sorted(n for n in targets
                   if n not in filled and not n.endswith("num_batches_tracked"))
    if unset:
        raise ValueError(f"port parameters left unset: {unset}")
