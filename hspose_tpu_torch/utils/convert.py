"""Load the JAX package's flax variables into the port's modules.

The port's submodules are named after the flax tree
(``face_recon.conv_0.directions``, ``rot_green.vec.conv1``, ...), so the
mapping is mechanical:

* a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
* BatchNorm ``scale`` / ``bias`` become ``weight`` / ``bias``, and the
  ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` / ``running_var``;
* the HS layers' ``weights`` / ``bias`` / ``directions`` keep their layout.

The training tree (``init(..., train=True)``) also holds the train-only
heads (``face_recon.conv1d_block``, ``recon_head``, ``face_head``); it loads
into a model built with ``train_heads=True``.  The eval tree loads into a
model built without them.  ``flax_variables`` is the inverse: the model's
own values as those two trees.
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


def port_name(flax_path: tuple, stats: bool = False) -> tuple[str, bool]:
    """(port parameter or buffer name, whether the value is transposed) for a
    leaf of the flax ``params`` tree, or of ``batch_stats`` when ``stats``."""
    *mod, last = flax_path
    if stats:
        if last not in _STATS:
            raise KeyError(f"batch_stats leaf {'/'.join(flax_path)} has no place in the port")
        return ".".join(mod + [_STATS[last]]), False
    if last == "kernel":
        return ".".join(mod + ["weight"]), True
    if last == "scale":
        return ".".join(mod + ["weight"]), False
    return ".".join(flax_path), False


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

    for tree, stats in ((params, False), (batch_stats, True)):
        for path, leaf in _leaves(tree):
            name, transpose = port_name(path, stats)
            put(path, name, np.asarray(leaf).T if transpose else leaf)

    unset = sorted(n for n in targets
                   if n not in filled and not n.endswith("num_batches_tracked"))
    if unset:
        raise ValueError(f"port parameters left unset: {unset}")


def flax_variables(model: nn.Module) -> tuple[dict, dict]:
    """(params, batch_stats): the model's values as the flax trees that
    ``load_jax_params`` reads, numpy fp32; Linear weights come out as
    (in, out) kernels."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.detach().float().cpu().numpy()

    for name, module in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        for leaf, value in module.named_parameters(recurse=False):
            if isinstance(module, nn.Linear) and leaf == "weight":
                put(params, path + ("kernel",), value.T)
            elif isinstance(module, nn.BatchNorm1d) and leaf == "weight":
                put(params, path + ("scale",), value)
            else:
                put(params, path + (leaf,), value)
        if isinstance(module, nn.BatchNorm1d):
            put(stats, path + ("mean",), module.running_mean)
            put(stats, path + ("var",), module.running_var)
    return params, stats
