"""Model parallelism: the output channels of the wide Dense layers sharded
over an mp group (counterpart of ``hspose_tpu/parallel/mesh.py::
state_sharding``, :63-93).

The JAX rule: a Dense kernel whose output width is at least 256 and divides
by mp shards its output channels over mp; everything else is replicated,
the HS layers' ``weights`` / ``directions`` (the kernels' operands)
included.  In this model that is the heads' conv1, conv2 and conv3, the
``STE_layer`` and ``conv2`` of conv_2, conv_3 and conv_4, and the recon
heads' layers of 256 or more channels (``conv1d_block`` and the first two of
``face_head``).

``distribute`` applies it in place: mp rank i keeps rows i * out / mp ..
(i + 1) * out / mp of such a layer's (out, in) weight and of its bias, so
it holds, reduces and updates only its own output columns (their
gradients, the optimizer's moments and lookahead weights follow the
parameter).  ``columns`` runs the layer's product on them and gathers the
full activation over the mp group before anything reads it
(``dp.gather``), so everything downstream, the HS kernels too, sees the
replicated operands of the one-process model.  Checkpoints hold full
tensors: ``full`` gathers a sharded tensor, ``local`` cuts the rank's part
out of a full one.

``distribute`` also hands each BatchNorm layer the mesh's dp group, over
which it takes its train-mode sums (``models/face_recon.py::batch_norm``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from hspose_tpu_torch.parallel.dp import copy_to_group, gather
from hspose_tpu_torch.parallel.mesh import Mesh

MIN_SHARDED_OUT = 256  # the JAX rule's least output width


def shards(layer: nn.Module, mp: int) -> bool:
    """Whether the JAX rule shards ``layer`` over an mp axis of size ``mp``."""
    return (mp > 1 and isinstance(layer, nn.Linear) and layer.out_features >= MIN_SHARDED_OUT
            and layer.out_features % mp == 0)


def distribute(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Lay ``model`` out on ``mesh`` in place and return it: each BatchNorm
    layer gets the dp group, and with mp > 1 each layer the rule shards
    keeps this rank's output rows.  A model is laid out once."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already laid out on a mesh")
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.dp_group = mesh.dp_group
        if shards(m, mesh.mp) and mesh.active:
            m.mp_group = mesh.mp_group
            for p in m.parameters(recurse=False):
                p.mp_group = mesh.mp_group
                p.data = local(p, p.data)
    model.mesh = mesh
    return model


def group_of(p: torch.Tensor) -> Optional[dist.ProcessGroup]:
    """The mp group a parameter is sharded over, None where it is replicated."""
    return getattr(p, "mp_group", None)


def columns(layer: nn.Module, fn: Callable[..., torch.Tensor],
            *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)``, a product of ``layer``'s weight with channels last: on a
    sharded layer this rank's output columns of it, gathered over the mp
    group; the inputs' cotangents are summed over the group."""
    group = getattr(layer, "mp_group", None)
    if group is None:
        return fn(*xs)
    y = fn(*(copy_to_group(x, group) for x in xs))
    return gather([y], group, dim=-1)[0]


def local(p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``value``, a full tensor of the parameter ``p``'s
    shape (``value`` itself where ``p`` is replicated)."""
    group = group_of(p)
    if group is None:
        return value
    n = value.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    return value[r * n:(r + 1) * n].clone()


def full(p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """The full tensor of which ``value`` is this rank's rows, gathered over
    ``p``'s mp group (``value`` itself where ``p`` is replicated).  Every
    rank of the group must call it."""
    group = group_of(p)
    if group is None:
        return value
    return gather([value.detach()], group)[0]
