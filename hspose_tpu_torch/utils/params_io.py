"""Load weights into the port's modules (counterpart of
``hspose_tpu/utils/params_io.py``): a reference HS-Pose torch checkpoint goes
straight into a ``PoseNet9D``, with no JAX in between, and so does a
checkpoint of the port's own train loop."""

from __future__ import annotations

import os

import torch
from torch import nn

from hspose_tpu_torch.utils.convert import flax_variables, load_jax_params
from hspose_tpu_torch.utils.torch_convert import convert_torch_state_dict, merge_with_template


def load_torch_checkpoint(model: nn.Module, path: str) -> None:
    """Fill ``model`` in place from a reference checkpoint: a ``.pth`` of
    ``{"posenet_state_dict": ...}`` or of the state dict itself, keys with
    the ``posenet.`` prefix, legacy ``resconv`` names accepted.

    The state dict becomes flax-shaped trees (``convert_torch_state_dict``),
    which fill the model through ``load_jax_params``.  Leaves the checkpoint
    lacks (e.g. the train heads of a pruned eval checkpoint) keep the
    model's own values, and leaves the model lacks (the train heads, for a
    model built without them) are dropped, as ``merge_with_template`` does
    against the JAX package's training-tree template."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params, stats = convert_torch_state_dict(ckpt.get("posenet_state_dict", ckpt))
    own_params, own_stats = flax_variables(model)
    load_jax_params(model, merge_with_template(params, own_params),
                    merge_with_template(stats, own_stats))


def load_params(model: nn.Module, path: str) -> None:
    """The harness's weights: a reference torch checkpoint (``.pth`` /
    ``.pt``) or a checkpoint directory of the port's train loop
    (``engine/checkpoint.py``, ``model_NNN/``).  The JAX package also
    restores its own orbax checkpoints here; the port does not read them
    (what is left of ROADMAP Queue 1 item 1)."""
    from hspose_tpu_torch.engine.checkpoint import is_checkpoint, load_model_state

    if os.path.isdir(path) and is_checkpoint(path):
        load_model_state(model, path)
    elif path.endswith((".pth", ".pt")):
        load_torch_checkpoint(model, path)
    else:
        raise NotImplementedError(
            f"{path!r}: the port loads reference torch checkpoints (.pth, .pt) and its own "
            "training checkpoints (model_NNN/ with state.pt); the JAX package's orbax "
            "checkpoints are what is left of ROADMAP Queue 1 item 1")
