"""Checkpoints of the whole training state (counterpart of
``hspose_tpu/engine/checkpoint.py``, which writes orbax).

The reference ``torch.save``s {seed, epoch, model, scheduler, optimizer}
every ``save_every`` epochs (engine/train.py:120-129) and resumes from it
(engine/train.py:26-34,53-58).  The port keeps the JAX package's layout,
``<model_save>/model_{epoch:03d}/`` holding ``meta.json`` ({epoch, seed,
decode}) beside ``state.pt``, one ``torch.save`` of:

* ``model``: the model's state dict, BatchNorm running statistics included;
* ``optimizer``: Ranger's state dict (first and second moments, the
  lookahead's slow weights) and ``optimizer_count``, its step count, from
  which the schedule's learning rate follows;
* ``mini_step`` and ``accumulator``: ``train.accumulate``'s micro-step and
  gradient mean;
* ``epoch`` and ``seed``.

No generator state is saved: the train loop seeds every step's generator
from (seed, global step) and every batch from (seed + 997 epoch, step), so
the seed and the epoch are the whole randomness state.  The batches also
depend on the loader's decode path (``data/dataset.py::decode_path``: the
native and numpy crops can differ at half-pixel coordinates), which
``meta.json`` records as ``decode``.

Checkpoints are free of the topology that wrote them, as the JAX
package's host trees are: under a (dp, mp) mesh every rank calls
``save_checkpoint``, the parameters sharded over mp (``parallel/mp.py``),
their optimizer moments and lookahead weights and their accumulator are
gathered to full tensors, and rank 0 alone writes them; every rank
restores the full tensors and keeps its own rows of the sharded ones.  So a
checkpoint of any dp and mp resumes under any other, one process included,
and loads in the one-process eval CLI.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from hspose_tpu_torch.parallel import mp

STATE_FILE = "state.pt"


def save_checkpoint(path: str, model: nn.Module, step, epoch: int, seed: int,
                    decode: str = "") -> str:
    """Write ``model`` and the train step's optimizer state (``step`` is
    what ``build_train_step`` returns) as ``path/model_{epoch:03d}``; returns
    that directory.  ``decode`` is the loader's decode path, kept in
    ``meta.json``.  In a process group every rank calls it and rank 0
    writes (module docstring)."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"model_{epoch:03d}")
    weights = model.state_dict()
    for name, p in model.named_parameters():
        weights[name] = mp.full(p, weights[name])
    params = step.optimizer.param_groups[0]["params"]
    optimizer = step.optimizer.state_dict()
    for i, p in enumerate(params):
        optimizer["state"][i] = {k: mp.full(p, v) if torch.is_tensor(v) and v.dim() else v
                                 for k, v in optimizer["state"][i].items()}
    accumulator = [mp.full(p, a) for p, a in zip(params, step.accumulator)]
    if dist.is_initialized() and dist.get_rank() != 0:
        return ckpt_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {"model": weights, "optimizer": optimizer,
             "optimizer_count": step.optimizer.count, "mini_step": step.mini_step,
             "accumulator": accumulator, "epoch": epoch, "seed": seed}
    tmp = os.path.join(ckpt_dir, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(ckpt_dir, STATE_FILE))
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"epoch": epoch, "seed": seed, "decode": decode}, f)
    return ckpt_dir


def read_meta(ckpt_dir: str) -> dict:
    """``meta.json`` of a checkpoint directory."""
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        return json.load(f)


def _read(ckpt_dir: str, device) -> dict:
    return torch.load(os.path.join(os.path.abspath(ckpt_dir), STATE_FILE),
                      map_location=device, weights_only=True)


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is a checkpoint directory of the port."""
    return os.path.isfile(os.path.join(path, STATE_FILE))


def restore_checkpoint(ckpt_dir: str, model: nn.Module, step) -> Tuple[int, int]:
    """Fill ``model`` and the train step's optimizer state in place from
    ``ckpt_dir``, this rank's rows of the parameters sharded over mp;
    returns (epoch, seed)."""
    device = next(model.parameters()).device
    state = _read(ckpt_dir, device)
    weights = state["model"]
    for name, p in model.named_parameters():
        weights[name] = mp.local(p, weights[name])
    model.load_state_dict(weights)
    params = step.optimizer.param_groups[0]["params"]
    optimizer = state["optimizer"]
    for i, p in enumerate(params):
        optimizer["state"][i] = {k: mp.local(p, v) if torch.is_tensor(v) and v.dim() else v
                                 for k, v in optimizer["state"][i].items()}
    step.optimizer.load_state_dict(optimizer)
    step.optimizer.count = state["optimizer_count"]
    step.mini_step = state["mini_step"]
    if len(state["accumulator"]) != len(step.accumulator):
        raise ValueError(f"{ckpt_dir}: saved with train.accumulate "
                         f"{'> 1' if state['accumulator'] else '= 1'}, resumed with another")
    with torch.no_grad():
        for p, a, saved in zip(params, step.accumulator, state["accumulator"]):
            a.copy_(mp.local(p, saved))
    meta = read_meta(ckpt_dir)
    return meta["epoch"], meta["seed"]


def load_model_state(model: nn.Module, ckpt_dir: str) -> None:
    """Fill ``model`` from a checkpoint's weights and BatchNorm statistics;
    entries the model lacks (the train heads, for a model built without
    them) are left out.  Raises where the model has an entry the checkpoint
    lacks."""
    saved = _read(ckpt_dir, next(model.parameters()).device)["model"]
    model.load_state_dict({k: saved[k] for k in model.state_dict()})


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    cands = sorted(d for d in os.listdir(path) if d.startswith("model_"))
    return os.path.join(path, cands[-1]) if cands else None
