"""Reference checkpoint → flax-shaped trees (a copy of
``hspose_tpu/utils/torch_convert.py::convert_torch_state_dict`` and
``merge_with_template``, which the port cannot import).

Converts a reference HS-Pose checkpoint (``posenet_state_dict`` of
``torch.save({...})``, engine/train.py:120-129) into nested dicts of numpy
arrays shaped as the JAX package's flax param/batch-stat trees, including the
legacy key surgery of ``evaluation/evaluate.py:63-73`` (``resconv`` →
``STE_layer`` rename; train-only heads optional).  ``utils/params_io.py``
then fills the port's modules from them through
``utils/convert.py::load_jax_params``.

Layout rules:
* torch Conv1d(k=1) weight (out, in, 1)  → flax Dense kernel (in, out)
* torch Linear-like raw params (HS ``weights``/``directions``/``bias``) keep layout
* BatchNorm weight/bias → scale/bias;  running_mean/var → batch_stats mean/var
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _conv_kernel(w) -> np.ndarray:
    w = np.asarray(w)
    assert w.ndim == 3 and w.shape[-1] == 1, w.shape
    return w[..., 0].T.copy()  # (out, in) -> (in, out)


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value, np.float32)


def convert_torch_state_dict(state_dict: Dict[str, "np.ndarray"]
                             ) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats) nested dicts mirroring our flax tree.

    Accepts raw torch tensors or numpy arrays; keys with the ``posenet.`` prefix of
    the reference HSPose wrapper.
    """
    sd = {}
    for k, v in state_dict.items():
        if "resconv" in k:  # legacy rename (evaluation/evaluate.py:71-72)
            k = k.replace("resconv", "STE_layer")
        sd[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    params: Dict = {}
    stats: Dict = {}

    def bn(src_prefix, dst_path):
        if src_prefix + ".weight" not in sd:
            return
        _set(params, dst_path + ("scale",), sd[src_prefix + ".weight"])
        _set(params, dst_path + ("bias",), sd[src_prefix + ".bias"])
        _set(stats, dst_path + ("mean",), sd[src_prefix + ".running_mean"])
        _set(stats, dst_path + ("var",), sd[src_prefix + ".running_var"])

    def dense(src_prefix, dst_path, bias=True):
        if src_prefix + ".weight" not in sd:
            return False
        _set(params, dst_path + ("kernel",), _conv_kernel(sd[src_prefix + ".weight"]))
        if bias and src_prefix + ".bias" in sd:
            _set(params, dst_path + ("bias",), sd[src_prefix + ".bias"])
        return True

    fr_src = "posenet.face_recon"
    fr = ("face_recon",)

    # HS layers
    _set(params, fr + ("conv_0", "directions"), sd[f"{fr_src}.conv_0.directions"])
    dense(f"{fr_src}.conv_0.STE_layer", fr + ("conv_0", "STE_layer"), bias=False)
    dense(f"{fr_src}.conv_0.conv2", fr + ("conv_0", "conv2"), bias=False)
    for name in ["conv_1", "conv_2", "conv_3", "conv_4"]:
        _set(params, fr + (name, "weights"), sd[f"{fr_src}.{name}.weights"])
        _set(params, fr + (name, "bias"), sd[f"{fr_src}.{name}.bias"])
        _set(params, fr + (name, "directions"), sd[f"{fr_src}.{name}.directions"])
        dense(f"{fr_src}.{name}.STE_layer", fr + (name, "STE_layer"), bias=False)
        dense(f"{fr_src}.{name}.conv2", fr + (name, "conv2"), bias=False)

    for i in (1, 2, 3):
        bn(f"{fr_src}.bn{i}", fr + (f"bn{i}",))

    # train-only heads (may be pruned in eval checkpoints, evaluate.py:63-67)
    head_maps = {
        "conv1d_block": {"0": "dense_0", "1": "bn_0", "3": "dense_1", "4": "bn_1",
                         "6": "dense_out", "7": "bn_out"},
        "recon_head": {"0": "dense_0", "1": "bn_0", "3": "dense_out"},
        "face_head": {"0": "dense_0", "1": "bn_0", "3": "dense_1", "4": "bn_1",
                      "6": "dense_2", "7": "bn_2", "9": "dense_out"},
    }
    for head, idx_map in head_maps.items():
        for idx, dst in idx_map.items():
            src = f"{fr_src}.{head}.{idx}"
            if dst.startswith("dense"):
                dense(src, fr + (head, dst))
            else:
                bn(src, fr + (head, dst))

    # pose heads
    for src_head, dst_head in [("rot_green", "rot_green"), ("rot_red", "rot_red"),
                               ("ts", "ts")]:
        base = f"posenet.{src_head}"
        for i in (1, 2, 3, 4):
            dense(f"{base}.conv{i}", (dst_head, "vec", f"conv{i}"))
        for i in (1, 2, 3):
            bn(f"{base}.bn{i}", (dst_head, "vec", f"bn{i}"))

    return params, stats


def merge_with_template(converted: Dict, template: Dict) -> Dict:
    """Fill keys missing from the checkpoint (e.g. pruned train heads) with the
    template's (freshly initialized) values; verify shapes elsewhere."""
    out = {}
    for k, tv in template.items():
        if isinstance(tv, dict):
            out[k] = merge_with_template(converted.get(k, {}), tv)
        else:
            cv = converted.get(k)
            if cv is None:
                out[k] = tv
            else:
                assert np.shape(cv) == np.shape(tv), (k, np.shape(cv), np.shape(tv))
                out[k] = cv
    return out
