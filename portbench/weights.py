"""The model's weights, made from the seed on the device.

One dict, name -> tensor, named as the port's state dict (PoseNet9D with
the train heads when ``train_heads``), made in three calls of one
``torch.Generator`` on ``device``: a uniform draw for every weight, bias and
support direction, each scaled to its layer's init bound (nn.Linear's
1/sqrt(fan_in); the HS layers' 1/sqrt(Co (S+1)) and 1/sqrt(S Co),
hspose_tpu_torch/models/layers.py:75-77, 177-184), a normal draw for the
BatchNorm running means (x 0.1) and a uniform one for their variances
(0.5 .. 1.5), as ``chip_smoke.py::build_seeded_model`` sets them so that
they matter.  BatchNorm scales are 1 and shifts 0.  The benchmark hands
the same dict to the program (``load_state_dict``) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

FEAT_C = 128 + 128 + 256 + 256 + 512
Spec = List[Tuple[str, tuple, str, float]]  # name, shape, kind, uniform bound


def param_spec(model_cfg: dict, train_heads: bool) -> Spec:
    """Every tensor of the state dict: (name, shape, kind, bound); kind is
    ``u`` (uniform in +-bound), ``one``, ``zero``, ``mean``, ``var`` or
    ``count`` (BatchNorm's num_batches_tracked)."""
    S, obj_c, face_c = model_cfg["gcn_sup_num"], model_cfg["obj_c"], model_cfg["face_recon_c"]
    spec: Spec = []

    def linear(name, cin, cout, bias=True):
        b = 1.0 / math.sqrt(cin)
        spec.append((name + ".weight", (cout, cin), "u", b))
        if bias:
            spec.append((name + ".bias", (cout,), "u", b))

    def bn(name, c):
        spec.extend([(name + ".weight", (c,), "one", 0.0), (name + ".bias", (c,), "zero", 0.0),
                     (name + ".running_mean", (c,), "mean", 0.0),
                     (name + ".running_var", (c,), "var", 0.0),
                     (name + ".num_batches_tracked", (), "count", 0.0)])

    def hs(name, cin, co):
        std = 1.0 / math.sqrt(co * (S + 1))
        spec.extend([(name + ".weights", (cin, (S + 1) * co), "u", std),
                     (name + ".bias", ((S + 1) * co,), "u", std),
                     (name + ".directions", (3, S * co), "u", std)])
        linear(name + ".STE_layer", cin, co, bias=False)
        linear(name + ".conv2", 2 * co, co, bias=False)

    def mlp(name, cin, hidden, out, final_act):
        for i, h in enumerate(hidden):
            linear(f"{name}.dense_{i}", cin, h)
            bn(f"{name}.bn_{i}", h)
            cin = h
        linear(name + ".dense_out", cin, out)
        if final_act:
            bn(name + ".bn_out", out)

    fr = "face_recon."
    spec.append((fr + "conv_0.directions", (3, S * 128), "u", 1.0 / math.sqrt(S * 128)))
    linear(fr + "conv_0.STE_layer", 3, 128, bias=False)
    linear(fr + "conv_0.conv2", 256, 128, bias=False)
    hs(fr + "conv_1", 128, 128)
    bn(fr + "bn1", 128)
    hs(fr + "conv_2", 128, 256)
    bn(fr + "bn2", 256)
    hs(fr + "conv_3", 256, 256)
    bn(fr + "bn3", 256)
    hs(fr + "conv_4", 256, 512)
    feat_c = FEAT_C + obj_c
    if train_heads:
        mlp(fr + "conv1d_block", feat_c, (512, 512), 256, True)
        mlp(fr + "recon_head", 256, (128,), 3, False)
        mlp(fr + "face_head", 512 + 256 + 3, (512, 256, 128), face_c, False)
    for head, cin, out in (("rot_green", feat_c, 4), ("rot_red", feat_c, 4),
                           ("ts", feat_c + 3, 6)):
        name = head + ".vec"
        linear(name + ".conv1", cin, 1024)
        bn(name + ".bn1", 1024)
        linear(name + ".conv2", 1024, 256)
        bn(name + ".bn2", 256)
        linear(name + ".conv3", 256, 256)
        bn(name + ".bn3", 256)
        linear(name + ".conv4", 256, out)
    return spec


def trainable(spec: Spec) -> List[str]:
    """The names the optimizer steps, in the state dict's order."""
    return [name for name, _, kind, _ in spec if kind in ("u", "one", "zero")]


def make_weights(model_cfg: dict, train_heads: bool, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict drawn from ``seed`` on ``device`` (fp32)."""
    spec = param_spec(model_cfg, train_heads)
    g = torch.Generator(device=device).manual_seed(seed)

    def count(kind):
        return sum(math.prod(shape) for _, shape, k, _ in spec if k == kind)

    u = torch.rand(count("u"), generator=g, device=device).mul_(2.0).sub_(1.0)
    mean = torch.randn(count("mean"), generator=g, device=device).mul_(0.1)
    var = torch.rand(count("var"), generator=g, device=device).add_(0.5)
    pos = {"u": 0, "mean": 0, "var": 0}
    pools = {"u": u, "mean": mean, "var": var}
    out = {}
    for name, shape, kind, bound in spec:
        n = math.prod(shape)
        if kind in pools:
            t = pools[kind][pos[kind]:pos[kind] + n].view(shape)
            pos[kind] += n
            out[name] = t * bound if kind == "u" else t.clone()
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return out
