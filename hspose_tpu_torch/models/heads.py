"""Pose heads (counterpart of ``hspose_tpu/models/heads.py``): two rotation
heads (1286 -> 1024 -> 256 | max over points | 256 -> 256 -> 4) and the
translation/size head (1289 -> ... -> 6), channel-last.  In train mode each
head applies dropout 0.2 after its third block, with an injected keep-mask
when one is given.  With ``dtype=torch.bfloat16`` (the bf16 tier) the
products, BatchNorm and dropout run in bf16 and the output is cast to fp32,
as the JAX heads with ``dtype=bfloat16`` (hspose_tpu/models/heads.py:39-94).
With an sp group (sequence-parallel serving) each rank holds a shard of the
points, and the max-pool over points finishes as the max over the group
(heads.py:83-84).  Under mp (``parallel/mp.py``) conv1, conv2 and conv3
form their own output columns and gather the rest.

Two routes reach the heads' first block (conv1, bn1, ReLU), and
``posenet.py::PoseNet9D.factored`` picks one from what it can observe:

* the concatenated route, ``VecHead.forward`` on the 1286-d feature (and the
  centred points for ts): training, any forward with gradients enabled, or
  a head layer sharded over mp;
* the factored route, ``FirstLayers``, in every other forward: eval mode
  without gradients, served on one process or over an sp group, with or
  without ``with_heads``.  The backbone's maps are multiplied at their own
  resolutions by the three heads' stacked weights, then one
  gather-add-BatchNorm-ReLU epilogue (``ops/heads_epilogue.py``) runs, the
  1286-d feature never built for the pose heads; the heads go on from their
  columns of its output (``VecHead.tail``)."""

from __future__ import annotations

import itertools

import torch
from torch import nn

from hspose_tpu_torch.models.face_recon import RES_C, BackboneMaps, _bn, batch_norm
from hspose_tpu_torch.models.layers import dense
from hspose_tpu_torch.ops.heads_epilogue import build_params, heads_epilogue
from hspose_tpu_torch.parallel.mp import columns
from hspose_tpu_torch.parallel.sp import max_over_shards

KEEP_PROB = 1.0 - 0.2  # dropout 0.2 after bn3


class VecHead(nn.Module):
    """Shared architecture of the three heads.  With ``xyz`` given, the first
    layer's (Cx + 3, 1024) weight runs as a split product
    x @ W[:Cx] + xyz @ W[Cx:] + b instead of on a materialised concat."""

    def __init__(self, in_c: int, out_c: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Linear(in_c, 1024, device=device)
        self.bn1 = _bn(1024, device)
        self.conv2 = nn.Linear(1024, 256, device=device)
        self.bn2 = _bn(256, device)
        self.conv3 = nn.Linear(256, 256, device=device)
        self.bn3 = _bn(256, device)
        self.conv4 = nn.Linear(256, out_c, device=device)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor | None = None,
                keep: torch.Tensor | None = None, sp_group=None) -> torch.Tensor:
        """x (B, N, C) per-point features -> (B, out_c).  ``keep`` (B, 256)
        bool is the dropout keep-mask in train mode (drawn from torch's
        global generator when None)."""
        dt = self.dtype
        if xyz is None:
            h = dense(self.conv1, x, dt)
        else:
            w = self.conv1.weight.to(dt)  # (1024, Cx + 3), or this rank's rows under mp
            cx = x.shape[-1]
            h = columns(self.conv1, lambda a, b: (a @ w[:, :cx].t() + b @ w[:, cx:].t()
                                                  + self.conv1.bias.to(dt)),
                        x.to(dt), xyz.to(dt))
        return self.tail(torch.relu(batch_norm(self.bn1, h)), keep, sp_group)

    def tail(self, h: torch.Tensor, keep: torch.Tensor | None = None,
             sp_group=None) -> torch.Tensor:
        """The layers after the first block: h (B, N, 1024), its output after
        bn1 and ReLU (on the serving route a column slice of ``FirstLayers``'
        output, rows 3072 apart) -> (B, out_c)."""
        dt = self.dtype
        B, N, _ = h.shape
        h = dense(self.conv2, h.reshape(B * N, -1), dt).reshape(B, N, -1)
        h = torch.relu(batch_norm(self.bn2, h))
        h = h.amax(dim=1, keepdim=True)  # global max over points (B, 1, 256)
        h = max_over_shards(h, sp_group)
        h = torch.relu(batch_norm(self.bn3, dense(self.conv3, h, dt)))[:, 0, :]
        if self.training:
            if keep is None:
                keep = torch.rand(h.shape, device=h.device) < KEEP_PROB
            # flax divides by the keep probability in h's dtype: 0.8 is
            # 0.80078125 in bf16 (and 0.8 again in fp32)
            h = torch.where(keep, h / torch.tensor(KEEP_PROB, dtype=h.dtype).item(), 0.0)
        return dense(self.conv4, h, dt).float()


class RotationHead(nn.Module):
    """Rot_green / Rot_red: a 4-vector [confidence, axis(3)]."""

    def __init__(self, in_c: int, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vec = VecHead(in_c, 4, device=device, dtype=dtype)

    def forward(self, feat: torch.Tensor, keep: torch.Tensor | None = None,
                sp_group=None) -> torch.Tensor:
        return self.vec(feat, keep=keep, sp_group=sp_group)


class PoseTsHead(nn.Module):
    """Pose_Ts: translation residual (3) and size residual (3), from the
    per-point features and the centred points."""

    def __init__(self, in_c: int, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vec = VecHead(in_c + 3, 6, device=device, dtype=dtype)

    def forward(self, feat: torch.Tensor, xyz: torch.Tensor,
                keep: torch.Tensor | None = None, sp_group=None):
        x = self.vec(feat, xyz, keep, sp_group)
        return x[:, 0:3], x[:, 3:6]


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (B, M, K) @ w (K, C) -> (B, M, C) fp32: fp32 operands, or bf16 ones
    whose products sum in fp32 and stay fp32."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float32:
        p = a2 @ w
    elif a.is_cuda:
        p = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        p = a2.float() @ w.float()  # bf16 products are exact in fp32
    return p.reshape(*a.shape[:-1], -1)


class FirstLayers:
    """The serving route of the heads' first block (conv1, bn1, ReLU) for
    rot_green, rot_red and ts at once.  The block multiplies the per-point
    feature [fm_0 | fm_1 | fm_2 | fm_3 | fm_4 | one-hot] (and ts the centred
    points too), whose fm_2..fm_4 reach the N points by a 1-NN gather; a
    product commutes with a row gather, so this multiplies each map at its
    own resolution by the three heads' stacked weights (3072 columns) and
    ``ops/heads_epilogue.py`` gathers, adds the one-hot's and the points'
    columns and the bias, and applies each bn1 and ReLU: (B, N, 3072), the
    heads' 1024-column blocks side by side, in the tier's type.  The same
    function as each head's ``VecHead.forward`` up to the order of fp32
    additions (bf16: the sum is rounded once, as one product rounds it).

    The stacked weights and the epilogue's constants are cached, and rebuilt
    when any of the heads' conv1 and bn1 tensors has moved (a new storage, or
    an in-place write: ``load_state_dict``, ``load_jax_params``, an optimizer
    step, a train-mode BatchNorm update).  A write through ``.data`` bumps no
    version and is not seen.  Rebuilding them every call costs the bf16
    served forward at B = 96 on an H100 32 launches and 5-8 ms of traced
    host time a batch (``forward_host_ms.serve``; PERF.md section 6)."""

    def __init__(self, heads: tuple[VecHead, ...]):
        self.heads = heads
        self._key = None
        self._consts = None

    def _sources(self):
        for h in self.heads:
            yield from (h.conv1.weight, h.conv1.bias, h.bn1.weight, h.bn1.bias,
                        h.bn1.running_mean, h.bn1.running_var)

    @torch.no_grad()
    def consts(self) -> tuple[torch.Tensor, ...]:
        """(w0, w1, w2, wcat, wxyz, params): the stacked weights of the three
        resolutions (K, 3072) in the tier's type, the one-hot's columns
        (obj_c, 3072), ts's point columns (3, 1024) and the epilogue's
        (5, 3072), fp32 holding the tier's values."""
        dt = self.heads[0].dtype
        key = (dt,) + tuple((t.device, t.data_ptr(), t._version) for t in self._sources())
        if key != self._key:
            feat_c = self.heads[0].conv1.in_features
            w = torch.cat([h.conv1.weight[:, :feat_c] for h in self.heads]).to(dt)
            ends = list(itertools.accumulate(RES_C))
            ws = [w[:, a:b].t().contiguous() for a, b in zip([0] + ends[:-1], ends)]
            wcat = w[:, ends[-1]:].t().float().contiguous()
            wxyz = self.heads[-1].conv1.weight[:, feat_c:].to(dt).t().float().contiguous()
            params = torch.cat([build_params(h.conv1.bias, h.bn1.running_mean,
                                             h.bn1.running_var, h.bn1.weight, h.bn1.bias,
                                             h.bn1.eps, dt) for h in self.heads], dim=1)
            self._consts = (*ws, wcat, wxyz, params)
            self._key = key
        return self._consts

    def __call__(self, maps: BackboneMaps, cat_id: torch.Tensor,
                 xyz: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """maps of B crops, cat_id (B,) 0-based, xyz (B, N, 3) the centred
        points -> each head's (B, N, 1024) output of its first block: column
        blocks of one (B, N, 3072) tensor."""
        w0, w1, w2, wcat, wxyz, params = self.consts()
        if cat_id.dtype not in (torch.int32, torch.int64):
            cat_id = cat_id.long()
        p = [_product(a, w) for a, w in ((torch.cat([maps.fm_0, maps.fm_1], -1), w0),
                                        (torch.cat([maps.fm_2, maps.fm_3], -1), w1),
                                        (maps.fm_4, w2))]
        dt = self.heads[0].dtype
        # fp32: h takes P0's place, which each element is read from before it is written
        h = heads_epilogue(*p, maps.up_1, maps.up_2, cat_id.reshape(-1), xyz.to(dt), wcat, wxyz,
                           params, out=p[0] if dt == torch.float32 else None)
        return h.split([head.conv1.out_features for head in self.heads], dim=-1)
