"""HS-Pose's PoseNet9D in plain PyTorch, float32: the serving forward with
``generate_RT``, and the train forward with its augmentation and losses.

A frozen copy of the math, written as functions of a dict of parameters
named as the port's state dict (the benchmark makes one dict from the seed
and hands it to both sides).  Copied from the port's plain versions, which
its CPU tests hold to the JAX package:

* centring, heads and outputs: ``hspose_tpu_torch/models/posenet.py:60-97``,
  ``models/heads.py:39-94`` (dropout as ``keep`` masks scaled by 1 / 0.8);
* the backbone: ``models/face_recon.py:173-258`` (nine KNN searches, two 4x
  pools, 1-NN upsampling, the train heads), BatchNorm as
  ``face_recon.py:53-106``: in train mode flax's fast variance
  E[x^2] - E[x]^2 clipped at 0, in eval mode the running statistics;
* the layers: ``models/layers.py:96-233``, the HS reductions as their plain
  versions ``ops/cuda_hs_fused.py:128-178`` (mean over supports of the max
  over neighbours; the support projection before the gather), in fp32 only;
* the searches: ``ops/knn.py:17-48``, ``:121-124`` (the k+1 smallest by a
  stable sort of the expanded squared distances, column 0 dropped);
* the train forward: ``models/hspose.py:136-269`` and
  ``data/augment.py:37-125`` (the four gated transforms, under no_grad).

Every product goes through ``Precision.mm`` and every activation a layer
hands on through ``Precision.act``, so the same code computes the reference
in float32 and in the lower precisions of ``precision.py``.  It has no kernels, no
cache and no batching of its own, and imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import geometry_losses as L
from portbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]
KEEP_PROB = 0.8
BN_EPS = 1e-5


class Arch(NamedTuple):
    """The widths of the configuration file (``configs/*.json``)."""

    support: int = 7
    k: int = 20
    obj_c: int = 6
    face_c: int = 30

    @classmethod
    def of(cls, model_cfg: dict) -> "Arch":
        return cls(model_cfg["gcn_sup_num"], model_cfg["gcn_n_num"], model_cfg["obj_c"],
                   model_cfg["face_recon_c"])


class Forward:
    """One forward's parameters and mode: ``train`` takes batch statistics
    and dropout, else the running statistics."""

    def __init__(self, P: Params, arch: Arch, train: bool, prec: Precision):
        self.P, self.arch, self.train, self.prec = P, arch, train, prec
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
        torch.backends.cudnn.allow_tf32 = False

    # -- elementary maps -------------------------------------------------- #
    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.prec.mm(x, self.P[name + ".weight"].t())
        b = self.P.get(name + ".bias")
        return self.prec.act(y if b is None else y + b)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        P = self.P
        w, b = P[name + ".weight"], P[name + ".bias"]
        x2 = x.reshape(-1, x.shape[-1])
        if self.train:
            mean, mean_sq = x2.mean(0), (x2 * x2).mean(0)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
        else:
            mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        y = (x2 - mean) * (torch.rsqrt(var + BN_EPS) * w) + b
        return self.prec.act(y.reshape(x.shape))

    # -- searches and gathers -------------------------------------------- #
    def sq_dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        inner = self.prec.mm(a, b.transpose(-1, -2))
        return (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * inner

    def knn(self, points: torch.Tensor, k: int) -> torch.Tensor:
        with torch.no_grad():
            d = self.sq_dist(points.detach(), points.detach())
            return torch.sort(d, dim=-1, stable=True).indices[..., 1:k + 1]

    def nearest(self, target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.argmin(self.sq_dist(target, source), dim=-1)

    @staticmethod
    def gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        batch = torch.arange(features.shape[0], device=features.device)[:, None, None]
        return features[batch, idx]

    def unit_rf(self, vertices: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        d = self.gather(vertices, idx) - vertices[:, :, None, :]
        return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)

    @staticmethod
    def unit_dirs(directions: torch.Tensor) -> torch.Tensor:
        return directions / torch.clamp(torch.linalg.vector_norm(directions, dim=0,
                                                                 keepdim=True), min=1e-12)

    # -- HS layers --------------------------------------------------------- #
    def orl(self, feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return self.gather(feature, idx).amax(dim=2).mean(dim=1, keepdim=True)

    def finish(self, name: str, feature, orl_idx, f_ste):
        g = self.orl(feature, orl_idx).expand(-1, feature.shape[1], -1)
        feature = self.linear(name + ".conv2", torch.cat([feature, g], -1)) + feature
        return self.prec.act(feature + f_ste)

    def surface(self, name: str, vertices, idx, co: int):
        S = self.arch.support
        f_ste = self.linear(name + ".STE_layer", vertices)
        dirs = self.unit_dirs(self.P[name + ".directions"])
        rf = self.unit_rf(vertices, idx)
        total = 0.0
        for s in range(S):
            theta = torch.relu(self.prec.mm(rf, dirs[:, s * co:(s + 1) * co]))
            total = total + theta.amax(dim=2)
        return self.finish(name, total / S, idx, f_ste)

    def support(self, name: str, vertices, feature_map, rf_idx, orl_idx, co: int):
        P, S = self.P, self.arch.support
        W, b = P[name + ".weights"], P[name + ".bias"]
        f_ste = self.linear(name + ".STE_layer", feature_map)
        center = self.prec.mm(feature_map, W[:, :co]) + b[:co]
        proj = self.prec.mm(feature_map, W[:, co:]) + b[co:]
        dirs = self.unit_dirs(P[name + ".directions"])
        rf = self.unit_rf(vertices, rf_idx)
        total = 0.0
        for s in range(S):
            cols = slice(s * co, (s + 1) * co)
            theta = torch.relu(self.prec.mm(rf, dirs[:, cols]))
            total = total + (theta * self.gather(proj[..., cols], rf_idx)).amax(dim=2)
        return self.finish(name, center + total / S, orl_idx, f_ste)

    def pool(self, vertices, feature_map, pool_idx, sample):
        pooled = self.gather(feature_map, pool_idx[:, sample, :]).amax(dim=2)
        return vertices[:, sample, :], pooled

    # -- the network ---------------------------------------------------- #
    def backbone(self, v: torch.Tensor, obj_id: torch.Tensor, pools: Sequence[torch.Tensor]):
        a = self.arch
        B, N, _ = v.shape
        k = a.k
        fr = "face_recon."
        idx0 = self.knn(v, k)
        fm0 = torch.relu(self.surface(fr + "conv_0", v, idx0, 128))
        rf1 = self.knn(fm0, k)
        fm1 = self.support(fr + "conv_1", v, fm0, rf1, idx0, 128)
        fm1 = torch.relu(self.bn(fr + "bn1", fm1))
        v1, fp1 = self.pool(v, fm1, self.knn(v, 4), pools[0])
        k1 = min(k, v1.shape[1] // 8)
        vidx1 = self.knn(v1, k1)
        fm2 = torch.relu(self.bn(fr + "bn2", self.support(fr + "conv_2", v1, fp1,
                                                           self.knn(fp1, k1), vidx1, 256)))
        fm3 = torch.relu(self.bn(fr + "bn3", self.support(fr + "conv_3", v1, fm2,
                                                           self.knn(fm2, k1), vidx1, 256)))
        v2, fp2 = self.pool(v1, fm3, self.knn(v1, 4), pools[1])
        k2 = min(k, v2.shape[1] // 8)
        fm4 = self.support(fr + "conv_4", v2, fp2, self.knn(fp2, k2), self.knn(v2, k2), 512)
        up1 = self.nearest(v, v1)[..., None]
        up2 = self.nearest(v, v2)[..., None]
        one_hot = F.one_hot(obj_id.long(), a.obj_c).to(v.dtype)[:, None, :].expand(B, N, a.obj_c)
        feat = torch.cat([fm0, fm1, self.gather(fm2, up1)[:, :, 0], self.gather(fm3, up1)[:, :, 0],
                          self.gather(fm4, up2)[:, :, 0], one_hot], dim=-1)
        return feat, fm4

    def mlp(self, name: str, x, hidden: int, final_act: bool):
        for i in range(hidden):
            x = torch.relu(self.bn(f"{name}.bn_{i}", self.linear(f"{name}.dense_{i}", x)))
        x = self.linear(name + ".dense_out", x)
        return torch.relu(self.bn(name + ".bn_out", x)) if final_act else x

    def head(self, name: str, x, keep):
        h = torch.relu(self.bn(name + ".bn1", self.linear(name + ".conv1", x)))
        h = torch.relu(self.bn(name + ".bn2", self.linear(name + ".conv2", h)))
        h = h.amax(dim=1, keepdim=True)
        h = torch.relu(self.bn(name + ".bn3", self.linear(name + ".conv3", h)))[:, 0, :]
        if self.train:
            h = torch.where(keep, h / KEEP_PROB, 0.0)
        return self.linear(name + ".conv4", h)

    def __call__(self, points, obj_id, pools, keep=(None, None, None)):
        """Pose outputs (p_green, p_red, f_green, f_red, T, s) and, in train
        mode, the train heads' (recon, face_normal, face_dis, face_f)."""
        center = points.mean(dim=1, keepdim=True)
        v = points - center
        feat, fm4 = self.backbone(v, obj_id, pools)
        g = self.head("rot_green.vec", feat, keep[0])
        r = self.head("rot_red.vec", feat, keep[1])
        ts = self.head("ts.vec", torch.cat([feat, v], -1), keep[2])
        p_g = g[:, 1:] / (torch.linalg.vector_norm(g[:, 1:], dim=-1, keepdim=True) + 1e-6)
        p_r = r[:, 1:] / (torch.linalg.vector_norm(r[:, 1:], dim=-1, keepdim=True) + 1e-6)
        pose = (p_g, p_r, torch.sigmoid(g[:, 0]), torch.sigmoid(r[:, 0]),
                ts[:, 0:3] + center[:, 0, :], ts[:, 3:6])
        if not self.train:
            return pose, None
        B, N = points.shape[:2]
        fr = "face_recon."
        c1 = self.mlp(fr + "conv1d_block", feat, 2, True)
        recon = self.mlp(fr + "recon_head", c1, 1, False)
        face_in = torch.cat([fm4.amax(dim=1)[:, None, :].expand(B, N, fm4.shape[-1]), c1, v], -1)
        face = self.mlp(fr + "face_head", face_in, 3, False)
        normal = face[..., :18].reshape(B, N, 6, 3)
        normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
        return pose, (recon + center, normal, face[..., 18:24], torch.sigmoid(face[..., 24:]))


@torch.no_grad()
def serve(P: Params, arch: Arch, pc, obj_id, sym, mean_shape, pools,
          prec: Precision | None = None):
    """(RT (B, 4, 4), scales (B, 3)) of a batch of clouds, as the serving
    harness forms them: generate_RT of the heads, pred_s + mean_shape."""
    fwd = Forward(P, arch, False, prec or Precision())
    (p_g, p_r, f_g, f_r, T, s), _ = fwd(pc, obj_id, pools)
    return L.generate_RT(p_g, p_r, f_g, f_r, T, sym), s + mean_shape


# ---- augmentation: copied from hspose_tpu_torch/data/augment.py:55-125 ---- #
AUG = dict(pc_pro=0.2, pc_r=0.2, rt_pro=0.3, bb_pro=0.3, bc_pro=0.3)  # config.py:85-93


def _to_object(R, t, pc):
    return (pc - t[:, None, :]) @ R


def _to_world(R, t, pc):
    return pc @ R.transpose(-1, -2) + t[:, None, :]


@torch.no_grad()
def augment(b: dict, obj_ids, draws):
    """The four gated transforms in order; returns (pc, gt_R, gt_t, gt_s)."""
    flags, ey_up, ey_down, defor = draws
    pc, R, t, s = b["pcl_in"], b["rotation"], b["translation"], b["fsnet_scale"]
    mean_shape, sym, mp = b["mean_shape"], b["sym_info"], b["model_point"]
    # 1. bounding-box rescale
    flag = flags[0] < AUG["bb_pro"]
    aug_bb = b["aug_bb"]
    ex = torch.where((sym[:, 0] == 1)[:, None], (aug_bb + aug_bb[:, [2, 1, 0]]) / 2.0, aug_bb)
    pc = torch.where(flag[..., None], _to_world(R, t, _to_object(R, t, pc) * ex[:, None, :]), pc)
    s = torch.where(flag, (s + mean_shape) * ex - mean_shape, s)
    mp = torch.where(flag[..., None], mp * ex[:, None, :], mp)
    # 2. rigid perturbation
    flag = flags[1] < AUG["rt_pro"]
    rt_t, rt_r = b["aug_rt_t"], b["aug_rt_R"]
    pc = torch.where(flag[..., None], (pc + rt_t[:, None, :]) @ rt_r.transpose(-1, -2), pc)
    R_new, t_new = rt_r @ R, (rt_r @ (t + rt_t)[..., None])[..., 0]
    R = torch.where(flag[..., None], R_new, R)
    t = torch.where(flag, t_new, t)
    # 3. box-cage taper, bowls (1) and mugs (5) only
    flag = (flags[2] < AUG["bc_pro"]) & ((obj_ids == 5) | (obj_ids == 1))[:, None]
    full = s + mean_shape
    s_y = full[:, 1:2]
    po = _to_object(R, t, pc)
    per = (po[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    pc_new = _to_world(R, t, torch.stack([po[..., 0] * per, po[..., 1], po[..., 2] * per], -1))
    mres = (mp[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    mp2 = torch.stack([mp[..., 0] * mres, mp[..., 1], mp[..., 2] * mres], dim=-1)
    s_new = (mp2.amax(1) - mp2.amin(1)) * b["nocs_scale"][:, None]
    pc = torch.where(flag[..., None], pc_new, pc)
    s = torch.where(flag, s_new - mean_shape, s)
    # 4. per-point jitter
    flag = flags[3] < AUG["pc_pro"]
    pc = torch.where(flag[..., None], pc + defor * AUG["pc_r"] * (pc - t[:, None, :]), pc)
    return pc, R, t, s


def train_loss(P: Params, arch: Arch, batch: dict, draws, prec: Precision | None = None):
    """The total loss of one train forward (``models/hspose.py::
    train_forward`` and ``compute_losses``, :136-195, :212-269): augment,
    forward in train mode, the four families summed.  ``draws`` is
    (aug (flags, ey_up, ey_down, defor), pool samples, keep masks)."""
    aug, pools, keep = draws
    obj_id = batch["cat_id"].to(torch.int64)
    pc, gt_R, gt_t, gt_s = augment(batch, obj_id, aug)
    fwd = Forward(P, arch, True, prec or Precision())
    (p_g, p_r, f_g, f_r, T, s), (recon, normal, dis, face_f) = fwd(pc, obj_id, pools, keep)
    mean_shape, sym = batch["mean_shape"], batch["sym_info"]
    W = L.LossWeights
    fs, rc, geo, prop = L.control_loss("PoseNet_only")
    gt_g, gt_r = L.get_gt_v(gt_R)
    fg_d, fr_d = f_g.detach(), f_r.detach()
    terms = {}
    terms.update(L.fs_net_loss(W, fs, {"Rot1": p_g, "Rot1_f": f_g, "Rot2": p_r, "Rot2_f": f_r,
                                       "Recon": recon, "Tran": T, "Size": s},
                               {"Rot1": gt_g, "Rot2": gt_r, "Recon": pc, "Tran": gt_t,
                                "Size": gt_s}, sym))
    terms.update({"prop/" + k: v for k, v in L.prop_rot_loss(
        W, prop, {"Recon": recon, "Rot1": p_g, "Rot2": p_r, "Tran": T, "Scale": s,
                  "Rot1_f": fg_d, "Rot2_f": fr_d},
        {"Points": pc, "R": gt_R, "T": gt_t, "Mean_shape": mean_shape}, sym).items()})
    terms.update({"recon/" + k: v for k, v in L.recon_6face_loss(
        W, rc, {"F_n": normal, "F_d": dis, "F_c": face_f, "Rot1": p_g, "Rot1_f": fg_d,
                "Rot2": p_r, "Rot2_f": fr_d, "Tran": T, "Size": s},
        {"R": gt_R, "T": gt_t, "Size": gt_s, "Mean_shape": mean_shape, "Points": pc},
        sym, obj_id).items()})
    terms.update(L.geo_transform_loss(W, geo, {"Rot1": p_g, "Rot2": p_r, "Tran": T, "Size": s,
                                               "Rot1_f": fg_d, "Rot2_f": fr_d},
                                      {"Points": pc, "R": gt_R, "T": gt_t,
                                       "Mean_shape": mean_shape}, sym))
    return sum(terms.values()), terms


# ---- Ranger: copied from hspose_tpu_torch/engine/optimizer.py:57-124 and the
# schedule from engine/schedule.py:16-29, :73-90, per tensor ---------------- #
OPTIM = dict(lr=1e-4, lr_pose=1.0, warmup_iters=1000, warmup_factor=1e-3, betas=(0.95, 0.999),
             eps=1e-5, n_sma_threshold=5, lookahead_k=6, lookahead_alpha=0.5,
             clip_grad_norm=5.0, train_steps=1500, total_epoch=150)  # config.py:127-140, 146-149


def learning_rate(count: int) -> float:
    """flat_and_anneal's warm-up (the first 1000 steps) in float32."""
    o, f32 = OPTIM, torch.float32
    if count >= o["warmup_iters"]:
        raise ValueError("the reference follows the warm-up steps only")
    alpha = torch.tensor(count, dtype=f32) / torch.tensor(o["warmup_iters"], dtype=f32)
    f = torch.tensor(o["warmup_factor"], dtype=f32) * (1 - alpha) + alpha
    return float(torch.tensor(o["lr"] * o["lr_pose"], dtype=f32) * f)


class Ranger:
    """clip(5) -> gradient centralisation -> RAdam -> -lr(t) -> lookahead."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.slow = [p.detach().clone() for p in self.params]
        self.count = 0
        self.last_grads: list[torch.Tensor] = []

    def _scalars(self, t: int):
        b1, b2 = OPTIM["betas"]
        tt = torch.tensor(float(t), dtype=torch.float32)
        one_minus_b2t = -torch.expm1(tt * math.log(b2))
        beta2_t = 1.0 - one_minus_b2t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * tt * beta2_t / one_minus_b2t
        rect = torch.sqrt(one_minus_b2t * (n_sma - 4.0) / (n_sma_max - 4.0)
                          * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0))
        bias1 = -torch.expm1(tt * math.log(b1))
        adaptive = bool(n_sma > OPTIM["n_sma_threshold"])
        return float(rect / bias1 if adaptive else 1.0 / bias1), adaptive

    @torch.no_grad()
    def step(self) -> None:
        o = OPTIM
        b1, b2 = o["betas"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        if bool(norm >= o["clip_grad_norm"]):
            grads = [g / norm * o["clip_grad_norm"] for g in grads]
        grads = [g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True) if g.dim() >= 2 else g
                 for g in grads]
        self.last_grads = grads
        lr = learning_rate(self.count)
        self.count += 1
        step_size, adaptive = self._scalars(self.count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.m[i].mul_(b1).add_(g * (1 - b1))
            self.v[i].mul_(b2).add_(g * (1 - b2) * g)
            d = self.m[i] / (self.v[i].sqrt() + o["eps"]) if adaptive else self.m[i]
            u = d * step_size * -lr
            if self.count % o["lookahead_k"] == 0:
                new_slow = self.slow[i] + ((p + u) - self.slow[i]) * o["lookahead_alpha"]
                u = new_slow - p
                self.slow[i].copy_(new_slow)
            p.add_(u)
