"""Training sanity check of the port: learn poses of synthetic box clouds
(a copy of ``scripts/train_sanity.py`` on the port's entry points, with the
same data, recipe and pass bar).

Generates camera-frame point clouds of boxes with random rotations,
translations and sizes, runs the port's train step (``engine/train_step.py::
build_train_step``) for ``steps`` iterations, and reports the pose error of
the eval path (``models/hspose.py::eval_forward``, ``geometry/rotations.py::
generate_RT``) on 32 held-out crops before and after.  Pass: rotation and
translation errors both below half of their values at init: evidence that
the loss stack and the optimizer teach the network pose on the chosen
training route.

Recipe (the JAX script's): lr 3e-4 * B / 16 with 100 warm-up steps; the
batches and the eval crops from ``numpy.random.default_rng(seed)`` (the 32
eval crops first), the initial weights from ``torch.manual_seed(seed)``, the
step's draws from a generator seeded ``seed + 1``, the eval's pooling from a
generator seeded 7 (the same pools before and after).  ``--anneal`` scopes
the flat-and-anneal schedule to the run.  ``--set section.key=value``
(repeatable) overrides the config last; it chooses the training route:
``model.compute_dtype``, ``model.bwd_store``, ``model.train_v4_small``.
The eval runs the train model in eval mode (running BatchNorm statistics,
the serving kernels of its ``compute_dtype``) and puts it back in train mode.

Run on the card:
  python hspose_tpu_torch/tools/train_sanity.py [steps] [--batch B] [--bf16]
      [--anneal] [--seed S] [--set section.key=value ...] [--json FILE]

Prints the errors before and after, the loss every 50 steps, steps/s, the
card's ``nvidia-smi --query-gpu=name,power.limit`` line, and ``SANITY PASS``
or ``SANITY FAIL``; the exit code is 0 on a pass, else 1.  ``--json`` also
writes these numbers to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from hspose_tpu_torch.tools.convergence_artifact import card  # noqa: E402

MEAN_SHAPE = np.array([0.12, 0.18, 0.12], np.float32)
EVAL_CROPS = 32  # held-out crops of the before / after errors
EVAL_POOL_SEED = 7  # the eval's pooling generator (the JAX script's key 7)
PASS_SHARE = 0.5  # rotation and translation errors must fall below this share of init


def random_rotations(rng, n):
    A = rng.normal(size=(n, 3, 3))
    Q, _ = np.linalg.qr(A)
    det = np.linalg.det(Q)
    Q[det < 0, :, 0] *= -1
    return Q.astype(np.float32)


def upright_rotations(rng, n, max_tilt_deg=40.0):
    """Tabletop-like rotations: free azimuth about y, then a tilt of
    U(0, max_tilt) about a random horizontal axis.  Under full SO(3) a
    y-symmetric box's y-axis SIGN is unlearnable from a uniform surface cloud
    (the 180-deg flip maps the distribution onto itself), which floors the
    mean rotation error ~20 deg; the upright prior removes the ambiguity so a
    trained probe model can put real mass in the 5-deg metric bins."""
    out = np.empty((n, 3, 3), np.float32)
    for i in range(n):
        yaw = rng.uniform(0, 2 * np.pi)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        tilt = np.deg2rad(rng.uniform(0, max_tilt_deg))
        phi = rng.uniform(0, 2 * np.pi)
        ax = np.array([np.cos(phi), 0.0, np.sin(phi)])
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                      [-ax[1], ax[0], 0]])
        out[i] = np.eye(3) + np.sin(tilt) * K + (1 - np.cos(tilt)) * (K @ K)
        out[i] = out[i] @ Ry
    return out


def make_batch(rng, bs, n_pts, mean_shape, easy=False):
    """Box-surface clouds in the camera frame with full gt labels: the 12
    keys the train step takes.

    ``easy=True`` draws upright-ish rotations (see upright_rotations) —
    the distribution used to train the tier-parity probe model to 5-deg-bin
    accuracy."""
    R = upright_rotations(rng, bs) if easy else random_rotations(rng, bs)
    t = np.stack([rng.uniform(-0.2, 0.2, bs), rng.uniform(-0.2, 0.2, bs),
                  rng.uniform(0.5, 0.9, bs)], -1).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, (bs, 3)).astype(np.float32) * mean_shape[None]

    # sample points on box surfaces (object frame), transform to camera frame
    face = rng.integers(0, 6, (bs, n_pts))
    uv = rng.uniform(-0.5, 0.5, (bs, n_pts, 2)).astype(np.float32)
    pts = np.zeros((bs, n_pts, 3), np.float32)
    axis = face % 3
    sign = np.where(face < 3, 0.5, -0.5).astype(np.float32)
    for b in range(bs):
        for a in range(3):
            m = axis[b] == a
            others = [i for i in range(3) if i != a]
            pts[b, m, a] = sign[b, m]
            pts[b, m, others[0]] = uv[b, m, 0]
            pts[b, m, others[1]] = uv[b, m, 1]
    pts *= scale[:, None, :]
    cam = np.einsum("bij,bnj->bni", R, pts) + t[:, None, :]

    model_point = pts[:, :1024] / np.linalg.norm(scale, axis=-1)[:, None, None]
    nocs_scale = np.linalg.norm(scale, axis=-1).astype(np.float32)

    bb = rng.uniform(0.9, 1.1, (bs, 3)).astype(np.float32)
    rt_t = rng.normal(scale=0.002, size=(bs, 3)).astype(np.float32)
    rt_R = np.tile(np.eye(3, dtype=np.float32), (bs, 1, 1))
    return {
        "pcl_in": cam,
        "cat_id": np.full(bs, 3.0, np.float32),  # 'can' slot (sym) — half get laptop
        "rotation": R,
        "translation": t,
        "fsnet_scale": (scale - mean_shape[None]).astype(np.float32),
        "mean_shape": np.tile(mean_shape[None], (bs, 1)).astype(np.float32),
        "sym_info": np.tile(np.array([[0, 1, 0, 0]], np.float32), (bs, 1)),
        "aug_bb": bb, "aug_rt_t": rt_t, "aug_rt_R": rt_R,
        "model_point": model_point.astype(np.float32),
        "nocs_scale": nocs_scale,
    }


def forward_poses(model, batch, pool_samples):
    """(RT (B, 4, 4), pred_s (B, 3)) as float32 numpy: ``eval_forward`` and
    ``generate_RT`` on the batch's clouds, with the given pooling samples.
    A model in train mode is put in eval mode for the forward (running
    BatchNorm statistics) and back in train mode after."""
    import torch

    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    device = next(model.parameters()).device
    training = model.training
    model.eval()
    try:
        out = eval_forward(model, torch.as_tensor(batch["pcl_in"], device=device),
                           torch.as_tensor(batch["cat_id"].astype(np.int32), device=device),
                           pool_samples=[s.to(device) for s in pool_samples])
        RT = generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R, out.pred_T,
                         torch.as_tensor(batch["sym_info"], device=device))
        return RT.float().cpu().numpy(), out.pred_s.float().cpu().numpy()
    finally:
        model.train(training)


def errors_of(RT, pred_s, batch):
    """Mean y-axis degrees, mean cm and mean size error of poses against
    the batch's ground truth (the JAX script's ``pose_errors`` numbers)."""
    R_pred = RT[:, :3, :3]
    t_pred = RT[:, :3, 3]
    R_gt = batch["rotation"]
    # y-axis angular error (symmetric class)
    y_p = R_pred[:, :, 1]
    y_g = R_gt[:, :, 1]
    cosv = np.clip(np.sum(y_p * y_g, -1), -1, 1)
    deg = np.degrees(np.arccos(cosv))
    cm = np.linalg.norm(t_pred - batch["translation"], axis=-1) * 100
    s_err = np.abs(np.asarray(pred_s) - batch["fsnet_scale"]).mean()
    return float(np.mean(deg)), float(np.mean(cm)), float(s_err)


def pose_errors(model, batch, generator):
    """Mean y-axis degrees, mean cm and mean size error of ``model``'s eval
    forward on ``batch``, its pooling drawn from ``generator``."""
    from hspose_tpu_torch.models.hspose import draw_pool_samples

    samples = draw_pool_samples(batch["pcl_in"].shape[1], generator)
    return errors_of(*forward_poses(model, batch, samples), batch)


def sanity_config(steps, batch_size=16, dtype="float32", overrides=(), anneal=False):
    """The JAX script's recipe on the port's config, then ``overrides``
    (``section.key=value`` strings)."""
    from hspose_tpu_torch.config import HSPoseConfig, parse_overrides

    cfg = HSPoseConfig()
    # linear-scaled LR for larger batches (sqrt measured WORSE at batch 64:
    # rot 62° vs 47° — the bottleneck is total parameter motion, not gradient
    # noise).  Large-batch runs additionally want --anneal: the flat schedule
    # leaves the late loss bouncing at 1.2e-3, exactly what the real recipe's
    # anneal phase is for.
    lr = 3e-4 * batch_size / 16
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, warmup_iters=100, lr=lr))
    if anneal:
        # scope the flat_and_anneal schedule to this run (anneal from 72%)
        # instead of the production 225k-iter horizon it never reaches
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, train_steps=steps,
                                                    total_epoch=1))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    return parse_overrides(list(overrides), cfg)


def build_trainer(cfg, seed, device=None):
    """(model, step): the train model with weights from
    ``torch.manual_seed(seed)`` and its train step, whose draws come from a
    generator seeded ``seed + 1`` on the model's device."""
    import torch

    from hspose_tpu_torch.engine.train_step import build_train_step
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(seed)
    model = build_model(cfg.model, device=device, train_heads=True)
    device = next(model.parameters()).device
    step = build_train_step(cfg, model, torch.Generator(device=device).manual_seed(seed + 1))
    return model, step


def train_steps(step, rng, steps, batch_size, n_pts, device, easy=False, log_every=50,
                log=print):
    """``steps`` steps on fresh ``make_batch`` batches; returns the logged
    (step, total loss) pairs and the number of NaN-skipped steps."""
    from hspose_tpu_torch.engine.train_step import to_device

    losses, skipped = [], 0
    for i in range(steps):
        batch = to_device(make_batch(rng, batch_size, n_pts, MEAN_SHAPE, easy=easy), device)
        metrics = step(batch)
        skipped += int(metrics["skipped_nan"])
        if i % log_every == 0:
            losses.append((i, metrics["total_loss"]))
            log(f"step {i}: loss {metrics['total_loss']:.3f}")
    return losses, skipped


def main(steps=300, batch_size=16, dtype="float32", overrides=(), anneal=False, seed=0,
         device=None, json_path=None):
    """Train ``steps`` steps and compare the eval errors with init.  Returns
    the record (errors before and after, steps/s, the card, ``"pass"``)."""
    import torch

    def log(msg):
        print(msg, flush=True)

    cfg = sanity_config(steps, batch_size, dtype, overrides, anneal)
    m = cfg.model
    log(f"sanity config: steps={steps} batch={batch_size} lr={cfg.optim.lr:.1e} "
        f"dtype={m.compute_dtype} bwd_store={m.bwd_store} train_v4_small={m.train_v4_small} "
        f"seed={seed} overrides={list(overrides)}")
    model, step = build_trainer(cfg, seed, device)
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    n_pts = cfg.data.num_points
    eval_batch = make_batch(rng, EVAL_CROPS, n_pts, MEAN_SHAPE)

    def errors():
        return pose_errors(model, eval_batch,
                           torch.Generator(device=device).manual_seed(EVAL_POOL_SEED))

    deg0, cm0, s0 = errors()
    log(f"before: rot {deg0:.1f} deg | trans {cm0:.1f} cm | size {s0:.3f}")

    t0 = time.perf_counter()
    losses, skipped = train_steps(step, rng, steps, batch_size, n_pts, device, log=log)
    train_s = time.perf_counter() - t0
    rate = steps / train_s if train_s > 0 else float("nan")
    log(f"{steps} steps in {train_s:.1f}s: {rate:.3f} steps/s ({skipped} skipped as NaN)")

    deg1, cm1, s1 = errors()
    log(f"after:  rot {deg1:.1f} deg | trans {cm1:.1f} cm | size {s1:.3f}")
    smi = card()
    log(f"card: {smi}")
    ok = deg1 < deg0 * PASS_SHARE and cm1 < cm0 * PASS_SHARE
    record = {"steps": steps, "batch_size": batch_size, "seed": seed, "anneal": anneal,
              "overrides": list(overrides), "lr": cfg.optim.lr,
              "route": {"compute_dtype": m.compute_dtype, "bwd_store": m.bwd_store,
                        "train_v4_small": m.train_v4_small},
              "before": {"rot_deg": deg0, "trans_cm": cm0, "size": s0},
              "after": {"rot_deg": deg1, "trans_cm": cm1, "size": s1},
              "train_s": train_s, "steps_per_s": rate, "skipped_nan": skipped,
              "losses": losses, "card": smi, "device": str(device), "pass": ok}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(record, f, indent=1)
    log(f"SANITY {'PASS' if ok else 'FAIL'}")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bf16", action="store_true", help="model.compute_dtype=bfloat16")
    ap.add_argument("--anneal", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="section.key=value")
    ap.add_argument("--json", default=None, help="also write the record here")
    a = ap.parse_args()
    rec = main(a.steps, a.batch, "bfloat16" if a.bf16 else "float32", a.overrides, a.anneal,
               a.seed, json_path=a.json)
    sys.exit(0 if rec["pass"] else 1)
# NB: RAdam's rectified step sizes stay tiny for the first ~1k steps; short runs
# show rotation learning first while the residual T/s heads transiently drift.
