"""Fast-tier accuracy parity of the port on a TRAINED model: the mAP-level
evidence (a copy of ``scripts/fast_mode_parity.py`` on the port's entry
points, with one gate added).

Trains the synthetic-box pose task (the harness of ``train_sanity.py``),
then serves held-out clouds with the same weights in several tiers and
reports:

(a) a quick screen on 64 crops: each of fp32 and bf16's pose errors, the
    per-crop deviation between the two tiers' predictions and how many
    crops change a 5/10/20 deg or 2/5 cm bin;
(b) **mAP resolution**: 1024 held-out crops through each tier and the port's
    ``evaluation/metrics.py::compute_degree_cm_mAP`` (4 crops an image, the
    full 61x21 degree/shift and 101-point IoU grids, ``use_matches_for_pose``,
    as the eval harness runs REAL275): every headline metric (IoU25/50/75,
    5°2cm … 10°10cm) of a gated tier must lie within **0.3 points** of fp32's.

Tiers: fp32 (the reference), bf16 (gated); with ``--easy`` also bf16 +
``serve_k=16`` (gated), bf16 + ``serve_k=12`` and fp32 + ``serve_k=16``
(printed only; the last parts the relaxed search's cost from bf16's).  The
JAX script only prints ``serve_k=16``'s result; here it is part of the gate.
Its ``f32x2`` tier and ``serve_rf_reuse`` are not ported (TPU workarounds),
so they are left out.

``--easy`` trains the probe model on upright poses in bf16 at B=24 with the
schedule scoped to the run (the JAX script's recipe), and also requires the
5°2cm bin to hold at least 60% of the study's ceiling (IoU25: every crop is
one class, so the class-mean AP tops out at 100/6): a tier delta there must
rest on real mass.  Without it: fp32 at B=16 on the full-SO(3) task.

Randomness: initial weights from ``torch.manual_seed(seed)``, training
batches from ``numpy.random.default_rng(seed)``, the step's draws from a
generator seeded ``seed + 1`` (``--seed``, default 0: the JAX script's
keys 0 and 1 and its ``default_rng(0)``); held-out crops from
``default_rng(123)`` (64-crop screen, pools from seed 7) and
``default_rng(123)`` again for the 1024 crops, in batches of 256 whose pools
come from a generator seeded ``1000 + start``; the score of each detection
from ``default_rng(7)``.  Generators lie on the model's device unless
``predict`` is told otherwise.

Run on the card:
  python hspose_tpu_torch/tools/fast_mode_parity.py [train_steps] [--easy] [--seed S]
      [--json FILE]

Ends with ``FAST-MODE PARITY PASS`` or ``FAIL`` (exit code 0 or 1) and
writes every table, each tier's worst |delta|, the 5°2cm mass, the train
wall time and steps/s and the card's line to ``--json`` (default
``build/probes/fast_mode_parity.json`` under the repository).
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
from hspose_tpu_torch.tools.train_sanity import (  # noqa: E402
    MEAN_SHAPE,
    build_trainer,
    errors_of,
    forward_poses,
    make_batch,
    train_steps,
)

HEADLINE_BUDGET_PTS = 0.3
MASS_BAR_PCT = 60.0  # --easy: 5d2cm AP as a share of the study's ceiling
N_PTS = 1028  # points per crop (cfg.data.num_points)
N_CROPS, EVAL_BS = 1024, 256  # the mAP study's held-out crops and serving batch
# (name, ModelConfig fields over the default, gated): the tiers of the 1024-crop
# study; the first is the reference, the --easy ones come after "bf16"
TIERS = [("fp32", {}, False), ("bf16", {"compute_dtype": "bfloat16"}, True)]
EASY_TIERS = [("bf16+k16", {"compute_dtype": "bfloat16", "serve_k": 16}, True),
              ("bf16+k12", {"compute_dtype": "bfloat16", "serve_k": 12}, False),
              ("fp32+k16", {"serve_k": 16}, False)]


def held_out(n_crops=None, eval_bs=None, seed=123, easy=False):
    """The held-out batches of ``eval_bs`` crops (default ``EVAL_BS``) out
    of ``n_crops`` (default ``N_CROPS``), drawn in order from one
    ``default_rng(seed)`` (the JAX ``map_table``'s crops)."""
    n_crops, eval_bs = n_crops or N_CROPS, eval_bs or EVAL_BS
    rng = np.random.default_rng(seed)
    return [make_batch(rng, eval_bs, N_PTS, MEAN_SHAPE, easy=easy)
            for _ in range(0, n_crops, eval_bs)]


def predict(model, batches, pool_device=None):
    """[(RT (bs, 4, 4), pred_s (bs, 3)), ...] as float32 numpy, one entry a
    batch: ``eval_forward`` + ``generate_RT`` with the pools of each batch
    drawn from a generator seeded ``1000 + start`` (its first crop's index,
    the JAX ``map_table``'s key) on ``pool_device`` (default: the model's)."""
    import torch

    from hspose_tpu_torch.models.hspose import draw_pool_samples

    if pool_device is None:
        pool_device = next(model.parameters()).device
    preds, start = [], 0
    for batch in batches:
        gen = torch.Generator(device=pool_device).manual_seed(1000 + start)
        samples = draw_pool_samples(batch["pcl_in"].shape[1], gen)
        preds.append(forward_poses(model, batch, samples))
        start += len(batch["pcl_in"])
    return preds


def assemble(batches, preds, crops_per_image=4):
    """The headline table (points) of predictions against the batches' ground
    truth: ``crops_per_image`` crops an image, each detection's score drawn
    from ``default_rng(7)`` in order, through ``compute_degree_cm_mAP`` with
    the eval harness's threshold grids."""
    from hspose_tpu_torch.evaluation.metrics import compute_degree_cm_mAP
    from hspose_tpu_torch.geometry.symmetry import SYNSET_NAMES

    score_rng = np.random.default_rng(7)
    results = []
    for batch, (RT, s) in zip(batches, preds):
        bs = len(batch["pcl_in"])
        RT = np.asarray(RT, np.float64)
        pred_scales = np.asarray(s, np.float64) + MEAN_SHAPE[None]
        gt_scales = batch["fsnet_scale"] + MEAN_SHAPE[None]
        gt_RT = np.tile(np.eye(4)[None], (bs, 1, 1))
        gt_RT[:, :3, :3] = batch["rotation"]
        gt_RT[:, :3, 3] = batch["translation"]
        cls = batch["cat_id"].astype(np.int32) + 1  # synset ids are 1-based
        for j in range(0, bs, crops_per_image):
            sl = slice(j, j + crops_per_image)
            n = crops_per_image
            results.append({
                "gt_class_ids": cls[sl],
                "gt_RTs": gt_RT[sl],
                "gt_scales": gt_scales[sl],
                "gt_handle_visibility": np.ones(n),
                "pred_class_ids": cls[sl],
                "pred_RTs": RT[sl],
                "pred_scales": pred_scales[sl],
                "pred_scores": score_rng.uniform(0.5, 1.0, n),
            })

    degree_thres_list = list(range(0, 61, 1))
    shift_thres_list = [i / 2 for i in range(21)]
    iou_thres_list = [i / 100 for i in range(101)]
    iou_aps, pose_aps = compute_degree_cm_mAP(
        results, SYNSET_NAMES, None, degree_thres_list, shift_thres_list,
        iou_thres_list, iou_pose_thres=0.1, use_matches_for_pose=True)
    full_deg = degree_thres_list + [360]
    full_shift = shift_thres_list + [100]
    return {
        "IoU25": iou_aps[-1, iou_thres_list.index(0.25)] * 100,
        "IoU50": iou_aps[-1, iou_thres_list.index(0.5)] * 100,
        "IoU75": iou_aps[-1, iou_thres_list.index(0.75)] * 100,
        "5d2cm": pose_aps[-1, full_deg.index(5), full_shift.index(2)] * 100,
        "5d5cm": pose_aps[-1, full_deg.index(5), full_shift.index(5)] * 100,
        "10d2cm": pose_aps[-1, full_deg.index(10), full_shift.index(2)] * 100,
        "10d5cm": pose_aps[-1, full_deg.index(10), full_shift.index(5)] * 100,
        "10d10cm": pose_aps[-1, full_deg.index(10), full_shift.index(10)] * 100,
    }


def serving_model(model_cfg, state, device):
    """A serving model of ``model_cfg`` holding the trained ``state``."""
    from hspose_tpu_torch.models.hspose import build_model

    model = build_model(model_cfg, device=device)
    own = model.state_dict()
    missing = sorted(own.keys() - state.keys())
    if missing:
        raise KeyError(f"the trained state lacks {missing[:5]}")
    model.load_state_dict({k: state[k] for k in own})
    return model


def quick_screen(models, device, easy, log):
    """Phase (a): 64 held-out crops through fp32 and bf16."""
    import torch

    from hspose_tpu_torch.models.hspose import draw_pool_samples

    held = make_batch(np.random.default_rng(123), 64, N_PTS, MEAN_SHAPE, easy=easy)
    errs, rts = {}, {}
    for name in ("fp32", "bf16"):
        samples = draw_pool_samples(N_PTS, torch.Generator(device=device).manual_seed(7))
        RT, s = forward_poses(models[name], held, samples)
        errs[name] = errors_of(RT, s, held)
        rts[name] = (RT, s)
        deg, cm, s_err = errs[name]
        log(f"{name:10s}: rot {deg:.2f} deg | trans {cm:.2f} cm | size {s_err:.4f}")

    (RT_a, s_a), (RT_b, s_b) = rts["fp32"], rts["bf16"]
    y_a, y_b = RT_a[:, :3, 1], RT_b[:, :3, 1]
    ang = np.degrees(np.arccos(np.clip(np.sum(y_a * y_b, -1)
                                       / (np.linalg.norm(y_a, axis=-1)
                                          * np.linalg.norm(y_b, axis=-1)), -1, 1)))
    dt = np.linalg.norm(RT_a[:, :3, 3] - RT_b[:, :3, 3], axis=-1) * 100
    ds = np.abs(s_a - s_b).max()
    log(f"tier-vs-tier axis deg: p50 {np.percentile(ang, 50):.3f} | p95 "
        f"{np.percentile(ang, 95):.3f} | max {ang.max():.3f}")
    log(f"tier-vs-tier: trans {np.percentile(dt, 95):.3f} cm p95 ({dt.max():.3f} max) | "
        f"size {ds:.5f} max")

    # per-threshold accuracy agreement: whether any metric BIN moves, not
    # whether two noisy axis estimates coincide
    n = len(held["rotation"])
    R_gt, t_gt = held["rotation"], held["translation"]

    def bin_accs(RT):
        y_p = RT[:, :3, 1] / np.linalg.norm(RT[:, :3, 1], axis=-1, keepdims=True)
        deg = np.degrees(np.arccos(np.clip(np.sum(y_p * R_gt[:, :, 1], -1), -1, 1)))
        cm = np.linalg.norm(RT[:, :3, 3] - t_gt, axis=-1) * 100
        return {f"{d}deg": float((deg < d).mean()) for d in (5, 10, 20)} | \
               {f"{c}cm": float((cm < c).mean()) for c in (2, 5)}

    accs_a, accs_b = bin_accs(RT_a), bin_accs(RT_b)
    worst = 0.0
    for k in accs_a:
        delta = abs(accs_a[k] - accs_b[k])
        worst = max(worst, delta)
        log(f"acc@{k:6s}: fp32 {accs_a[k]*100:5.1f}% | bf16 {accs_b[k]*100:5.1f}% | "
            f"delta {delta*100:.1f} pts")
    (da, dc, _), (db, dcb, _) = errs["fp32"], errs["bf16"]
    # <= 2 crops flipping any bin (2/64 = 3.2 pts) + aggregate agreement
    ok = bool(worst <= 2.0 / n + 1e-9 and abs(da - db) < 0.5 and abs(dc - dcb) < 0.1)
    log(f"quick 64-crop screen: {'PASS' if ok else 'FAIL'}")
    return ok, {"errors": errs, "bins": {"fp32": accs_a, "bf16": accs_b},
                "axis_deg_p50_p95_max": [float(np.percentile(ang, 50)),
                                         float(np.percentile(ang, 95)), float(ang.max())],
                "trans_cm_p95_max": [float(np.percentile(dt, 95)), float(dt.max())],
                "size_max": float(ds), "worst_bin": worst, "pass": ok}


def main(steps=2500, easy=False, device=None, json_path=None, seed=0):
    """Train the probe model, then screen and tabulate the tiers.  Returns
    the record (tables, worst deltas, mass, train rate, card, ``"pass"``)."""
    import torch

    from hspose_tpu_torch.config import HSPoseConfig

    def log(msg):
        print(msg, flush=True)

    cfg = HSPoseConfig()
    # --easy: the probe model needs real mass in the 5-deg/2cm bins for the
    # tier study to test anything there: upright poses + the bf16 batch-24
    # anneal recipe, longer schedule
    train_bs = 24 if easy else 16
    lr = 3e-4 * train_bs / 16
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, warmup_iters=100, lr=lr))
    if easy:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, train_steps=steps,
                                                    total_epoch=1, batch_size=train_bs))
    train_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16" if easy else "float32"))
    log(f"probe training: steps={steps} batch={train_bs} lr={lr:.1e} "
        f"dtype={train_cfg.model.compute_dtype} easy={easy} seed={seed}")

    model, step = build_trainer(train_cfg, seed, device)
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    losses, skipped = train_steps(step, np.random.default_rng(seed), steps, train_bs, N_PTS,
                                  device, easy=easy, log_every=500, log=log)
    train_s = time.perf_counter() - t0
    rate = steps / train_s if train_s > 0 else float("nan")
    log(f"{steps} steps in {train_s:.1f}s: {rate:.3f} steps/s ({skipped} skipped as NaN)")
    state = {k: v.detach() for k, v in model.state_dict().items()}
    del model, step

    tiers = TIERS + (EASY_TIERS if easy else [])
    models = {name: serving_model(dataclasses.replace(cfg.model, **fields), state, device)
              for name, fields, _ in tiers}
    ok, screen = quick_screen(models, device, easy, log)

    log(f"mAP-resolution study ({N_CROPS} crops in batches of {EVAL_BS} x {len(tiers)} "
        f"tiers) ...")
    batches = held_out(easy=easy)
    tables, serve_s = {}, {}
    for name, _, _ in tiers:
        t1 = time.perf_counter()
        tables[name] = assemble(batches, predict(models[name], batches))
        serve_s[name] = time.perf_counter() - t1
    ref = tables[tiers[0][0]]
    worst_by = {name: max(abs(ref[k] - tables[name][k]) for k in ref) for name, _, _ in tiers[1:]}
    log(f"{'metric':>8s} | " + " | ".join(f"{n:>9s}" for n, _, _ in tiers))
    for k in ref:
        log(f"{k:>8s} | " + " | ".join(f"{tables[n][k]:9.2f}" for n, _, _ in tiers))
    gated = [name for name, _, g in tiers if g]
    for name, _, g in tiers[1:]:
        d = worst_by[name]
        log(f"tier {name}: worst |delta| {d:.3f} pts "
            f"({'inside' if d <= HEADLINE_BUDGET_PTS else 'OUTSIDE'} the "
            f"{HEADLINE_BUDGET_PTS}-pt budget; {'gated' if g else 'printed only'})")
    map_ok = bool(all(worst_by[name] <= HEADLINE_BUDGET_PTS for name in gated))
    log(f"worst gated headline delta: {max(worst_by[n] for n in gated):.3f} pts "
        f"(budget {HEADLINE_BUDGET_PTS}; gated: {', '.join(gated)})")
    mass = None
    if easy:
        # the study populates ONE class (make_batch labels every crop 'can'),
        # so the 6-class-mean AP is capped at 100/6: measure the 5d2cm mass
        # RELATIVE to the study's own ceiling (IoU25, which every crop of a
        # trained model reaches)
        ceiling = max(ref["IoU25"], 1e-9)
        mass = ref["5d2cm"] / ceiling * 100.0
        mass_ok = bool(mass >= MASS_BAR_PCT)
        log(f"5d2cm mass: {ref['5d2cm']:.2f} AP = {mass:.0f}% of the study ceiling "
            f"{ceiling:.2f} ({'OK' if mass_ok else f'BELOW the {MASS_BAR_PCT:.0f}% bar'})")
        map_ok = map_ok and mass_ok
    smi = card()
    log(f"card: {smi}")
    passed = ok and map_ok
    record = {"steps": steps, "easy": easy, "seed": seed, "train_batch": train_bs, "lr": lr,
              "train_dtype": train_cfg.model.compute_dtype, "train_s": train_s,
              "steps_per_s": rate, "skipped_nan": skipped, "losses": losses,
              "screen": screen, "tables": tables, "worst_delta": worst_by, "gated": gated,
              "budget_pts": HEADLINE_BUDGET_PTS, "mass_5d2cm_pct": mass,
              "n_crops": N_CROPS, "eval_bs": EVAL_BS, "serve_s": serve_s, "card": smi,
              "device": str(device), "map_ok": map_ok, "pass": passed}
    json_path = json_path or os.path.join(ROOT, "build", "probes", "fast_mode_parity.json")
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(record, f, indent=1)
    log(f"record: {json_path}")
    log(f"FAST-MODE PARITY {'PASS' if passed else 'FAIL'}")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=2500)
    ap.add_argument("--easy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    sys.exit(0 if main(a.steps, a.easy, json_path=a.json, seed=a.seed)["pass"] else 1)
