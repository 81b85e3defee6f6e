"""Generate a *rendered* synthetic NOCS-format dataset tree (a copy of
``scripts/make_synth_nocs.py`` without JAX and without cv2: the machine
with the card has neither).  For the same seed it writes the same arrays
and pickles as that script; its PNGs are written by
``hspose_tpu_torch.data.image_utils.write_png``, which writes the pixels
``cv2.imwrite`` writes.

Unlike the tests' wiring fixture (tests/test_data_pipeline.py::_write_scene,
whose depth maps are unrelated noise), every depth image here is a z-buffer
splat of box objects at their ground-truth poses — so the production train CLI
(`python -m hspose_tpu_torch.engine.train`) can actually LEARN pose from this tree,
and the production eval CLI (`python -m hspose_tpu_torch.evaluation.evaluate`) run
from the resulting checkpoint shows mAP far above an init-weights run.  This is
the environment's stand-in for the REAL275 acceptance oracle (no NOCS data
exists here); the directory layout, file formats and label conventions match
what ``datasets/load_data.py`` / ``evaluation/load_data_eval.py`` read:

* ``Real/train/scene_N/XXXX_{color,depth,mask}.png`` + ``_label.pkl``
  (label keys as load_data.py:172-299 consumes them; ``scales`` is the scalar
  NOCS diagonal, model points are unit-diagonal normalized)
* ``Real/{train,test}_list.txt``, ``obj_models/real_{train,test}.pkl``,
  ``Real/train/mug_handle.pkl``
* ``segmentation_results/REAL275/results_test_{scene}_{id}.pkl`` detection
  pickles with perfect detections + the gt_* fields the mAP stage needs
  (gt_RTs rigid 4x4 + gt_scales metric extents — the convention the metric
  stack consumes; see hspose_tpu_torch/geometry/boxes.py).

Scene recipe per image: 2-3 box objects (category mean shape x U(0.85,1.15)
per axis), upright-ish rotations (y-axis within ``--max-tilt`` of the camera
up axis, free azimuth — tabletop-like, and it makes orientation learnable:
under full SO(3) a y-symmetric box's y-axis SIGN is unlearnable from a uniform
surface cloud), translations inside the view frustum at z in [0.55, 1.0] m,
60k-point surface splats with +-2 mm depth noise and 4% dropout.  A density
cue (the -x half of every box is sampled at ~half weight) breaks the 180-deg
yaw ambiguity of plain boxes for the asymmetric categories.

Usage: python hspose_tpu_torch/tools/make_synth_nocs.py OUTDIR [--train N] [--test M]
           [--seed S]
"""

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hspose_tpu_torch.data.dataset import REAL_INTRINSICS  # noqa: E402
from hspose_tpu_torch.data.image_utils import write_png  # noqa: E402
from hspose_tpu_torch.geometry import symmetry as sym_tab  # noqa: E402

H, W = 480, 640


def _sample_box_surface(rng, n, extents, density_cue=True):
    """n points uniformly on the surface of an origin-centred box (area-
    weighted across faces), with the -x half thinned to ~55% weight when
    ``density_cue`` (breaks the box's 180-deg yaw symmetry)."""
    m = n * 2 if density_cue else n
    ex, ey, ez = extents
    areas = np.array([ey * ez, ey * ez, ex * ez, ex * ez, ex * ey, ex * ey])
    face = rng.choice(6, size=m, p=areas / areas.sum())
    uv = rng.uniform(-0.5, 0.5, (m, 2)).astype(np.float64)
    pts = np.empty((m, 3), np.float64)
    axis = face // 2  # 0:x faces, 1:y faces, 2:z faces
    sign = np.where(face % 2 == 0, 0.5, -0.5)
    for a in range(3):
        sel = axis == a
        others = [i for i in range(3) if i != a]
        pts[sel, a] = sign[sel]
        pts[sel, others[0]] = uv[sel, 0]
        pts[sel, others[1]] = uv[sel, 1]
    pts *= np.asarray(extents)[None]
    if density_cue:
        w = np.where(pts[:, 0] < 0, 0.55, 1.0)
        idx = rng.choice(m, size=n, replace=False, p=w / w.sum())
        pts = pts[idx]
    return pts.astype(np.float32)


def _upright_rotation(rng, max_tilt_deg):
    """R = tilt . yaw: free azimuth about y, then a tilt of U(0, max_tilt)
    about a random horizontal axis — the object's y-axis stays within
    ``max_tilt`` of the camera's -y (image up)."""
    yaw = rng.uniform(0, 2 * np.pi)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    tilt = np.deg2rad(rng.uniform(0, max_tilt_deg))
    phi = rng.uniform(0, 2 * np.pi)
    axis = np.array([np.cos(phi), 0.0, np.sin(phi)])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T = np.eye(3) + np.sin(tilt) * K + (1 - np.cos(tilt)) * (K @ K)
    return (T @ Ry).astype(np.float32)


def _render_instances(rng, instances, cam_k, n_splat=60000):
    """Z-buffer splat of all instances; returns (depth_u16_mm, mask_u8)."""
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]
    zbuf = np.full((H, W), np.inf, np.float64)
    mask = np.zeros((H, W), np.uint8)
    for inst_id, (extents, R, t) in enumerate(instances, start=1):
        pts = _sample_box_surface(rng, n_splat, extents)
        cam = pts @ R.T + t[None]
        z = cam[:, 2]
        u = np.round(fx * cam[:, 0] / z + cx).astype(np.int64)
        v = np.round(fy * cam[:, 1] / z + cy).astype(np.int64)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0.05)
        u, v, z = u[ok], v[ok], z[ok]
        flat = v * W + u
        inst_z = np.full(H * W, np.inf, np.float64)
        np.minimum.at(inst_z, flat, z * 1000.0)  # mm
        inst_z = inst_z.reshape(H, W)
        closer = inst_z < zbuf
        zbuf = np.where(closer, inst_z, zbuf)
        mask = np.where(closer, np.uint8(inst_id), mask)
    depth = np.where(np.isfinite(zbuf), zbuf, 0.0)
    # sensor-ish noise: +-2 mm uniform, 4% dropout holes
    noise = rng.uniform(-2.0, 2.0, depth.shape)
    keep = rng.random(depth.shape) >= 0.04
    depth = np.where((depth > 0) & keep, depth + noise, 0.0)
    return np.clip(depth, 0, 65535).astype(np.uint16), mask


def _color_png(rng):
    """A small-but-valid color image (content is never decoded, only its CRC
    and dims are checked — keep it compressible)."""
    img = np.full((H, W, 3), 96, np.uint8)
    for _ in range(6):
        x0, y0 = rng.integers(0, W - 60), rng.integers(0, H - 60)
        c = rng.integers(0, 255, 3)
        img[y0:y0 + 50, x0:x0 + 50] = c
    return img


def make_image(rng, root, split, scene, img_id, max_tilt, with_detections,
               detection_root):
    cam_k = REAL_INTRINSICS.astype(np.float64)
    n = int(rng.integers(2, 4))
    cats = rng.choice(6, size=n, replace=False)  # 0-based
    instances, models, labels = [], {}, []
    placed = []
    for k, c in enumerate(cats):
        name = sym_tab.CAT_NAMES[c]
        mean = sym_tab.mean_shape_mm(name) / 1000.0
        extents = (mean * rng.uniform(0.85, 1.15, 3)).astype(np.float32)
        R = _upright_rotation(rng, max_tilt)
        # keep projected centres apart so objects rarely occlude each other
        for _ in range(50):
            z = rng.uniform(0.55, 1.0)
            u = rng.uniform(120, W - 120)
            v = rng.uniform(100, H - 100)
            if all(abs(u - pu) + abs(v - pv) > 170 for pu, pv in placed):
                break
        placed.append((u, v))
        t = np.array([(u - cam_k[0, 2]) * z / cam_k[0, 0],
                      (v - cam_k[1, 2]) * z / cam_k[1, 1], z], np.float32)
        instances.append((extents, R, t))
        nocs_scale = float(np.linalg.norm(extents))
        model_name = f"synth_{scene}_{img_id}_{k}"
        models[model_name] = (_sample_box_surface(rng, 1024, extents)
                              / nocs_scale).astype(np.float32)
        labels.append((int(c) + 1, model_name, nocs_scale, R, t, extents))

    depth, mask = _render_instances(rng, instances, cam_k)

    # drop instances whose visible masked-depth support is too thin for the
    # pipeline (needs >=50 valid points after mask AND depth)
    keep = [k for k in range(n)
            if np.sum((mask == k + 1) & (depth > 0)) >= 400]
    if not keep:
        return None
    # relabel mask ids compactly
    new_mask = np.zeros_like(mask)
    for new_id, k in enumerate(keep, start=1):
        new_mask[mask == k + 1] = new_id
    mask = new_mask
    labels = [labels[k] for k in keep]
    models = {labels[i][1]: models[labels[i][1]] for i in range(len(labels))}
    n = len(labels)

    bboxes = []
    for inst in range(1, n + 1):
        ys, xs = np.nonzero(mask == inst)
        bboxes.append([int(ys.min()), int(xs.min()), int(ys.max()), int(xs.max())])

    scene_dir = os.path.join(root, "Real", split, scene)
    os.makedirs(scene_dir, exist_ok=True)
    prefix = os.path.join(scene_dir, img_id)
    write_png(prefix + "_color.png", _color_png(rng))
    write_png(prefix + "_depth.png", depth)
    mask3 = np.zeros((H, W, 3), np.uint8)
    mask3[:, :, 2] = mask
    write_png(prefix + "_mask.png", mask3)

    gt_RTs = np.tile(np.eye(4), (n, 1, 1))
    for i, (_, _, _, R, t, _) in enumerate(labels):
        gt_RTs[i, :3, :3] = R
        gt_RTs[i, :3, 3] = t
    gts = {
        "class_ids": [lab[0] for lab in labels],
        "instance_ids": list(range(1, n + 1)),
        "model_list": [lab[1] for lab in labels],
        "scales": [lab[2] for lab in labels],
        "rotations": [lab[3] for lab in labels],
        "translations": [lab[4] for lab in labels],
        "bboxes": bboxes,
    }
    with open(prefix + "_label.pkl", "wb") as f:
        pickle.dump(gts, f)

    if with_detections:
        det_dir = os.path.join(detection_root, "REAL275")
        os.makedirs(det_dir, exist_ok=True)
        pred_masks = np.zeros((H, W, n), np.uint8)
        for i in range(n):
            pred_masks[:, :, i] = (mask == i + 1).astype(np.uint8)
        det = {
            "pred_class_ids": np.array([lab[0] for lab in labels], np.int32),
            "pred_bboxes": np.array(bboxes, np.int32),
            "pred_scores": np.linspace(0.95, 0.7, n),
            "pred_masks": pred_masks,
            "gt_class_ids": np.array([lab[0] for lab in labels], np.int32),
            "gt_RTs": gt_RTs,
            "gt_scales": np.stack([lab[5] for lab in labels]).astype(np.float64),
            "gt_handle_visibility": np.ones(n),
        }
        with open(os.path.join(det_dir, f"results_test_{scene}_{img_id}.pkl"),
                  "wb") as f:
            pickle.dump(det, f)
    return models


def generate(out_dir, n_train=400, n_test=50, seed=0, max_tilt=40.0,
             images_per_scene=50):
    root = os.path.join(out_dir, "NOCS")
    detection_root = os.path.join(out_dir, "segmentation_results")
    os.makedirs(os.path.join(root, "Real"), exist_ok=True)
    rng = np.random.default_rng(seed)

    specs = [("train", n_train, False), ("test", n_test, True)]
    mug_table = {}
    for split, count, with_det in specs:
        rel_list, models = [], {}
        made = 0
        scene_no = 1 if split == "train" else 100
        while made < count:
            scene = f"scene_{scene_no}"
            for i in range(images_per_scene):
                if made >= count:
                    break
                img_id = f"{i:04d}"
                m = make_image(rng, root, split, scene, img_id, max_tilt,
                               with_det, detection_root)
                if m is None:
                    continue
                models.update(m)
                rel_list.append(f"{split}/{scene}/{img_id}")
                made += 1
            if split == "train":
                mug_table[f"{scene}_res"] = {i: 1
                                             for i in range(images_per_scene)}
            scene_no += 1
        with open(os.path.join(
                root, "Real",
                ("train_list.txt" if split == "train" else "test_list.txt")),
                "w") as f:
            f.writelines(r + "\n" for r in rel_list)
        os.makedirs(os.path.join(root, "obj_models"), exist_ok=True)
        pkl = "real_train.pkl" if split == "train" else "real_test.pkl"
        with open(os.path.join(root, "obj_models", pkl), "wb") as f:
            pickle.dump(models, f)

    with open(os.path.join(root, "Real", "train", "mug_handle.pkl"), "wb") as f:
        pickle.dump(mug_table, f)
    print(f"synthetic NOCS tree at {root}: {n_train} train / {n_test} test "
          f"images (detections under {detection_root})")
    return root, detection_root


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--train", type=int, default=400)
    ap.add_argument("--test", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-tilt", type=float, default=40.0)
    args = ap.parse_args()
    generate(args.out_dir, args.train, args.test, args.seed, args.max_tilt)
