"""Evaluation dataset: DualPoseNet detection pickles → per-instance point clouds.

A copy of ``hspose_tpu/evaluation/eval_dataset.py`` (the port cannot import
the JAX package) without cv2: where the native library does not build, the
decode and the crops run in numpy (``data/image_utils.py``) with cv2's bits;
the native library's crops can differ from those at half-pixel coordinates.
In host sample mode each crop's cloud is sampled here (``pcl_in``); in
device mode (``eval.sample_mode=device``) the image's crops are stacked as
``roi_depth``, ``roi_mask``, ``roi_coord`` and ``cam_k``, and the harness
samples them on the card (``data/preprocess.py``).

Equivalent of ``evaluation/load_data_eval.PoseDataset`` (:16-286): per test image,
load the detection pickle (``results_{test,val}_{scene}_{id}.pkl``), crop each
detected instance with the deterministic square window (no DZI jitter), back-project
masked depth and sample the fixed-size cloud, and attach per-class symmetry/mean
shape.  The TPU harness batches crops *across* images (the reference runs one image
at a time, evaluate.py:79-119), so this module just yields per-image crop groups.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from hspose_tpu_torch.config import DataConfig
from hspose_tpu_torch.data import image_utils as iu
from hspose_tpu_torch.data import native_preproc as npp
from hspose_tpu_torch.data.dataset import (
    CAMERA_INTRINSICS,
    REAL_INTRINSICS,
    _read_img_lists,
    check_sample_mode,
    host_depth_to_pcl,
    host_sample_points,
)
from hspose_tpu_torch.geometry import symmetry as sym_tab


class PoseEvalDataset:
    def __init__(self, cfg: DataConfig, mode: str = "test", sample_mode: str = "host"):
        check_sample_mode(sample_mode)
        self.cfg = cfg
        self.sample_mode = sample_mode
        self.data_dir = cfg.dataset_dir
        self.detection_dir = cfg.detection_dir
        lists = _read_img_lists(self.data_dir, cfg.dataset, mode)
        self.img_list = lists.img_list
        # For CAMERA the reference keys sym/mean-shape lookups by ShapeNet synset
        # (load_data_eval.py:69-76): synset mean shapes differ from the Real ones
        # (:361-384) and get_sym_info falls through to no-symmetry for synsets
        # (:435-436) — both quirks are intentional and preserved here.
        if cfg.dataset == "CAMERA":
            self.id2cat_name = {str(i + 1): sym_tab.SHAPENET_SYNSET[n]
                                for i, n in enumerate(sym_tab.CAT_NAMES)}
        else:
            self.id2cat_name = {str(i + 1): n
                                for i, n in enumerate(sym_tab.CAT_NAMES)}
        # Per-obj eval is gated exactly like load_data_eval.py:82-83: only for the
        # Real source and never for 'can'.  When active, the image list shrinks to
        # images whose GT contains the category (cached like the train side,
        # load_data_eval.py:84-125).
        self.per_obj = cfg.per_obj
        self.per_obj_id = None
        if (cfg.per_obj in sym_tab.CAT_NAMES and cfg.per_obj != "can"
                and cfg.dataset == "Real"):
            self.per_obj_id = sym_tab.CAT_NAME2ID[cfg.per_obj]
            self.img_list = self._filter_per_obj(self.img_list, mode)
        self.length = len(self.img_list)

    def _filter_per_obj(self, img_list, mode):
        """Keep only images containing the target category, with an on-disk cache
        (load_data_eval.py:84-125; same cache layout as the train side)."""
        cache_dir = os.path.join(self.data_dir, "img_list")
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"{self.per_obj}_{self.cfg.dataset}_{mode}_img_list.txt")
        if os.path.exists(cache):
            with open(cache) as f:
                return [line.rstrip("\n") for line in f]
        kept = []
        for rel in img_list:
            try:
                with open(os.path.join(self.data_dir, rel + "_label.pkl"), "rb") as f:
                    gts = pickle.load(f)
                if self.per_obj_id in gts["class_ids"]:
                    kept.append(rel)
            except Exception:
                continue
        with open(cache, "w") as f:
            f.writelines(k + "\n" for k in kept)
        return kept

    def __len__(self):
        return self.length

    def get_image(self, index: int, rng: np.random.Generator
                  ) -> Optional[Tuple[Dict, Dict, Dict]]:
        """Returns (data_dict, detection_dict, gts) or None on unreadable input."""
        img_path = os.path.join(self.data_dir, self.img_list[index])
        try:
            with open(img_path + "_label.pkl", "rb") as f:
                gts = pickle.load(f)
        except Exception:
            return None

        is_camera = "CAMERA" in img_path.split(os.sep)
        cam_k = CAMERA_INTRINSICS if is_camera else REAL_INTRINSICS

        parts = img_path.split(os.sep)
        scene, img_id = parts[-2], parts[-1]
        if is_camera:
            detection_file = os.path.join(self.detection_dir, "CAMERA25",
                                          f"results_val_{scene}_{img_id}.pkl")
        else:
            detection_file = os.path.join(self.detection_dir, "REAL275",
                                          f"results_test_{scene}_{img_id}.pkl")
        with open(detection_file, "rb") as f:
            detection_dict = pickle.load(f)

        # CRC-validated color dims without the pixel decode (the reference
        # decodes the full RGB just for im_h/im_w, load_data_eval.py:139-143 —
        # png_color_valid enforces the same accept/reject on corrupt files),
        # one depth decode (native C++ where it builds, else numpy), and the
        # fused crops of every instance (one threaded native batch, else
        # numpy) — each bit-exact against its JAX twin (native / cv2 path)
        use_native = getattr(self.cfg, "native_preproc", True)
        dims = iu.png_color_valid(img_path + "_color.png")
        if dims is None:
            return None
        im_h, im_w = dims
        depth = npp.decode_depth(img_path + "_depth.png") if use_native else None
        if depth is None:
            try:
                depth = iu.load_depth(img_path + "_depth.png")
            except (OSError, ValueError):
                return None

        num_instances = len(detection_dict["pred_class_ids"])
        s = self.cfg.img_size

        sym_infos, mean_shapes, obj_ids, obj_ids_0, pcls, valid_idx = \
            [], [], [], [], [], []
        roi_depths, roi_masks, roi_coords, cam_ks = [], [], [], []
        sel, centers, scales = [], [], []
        for j in range(num_instances):
            cat_id = int(detection_dict["pred_class_ids"][j])
            if self.per_obj_id is not None:
                if cat_id != self.per_obj_id:
                    continue
                valid_idx.append(j)
            rmin, rmax, cmin, cmax = iu.get_bbox(detection_dict["pred_bboxes"][j],
                                                 im_h, im_w)
            center, scale = iu.bbox_center_scale_eval(
                np.array([cmin, rmin, cmax, rmax]), im_h, im_w)
            sel.append(j)
            centers.append(center)
            scales.append(scale)

        native = (npp.eval_crops(depth, detection_dict["pred_masks"], sel,
                                 centers, scales, s)
                  if use_native and sel else None)
        for i, j in enumerate(sel):
            cat_id = int(detection_dict["pred_class_ids"][j])
            if native is not None:
                roi_depth, roi_mask = native[0][i], native[1][i]
                roi_coord, counts = native[2][i], native[3][i]
                if counts[0] <= 1 or counts[1] <= 1:
                    return None
            else:
                roi_depth, roi_mask, roi_coord, n_depth, n_both = iu.fused_crop(
                    depth, detection_dict["pred_masks"][:, :, j] != 0, centers[i],
                    scales[i], s)
                if n_depth <= 1 or n_both <= 1:
                    return None
            if self.sample_mode == "device":
                roi_depths.append(roi_depth.astype(np.float32))
                roi_masks.append(roi_mask.astype(np.float32))
                roi_coords.append(roi_coord.astype(np.float32))
                cam_ks.append(cam_k)
            else:
                pcl = host_depth_to_pcl(roi_depth, cam_k, roi_coord, roi_mask) / 1000.0
                pcls.append(host_sample_points(rng, pcl, self.cfg.num_points))

            cat_name = self.id2cat_name[str(cat_id)]
            sym_infos.append(sym_tab.sym_info(cat_name))
            mean_shapes.append(sym_tab.mean_shape_mm(cat_name) / 1000.0)
            obj_ids.append(cat_id)
            obj_ids_0.append(cat_id - 1)

        if self.per_obj_id is not None:
            for key in ["pred_class_ids", "pred_bboxes", "pred_scores"]:
                detection_dict[key] = np.array(
                    [detection_dict[key][i] for i in valid_idx])
        detection_dict.pop("pred_masks", None)

        data_dict = {
            "cat_id": np.array(obj_ids, np.int32),
            "cat_id_0base": np.array(obj_ids_0, np.int32),
            "sym_info": np.array(sym_infos, np.float32).reshape(-1, 4),
            "mean_shape": np.array(mean_shapes, np.float32).reshape(-1, 3),
        }
        if self.sample_mode == "device":
            data_dict["roi_depth"] = np.array(roi_depths, np.float32).reshape(-1, s, s)
            data_dict["roi_mask"] = np.array(roi_masks, np.float32).reshape(-1, s, s)
            data_dict["roi_coord"] = np.array(roi_coords, np.float32).reshape(-1, 2, s, s)
            data_dict["cam_k"] = np.array(cam_ks, np.float32).reshape(-1, 3, 3)
        else:
            data_dict["pcl_in"] = np.array(pcls, np.float32).reshape(
                -1, self.cfg.num_points, 3)
        return data_dict, detection_dict, gts
