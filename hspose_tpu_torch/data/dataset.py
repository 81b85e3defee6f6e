"""NOCS train dataset and loader (host pipeline): a copy of
``hspose_tpu/data/dataset.py`` (numpy; the port cannot import the JAX
package), which the eval dataset shares.

Equivalent of ``datasets/load_data.PoseDataset`` (:21-299): image-list aggregation
over CAMERA/Real sources, per-category filtering, mug-handle visibility table,
sampling-with-replacement epochs (epoch = train_steps × batch_size draws), per-sample
crop/mask/label processing, and the 12-tensor sample dict.  Differences by design:

* explicit ``np.random.Generator`` everywhere (no global RNG);
* decode and crop run in the native C++ library where it builds (it needs
  libpng) and otherwise in numpy (``data/image_utils.py``: zlib PNG decode,
  cv2 5.0's nearest-warp arithmetic).  Each gives the bits of its twin in the
  JAX loader (native / cv2), but the two can crop differently at half-pixel
  source coordinates, so the (seed, step) -> batch stream depends on the path
  as well: :func:`decode_path` says which one runs;
* batching runs in spawned worker **processes** (like the reference's 20
  DataLoader workers, engine/train.py:65-69) via :func:`make_worker_pool`,
  which hide the CUDA card from them, or synchronously without a pool.
  Batches derive from (seed, step) only, so both modes yield the same stream.

Two sample modes: ``sample_mode='host'`` back-projects and samples each
cloud here (the reference's ``_depth_to_pcl`` / ``_sample_points``, with its
rule of at least 50 points) and ships ``pcl_in``; ``sample_mode='device'``
ships the 256² ``roi_depth`` / ``roi_mask`` (after its noise) /
``roi_coord`` crops and ``cam_k``, and the train step samples on the card
(``data/preprocess.py``).  Device mode draws nothing for sampling from the
sample's generator and has no 50-point rule, as in the JAX package, so the
two modes' streams part after a worker's first sample.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from hspose_tpu_torch.config import DataConfig
from hspose_tpu_torch.data import image_utils as iu
from hspose_tpu_torch.data import native_preproc as npp
from hspose_tpu_torch.geometry import symmetry as sym_tab

CAMERA_INTRINSICS = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]],
                             dtype=np.float32)
REAL_INTRINSICS = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084],
                            [0, 0, 1]], dtype=np.float32)


@dataclass
class SampleLists:
    img_list: List[str]
    subset_len: List[int]


def _read_img_lists(data_dir: str, source: str, mode: str) -> SampleLists:
    """Aggregate the per-source image lists (load_data.py:40-71)."""
    paths = {
        "train": {
            "CAMERA": ["CAMERA/train_list.txt"],
            "Real": ["Real/train_list.txt"],
            "CAMERA+Real": ["CAMERA/train_list.txt", "Real/train_list.txt"],
        },
        "test": {
            "CAMERA": ["CAMERA/val_list.txt"],
            "Real": ["Real/test_list.txt"],
            "CAMERA+Real": ["Real/test_list.txt"],
        },
    }[mode][source]
    img_list: List[str] = []
    subset_len = []
    for p in paths:
        root = p.split("/")[0]
        with open(os.path.join(data_dir, p)) as f:
            img_list += [os.path.join(root, line.rstrip("\n")) for line in f]
        subset_len.append(len(img_list))
    if len(subset_len) == 2:
        subset_len = [subset_len[0], subset_len[1] - subset_len[0]]
    return SampleLists(img_list, subset_len)


def _model_files(source: str, mode: str) -> List[str]:
    return {
        ("train", "CAMERA"): ["obj_models/camera_train.pkl"],
        ("train", "Real"): ["obj_models/real_train.pkl"],
        ("train", "CAMERA+Real"): ["obj_models/camera_train.pkl",
                                   "obj_models/real_train.pkl"],
        ("test", "CAMERA"): ["obj_models/camera_val.pkl"],
        ("test", "Real"): ["obj_models/real_test.pkl"],
        ("test", "CAMERA+Real"): ["obj_models/real_test.pkl"],
    }[(mode, source)]


def check_sample_mode(sample_mode: str) -> None:
    """Raise a ValueError unless ``sample_mode`` is ``"host"`` or ``"device"``."""
    if sample_mode not in ("host", "device"):
        raise ValueError(f"sample_mode={sample_mode!r}: expected 'host' or 'device'")


def decode_path(cfg: DataConfig) -> str:
    """Which decode and crop the loader runs: ``"native"`` (the C++ library,
    libpng) or ``"numpy"`` (zlib and numpy).  The decoded images are the same
    either way; the crops can differ at half-pixel source coordinates, so a
    batch stream is reproduced only on the same path."""
    return "native" if cfg.native_preproc and npp.get_lib() is not None else "numpy"


class PoseTrainDataset:
    """Training-sample factory over the NOCS directory tree."""

    def __init__(self, cfg: DataConfig, mode: str = "train", sample_mode: str = "host"):
        assert cfg.dataset in ("CAMERA", "Real", "CAMERA+Real")
        check_sample_mode(sample_mode)
        self.cfg = cfg
        self.mode = mode
        self.sample_mode = sample_mode
        self.data_dir = cfg.dataset_dir

        lists = _read_img_lists(self.data_dir, cfg.dataset, mode)
        self.img_list = lists.img_list
        self.subset_len = lists.subset_len
        self.length = len(self.img_list)

        self.models: Dict[str, np.ndarray] = {}
        for mf in _model_files(cfg.dataset, mode):
            with open(os.path.join(self.data_dir, mf), "rb") as f:
                self.models.update(pickle.load(f))

        self.id2cat_name = ({str(i + 1): n for i, n in enumerate(sym_tab.CAT_NAMES)}
                            if cfg.dataset != "CAMERA" else
                            {str(i + 1): sym_tab.SHAPENET_SYNSET[n]
                             for i, n in enumerate(sym_tab.CAT_NAMES)})

        mug_handle_path = os.path.join(self.data_dir, "Real/train/mug_handle.pkl")
        self.mug_sym = {}
        if os.path.exists(mug_handle_path):
            with open(mug_handle_path, "rb") as f:
                self.mug_sym = pickle.load(f)

        self.per_obj = cfg.per_obj
        self.per_obj_id = sym_tab.CAT_NAME2ID.get(cfg.per_obj)
        if self.per_obj_id is not None:
            self.img_list = self._filter_per_obj(self.img_list)
            self.length = len(self.img_list)

    def _filter_per_obj(self, img_list):
        """Keep only images containing the target category, with an on-disk cache
        (load_data.py:86-128)."""
        cache_dir = os.path.join(self.data_dir, "img_list")
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"{self.per_obj}_{self.cfg.dataset}_{self.mode}_img_list.txt")
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

    def sample_index(self, rng: np.random.Generator) -> int:
        """Replacement sampling with the 75/25 CAMERA/Real mix (load_data.py:158-166)."""
        if self.cfg.dataset == "CAMERA+Real" and self.mode == "train":
            if rng.random() < 0.75:
                return int(rng.integers(0, self.subset_len[0]))
            return self.subset_len[0] + int(rng.integers(0, self.subset_len[1]))
        return int(rng.integers(0, self.length))

    def get_sample(self, index: int, rng: np.random.Generator,
                   _depth: int = 0) -> Optional[Dict[str, np.ndarray]]:
        """One training sample; walks forward on unreadable/degenerate data
        (load_data.py:169-277).  Returns None after too many consecutive failures."""
        if _depth > 32:
            return None
        img_path = os.path.join(self.data_dir, self.img_list[index])
        nxt = (index + 1) % self.length

        def retry():
            return self.get_sample(nxt, rng, _depth + 1)

        try:
            with open(img_path + "_label.pkl", "rb") as f:
                gts = pickle.load(f)
        except Exception:
            return retry()

        is_camera = "CAMERA" in img_path.split(os.sep)
        cam_k = CAMERA_INTRINSICS if is_camera else REAL_INTRINSICS

        if self.per_obj_id is not None:
            idx = list(gts["class_ids"]).index(self.per_obj_id)
        else:
            idx = int(rng.integers(0, len(gts["instance_ids"])))

        if gts["class_ids"][idx] == 6 and not is_camera and self.mug_sym:
            parts = img_path.split(os.sep)
            scene_label = parts[-2] + "_res"
            mug_handle = self.mug_sym.get(scene_label, {}).get(int(parts[-1]), 1)
        else:
            mug_handle = 1

        # the color PNG contributes only its existence + shape (the reference
        # decodes it just for im_H/im_W, load_data.py:219-227): png_color_valid
        # walks every chunk and CRC-checks the critical ones, so a truncated or
        # bit-corrupted color file retry-walks like the reference's failed decode
        if iu.png_color_valid(img_path + "_color.png") is None:
            return retry()
        # native fast path: defer the pixel decode to the fused C++ sample op;
        # only the mask header is read here for im_h/im_w
        depth = mask = None
        dims = (npp.png_dims(img_path + "_mask.png")
                if self.cfg.native_preproc else None)

        def decode():
            try:
                d = iu.load_depth(img_path + "_depth.png")
            except (OSError, ValueError):
                return None, None
            return d, iu.load_mask(img_path + "_mask.png")

        if dims is not None:
            im_h, im_w = dims
        else:
            depth, mask = decode()
            if depth is None or mask is None:
                return retry()
            im_h, im_w = mask.shape[:2]

        inst_id = gts["instance_ids"][idx]
        rmin, rmax, cmin, cmax = iu.get_bbox(gts["bboxes"][idx], im_h, im_w)
        bbox_xyxy = np.array([cmin, rmin, cmax, rmax])
        center, scale = iu.aug_bbox_dzi(rng, bbox_xyxy, im_h, im_w,
                                        self.cfg.dzi_pad_scale, self.cfg.dzi_scale_ratio,
                                        self.cfg.dzi_shift_ratio, self.cfg.dzi_type)

        s = self.cfg.img_size
        native = (npp.train_sample(img_path + "_depth.png", img_path + "_mask.png",
                                   int(inst_id), center, scale, s)
                  if dims is not None else None)
        if native is None:
            if depth is None:  # native decode declined: the numpy path retries
                depth, mask = decode()
                if depth is None or mask is None:
                    return retry()
            if depth.shape != mask.shape:  # incoherent depth and mask files
                return retry()
            native = iu.fused_crop(depth, mask == inst_id, center, scale, s)
        roi_depth, roi_mask, roi_coord, n_depth, n_both = native
        if n_depth <= 1 or n_both <= 1:
            return retry()

        cat_id = int(gts["class_ids"][idx]) - 1  # 0-based
        model = self.models[gts["model_list"][idx]].astype(np.float32)
        nocs_scale = float(gts["scales"][idx])
        fsnet_scale, mean_shape = sym_tab.fs_net_scale(
            self.id2cat_name[str(cat_id + 1)], model, nocs_scale)
        rotation = np.asarray(gts["rotations"][idx], np.float32)
        translation = np.asarray(gts["translations"][idx], np.float32)

        roi_mask_def = iu.defor_2d_mask(rng, roi_mask, self.cfg.roi_mask_r,
                                        self.cfg.roi_mask_pro)

        sym_info = sym_tab.sym_info(self.id2cat_name[str(cat_id + 1)], mug_handle)
        aug_bb, aug_rt_t, aug_rt_r = generate_aug_parameters(rng)

        sample = {
            "cat_id": np.float32(cat_id),
            "rotation": rotation,
            "translation": translation,
            "fsnet_scale": fsnet_scale.astype(np.float32),
            "sym_info": sym_info.astype(np.float32),
            "mean_shape": mean_shape.astype(np.float32),
            "aug_bb": aug_bb,
            "aug_rt_t": aug_rt_t,
            "aug_rt_R": aug_rt_r,
            "model_point": model,
            "nocs_scale": np.float32(nocs_scale),
        }
        if self.sample_mode == "device":
            sample["roi_depth"] = roi_depth.astype(np.float32)
            sample["roi_mask"] = roi_mask_def.astype(np.float32)
            sample["roi_coord"] = roi_coord.astype(np.float32)
            sample["cam_k"] = cam_k
            return sample
        pcl = host_depth_to_pcl(roi_depth, cam_k, roi_coord, roi_mask_def)
        if len(pcl) < 50:  # load_data.py:276-277
            return retry()
        sample["pcl_in"] = host_sample_points(rng, pcl / 1000.0, self.cfg.num_points)
        return sample


def host_depth_to_pcl(roi_depth, cam_k, roi_coord, roi_mask) -> np.ndarray:
    """Host back-projection (load_data.py:322-333), output in mm.

    The native one-pass implementation (native/preproc.cpp::hsp_backproject) is
    bit-exact against this numpy path and used when available; numpy is the
    fallback and the semantics reference."""
    pcl = npp.backproject(roi_depth, cam_k, roi_coord, roi_mask)
    if pcl is not None:
        return pcl
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]
    depth = roi_depth.reshape(-1).astype(np.float64)
    valid = ((depth > 0) * roi_mask.reshape(-1)) > 0
    depth = depth[valid]
    x_map = roi_coord[0].reshape(-1)[valid]
    y_map = roi_coord[1].reshape(-1)[valid]
    real_x = (x_map - cx) * depth / fx
    real_y = (y_map - cy) * depth / fy
    return np.stack((real_x, real_y, depth), axis=-1).astype(np.float32)


def host_sample_points(rng: np.random.Generator, pcl: np.ndarray, n_pts: int):
    """Random down/up-sampling to a fixed count (load_data.py:307-320)."""
    total = pcl.shape[0]
    if total < n_pts:
        pcl = np.concatenate([np.tile(pcl, (n_pts // total, 1)),
                              pcl[:n_pts % total]], axis=0)
    elif total > n_pts:
        ids = rng.permutation(total)[:n_pts]
        pcl = pcl[ids]
    return pcl


def generate_aug_parameters(rng: np.random.Generator, s_range=(0.8, 1.2), ax=50,
                            ay=50, az=50, a=15.0):
    """Per-sample augmentation parameters (load_data.py:334-345): bb scales in
    [0.8, 1.2], ±15° Euler rotation, ±50 mm translation (metres out)."""
    lo, hi = s_range
    ex, ey, ez = rng.random(3) * (hi - lo) + lo
    angles = rng.uniform(-a, a, 3)
    Rm = euler_rotation(*angles)
    d = rng.random(3) * 2 * np.array([ax, ay, az]) - np.array([ax, ay, az])
    return (np.array([ex, ey, ez], np.float32), (d / 1000.0).astype(np.float32), Rm)


def euler_rotation(x_deg, y_deg, z_deg) -> np.ndarray:
    """R = Rz · Ry · Rx from degree angles (data_augmentation.get_rotation :192-208)."""
    x, y, z = np.deg2rad([x_deg, y_deg, z_deg])
    Rx = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)], [0, np.sin(x), np.cos(x)]])
    Ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    Rz = np.array([[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _make_batch_from(dataset: PoseTrainDataset, seed: int, step: int,
                     batch_size: int) -> Dict[str, np.ndarray]:
    """The (seed, step) -> batch function every loader mode shares."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    samples = []
    while len(samples) < batch_size:
        s = dataset.get_sample(dataset.sample_index(rng), rng)
        if s is not None:
            samples.append(s)
    return _collate(samples)


def resolve_num_workers(num_workers: int,
                        step_samples_per_sec: Optional[float] = None,
                        logger=None,
                        worker_samples_per_sec: Optional[float] = None,
                        local_ranks: int = 1) -> int:
    """Resolve ``data.num_workers`` (-1 = auto-size from host cores).

    Auto mode uses ``os.cpu_count() // local_ranks - 1`` (the host's cores
    shared among the ``local_ranks`` training processes on it, one core of
    each share staying with its process for dispatch/collation), floored at
    1 — the analog of the reference's hardcoded ``num_workers=20``
    (engine/train.py:65-69) that actually fits the machine it runs on.  An
    explicit value is honored verbatim, per process.  Warns when the pool's projected throughput (workers × the
    per-worker rate) cannot feed the step's consumption, both in samples/s;
    the train loop measures both rates during the run and passes them (the
    JAX package's rates were measured on its TPU rig and do not carry over).
    """
    if num_workers >= 0:
        resolved = num_workers
    else:
        cores = os.cpu_count() or 1
        resolved = max(cores // max(local_ranks, 1) - 1, 1)
    if step_samples_per_sec and worker_samples_per_sec and logger is not None:
        projected = max(resolved, 1) * worker_samples_per_sec
        if projected < step_samples_per_sec:
            import math
            need = math.ceil(step_samples_per_sec / worker_samples_per_sec)
            logger.warning(
                "loader pool of %d worker(s) projects ~%.0f samples/s "
                "(~%.0f/s/worker measured) but the step consumes "
                "~%.0f samples/s — the host will starve the card; need "
                "~%d workers (host has %s cores)",
                resolved, projected, worker_samples_per_sec,
                step_samples_per_sec, need, os.cpu_count())
    return resolved


_WORKER_DS: Optional[PoseTrainDataset] = None


def _worker_init(cfg: DataConfig, mode: str, sample_mode: str) -> None:
    global _WORKER_DS
    _WORKER_DS = PoseTrainDataset(cfg, mode, sample_mode)


def _worker_make_batch(args):
    seed, step, batch_size = args
    t0 = time.perf_counter()
    batch = _make_batch_from(_WORKER_DS, seed, step, batch_size)
    return step, batch, time.perf_counter() - t0


def make_worker_pool(cfg: DataConfig, mode: str = "train", sample_mode: str = "host",
                     num_workers: Optional[int] = None):
    """Spawn the persistent data-loader worker pool (the reference's
    ``num_workers=20`` DataLoader processes, engine/train.py:65-69).

    Each worker builds its own ``PoseTrainDataset(cfg, mode, sample_mode)``
    once and serves batches for the life of the pool (reuse it across epochs
    — spawn + dataset construction is paid once).  The workers start with
    ``CUDA_VISIBLE_DEVICES`` empty, so nothing they import can reach the
    card.  Close with ``pool.terminate()``.
    """
    n = resolve_num_workers(num_workers if num_workers is not None
                            else cfg.num_workers)
    ctx = multiprocessing.get_context("spawn")
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        return ctx.Pool(max(n, 1), initializer=_worker_init,
                        initargs=(cfg, mode, sample_mode))
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


# bound on the wait for any single batch: a worker that hangs (NFS stall,
# deadlocked decode) raises instead of stalling a long run silently
BATCH_TIMEOUT_S = 300.0


def pool_batches(pool, batch_size: int, steps: int, seed: int,
                 prefetch: int = 4, stats: Optional[Dict[str, float]] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """In-order batch stream from a :func:`make_worker_pool` pool, with a bounded
    window of in-flight batches.  Identical stream to the synchronous mode.

    A batch that takes longer than ``BATCH_TIMEOUT_S`` raises a TimeoutError
    naming the step; a worker that *dies* raises with the worker traceback
    attached (same as the reference DataLoader).  ``stats``, when given, gains
    the batches served (``batches``) and the seconds the workers spent making
    them (``worker_s``)."""
    window = prefetch + getattr(pool, "_processes", 4)
    pending: Dict[int, object] = {}
    submitted = 0
    for i in range(steps):
        while submitted < steps and (submitted - i) < window:
            pending[submitted] = pool.apply_async(
                _worker_make_batch, ((seed, submitted, batch_size),))
            submitted += 1
        try:
            step, batch, seconds = pending.pop(i).get(timeout=BATCH_TIMEOUT_S)
        except multiprocessing.TimeoutError as e:
            raise TimeoutError(
                f"data worker produced no batch for step {i} within "
                f"{BATCH_TIMEOUT_S:.0f}s (seed={seed}); the loader pool may be "
                f"wedged — check worker logs / data source") from e
        assert step == i
        if stats is not None:
            stats["batches"] = stats.get("batches", 0) + 1
            stats["worker_s"] = stats.get("worker_s", 0.0) + seconds
        yield batch


def train_batches(dataset: PoseTrainDataset, batch_size: int, steps: int,
                  seed: int, prefetch: int = 4, pool=None,
                  stats: Optional[Dict[str, float]] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Batch iterator with replacement sampling.

    Yields ``steps`` batches; per-batch RNG derives from (seed, batch index) so
    the stream is reproducible independent of loader mode and scheduling.
    With a :func:`make_worker_pool` ``pool`` the workers make the batches (the
    train loop's mode when ``data.num_workers > 0``); without one they are made
    here, synchronously.  ``stats`` as in :func:`pool_batches`, in both modes.

    Data-parallel training (``parallel.dp``) calls it on every rank with the
    same seed: each rank makes the whole batch and keeps its rows, since
    :func:`_make_batch_from` draws the samples one after another from one
    rng, with rejections, and a rank cannot make only its own.
    """
    if pool is not None:
        yield from pool_batches(pool, batch_size, steps, seed, prefetch, stats=stats)
        return
    for i in range(steps):
        t0 = time.perf_counter()
        batch = _make_batch_from(dataset, seed, i, batch_size)
        if stats is not None:
            stats["batches"] = stats.get("batches", 0) + 1
            stats["worker_s"] = stats.get("worker_s", 0.0) + time.perf_counter() - t0
        yield batch
