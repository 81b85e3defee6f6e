"""Batched evaluation harness and CLI (counterpart of
``hspose_tpu/evaluation/evaluate.py``).

    python -m hspose_tpu_torch.evaluation.evaluate data.dataset_dir=... \\
        train.resume_model=<checkpoint.pth> eval.eval_seed=1677483078

Detection crops are batched across images into fixed-size batches of
``eval.eval_batch``, a short batch padded with copies of its crop 0, and go
through ``eval_forward`` and ``generate_RT`` on the CUDA card, unless a
function is given ``device="cpu"`` (the tests) or the CLI runs with
``HSPOSE_PLATFORM=cpu``, the variable the JAX CLI reads to pick its
platform.  On the card a batch's inputs are copied from pinned host memory
without waiting for the card, and its forward is one CUDA graph replay
(``models/graphed.py``), so the host stacks and submits the next batch
while the card runs this one; a batch's results are fetched only after the
next batch has been submitted.

Several GPUs serve as the JAX harness's (dp, sp) or (dp, mp) mesh does
(hspose_tpu/evaluation/evaluate.py:58-132), one process per GPU:

    torchrun --standalone --nproc_per_node=<dp*sp> -m hspose_tpu_torch.evaluation.evaluate \
        parallel.dp=<dp> parallel.sp=<sp> data.num_points=4096 ...
    torchrun --standalone --nproc_per_node=<dp*mp> -m hspose_tpu_torch.evaluation.evaluate \
        parallel.dp=<dp> parallel.mp=<mp> ...

The CLI joins the process group (``nccl``, one card per rank; ``gloo`` with
``HSPOSE_PLATFORM=cpu``).  Every rank batches the same records and draws
the same random numbers, so each crop sees the draws of the one-device
run; each dp row serves its ``B / dp`` rows of every batch, and with
``parallel.sp`` each rank of the row its ``N / sp`` contiguous points of
them (``parallel/sp.py``; N must divide by 16 * sp).  With ``parallel.mp``
the ranks of a dp row serve the same rows on a copy of the model whose
wide Dense layers keep each rank's output channels (``parallel/mp.py``).
The rows' results are gathered to every rank; rank 0 alone writes
``pred_result.pkl``, the log and the mAP table.  dp shrinks until it
divides ``eval.eval_batch``, with the JAX harness's warning;
``parallel.dp=-1`` puts every rank not on the sp or mp axis on the data
axis.  Refused, with the JAX harness's messages where it has them: sp with
mp, sp with ``eval.recon``, sp in device mode and an N that does not shard;
dp, sp or mp above 1 without a process group raises and names
``torchrun``.  A cached ``pred_result.pkl`` is reused; then the NOCS
degree/cm mAP table is computed on thresholds 0-60 deg x 1 / 0-10 cm x 0.5 /
IoU 0-1 x 0.01.  ``eval.recon`` also measures, per detection, the chamfer
distance (``ops/chamfer.py``, K16 under no_grad) and the Sinkhorn EMD
(``ops/emd.py``) between the recon head's cloud and the observed points.

With ``eval.sample_mode=device`` the records carry each crop's 256²
depth, mask and pixel coordinates and its intrinsics in place of a cloud;
the padded batch of crops goes to the model's device, and the forward
back-projects and samples it there (``data/preprocess.py::
roi_to_pointcloud``, ``data.num_points`` points) before the model, as the
JAX harness does.

The random numbers come from one ``torch.Generator`` seeded from the eval
seed, which draws per batch the sampling scores (device mode), then the
pooling samples, as the JAX harness draws both from one key per batch.  The
caller may give either instead: ``pool_samples``, the same for every
batch, and ``sample_scores``, one (B, H·W) tensor per batch (the tests pass
the JAX package's).  With dp or sp, every rank draws a whole batch's
scores and takes its rows.
"""

from __future__ import annotations

import copy
import importlib.util
import logging
import os
import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hspose_tpu_torch.config import HSPoseConfig, parse_overrides
from hspose_tpu_torch.data.preprocess import CROP_KEYS, roi_to_pointcloud
from hspose_tpu_torch.geometry.symmetry import SYNSET_NAMES
from hspose_tpu_torch.parallel.mesh import Mesh, batch_sharding, resolve_mesh
from hspose_tpu_torch.parallel.mp import distribute
from hspose_tpu_torch.parallel.sp import sp_points_per_device
from hspose_tpu_torch.utils.logging import setup_logger
from hspose_tpu_torch.utils.spans import span

TORCHRUN = ("torchrun --standalone --nproc_per_node=<dp*sp*mp> -m "
            "hspose_tpu_torch.evaluation.evaluate parallel.dp=<dp> parallel.sp=<sp> "
            "parallel.mp=<mp> ...")
# a batch's outputs, in the forward's order, as the detection dicts name them
RESULT_KEYS = ("pred_RTs", "pred_scales", "chamfer_dis_cass", "emd_dis_cass")


def check_parallel(cfg: HSPoseConfig) -> None:
    """Raise on the parallel settings the harness does not run."""
    p = cfg.parallel
    if p.sp > 1 and p.mp > 1:
        raise ValueError("parallel.sp and parallel.mp are mutually exclusive")
    if p.sp > 1 and cfg.eval.recon:
        raise ValueError("eval.recon is not supported with parallel.sp")
    if p.sp > 1:
        sp_points_per_device(cfg.data.num_points, p.sp)
    if max(p.dp, p.sp, p.mp) > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"parallel.dp={p.dp}, sp={p.sp}, mp={p.mp}: the harness serves several GPUs with "
            f"one process each and found no process group; run it under torchrun: {TORCHRUN}")


def serving_mesh(cfg: HSPoseConfig) -> Mesh:
    """The harness's (dp, sp) or (dp, mp) layout (``parallel/mesh.py::
    resolve_mesh``), dp shrunk until it divides ``eval.eval_batch``."""
    check_parallel(cfg)
    return resolve_mesh(cfg.parallel, cfg.eval.eval_batch, logging.getLogger("eval_log"),
                        "eval_batch")


def _build_forward(cfg: HSPoseConfig, model, generator: torch.Generator,
                   pool_samples: Optional[Sequence[torch.Tensor]],
                   sample_scores: Optional[Sequence[torch.Tensor]], mesh: Mesh):
    """This rank's rows of one padded batch (and with sp its points) on the
    model's device -> (RT, scales[, chamfer, emd]).  The batch's crops are a
    dict: ``pcl_in``, or in device mode the ``CROP_KEYS`` tensors, sampled
    here to ``data.num_points`` points from the rows' scores of the whole
    batch's draw."""
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward
    from hspose_tpu_torch.ops.chamfer import chamfer_distance
    from hspose_tpu_torch.ops.emd import emd_distance
    from hspose_tpu_torch.ops.sampling import draw_sample_scores

    with_recon = cfg.eval.recon
    rows = batch_sharding(mesh, cfg.eval.eval_batch)

    @torch.no_grad()
    def forward(crop, obj_id, sym, mean_shape, batch_no):
        if "pcl_in" in crop:
            pc = crop["pcl_in"]
        else:
            depth = crop["roi_depth"]
            scores = (sample_scores[batch_no].to(depth.device) if sample_scores is not None
                      else draw_sample_scores(generator, cfg.eval.eval_batch, depth[0].numel()))
            pc, _ = roi_to_pointcloud(scores[rows], *(crop[k] for k in CROP_KEYS),
                                      cfg.data.num_points)
        samples = (pool_samples if pool_samples is not None
                   else draw_pool_samples(pc.shape[1] * mesh.sp, generator, pc.device))
        out = eval_forward(model, pc, obj_id, pool_samples=samples, with_heads=with_recon,
                           sp_group=mesh.sp_group)
        RT = generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                         out.pred_T, sym)
        outs = (RT, out.pred_s + mean_shape)
        if with_recon:
            # per-instance chamfer + Sinkhorn-EMD between the reconstructed
            # cloud and the observed points (the eval_recon producers)
            recon = out.recon.float()
            da, db = chamfer_distance(recon, pc)
            emd = emd_distance(recon, pc, epsilon=cfg.eval.emd_epsilon,
                               iters=cfg.eval.emd_iters)
            outs += (da.mean(-1) + db.mean(-1), emd)
        return outs

    return forward


def batched_pose_inference(cfg: HSPoseConfig, model, image_records, seed: int,
                           pool_samples: Optional[Sequence[torch.Tensor]] = None,
                           sample_scores: Optional[Sequence[torch.Tensor]] = None):
    """Run the posenet over all detection crops in fixed-size padded batches
    on the model's device.

    image_records: iterable of (data_dict, detection_dict, gts) from
    ``PoseEvalDataset`` (a generator streams them), in either sample mode:
    records with ``pcl_in`` are served as they are, records of crops are
    sampled on the model's device.  ``pool_samples`` and ``sample_scores``
    (batch i's scores at index i) replace the generator's draws.  Fills each
    detection_dict with 'pred_RTs' and 'pred_scales' (with ``eval.recon``
    also 'chamfer_dis_cass' and 'emd_dis_cass'), and the gt_* fields the
    mAP stage needs; returns (pred_results, crops_per_second), the first
    batch left out of the timing.

    With ``parallel.dp`` / ``parallel.sp`` every rank of the process group
    calls it on the same records and seed (module docstring): this rank
    serves its rows and points, and every rank returns all the results.
    With ``parallel.mp`` the ranks serve a copy of ``model`` laid out on the
    mesh, unless ``model`` already is (``parallel/mp.py::distribute``)."""
    with span("harness.request"):
        return _serve(cfg, model, image_records, seed, pool_samples, sample_scores)


def _serve(cfg, model, image_records, seed, pool_samples, sample_scores):
    """``batched_pose_inference``'s body, inside its request span."""
    mesh = serving_mesh(cfg)
    if mesh.mp > 1 and getattr(model, "mesh", None) is None:
        model = distribute(copy.deepcopy(model), mesh)
    B = cfg.eval.eval_batch
    rows = batch_sharding(mesh, B)
    device = next(model.parameters()).device
    records = iter(image_records)
    try:
        first = next(records)
    except StopIteration:
        return [], 0.0
    crop_keys = ("pcl_in",) if "pcl_in" in first[0] else CROP_KEYS
    if mesh.sp > 1 and crop_keys != ("pcl_in",):
        raise ValueError("parallel.sp needs host-sampled point clouds (eval.sample_mode=host)")
    points = slice(None)
    if mesh.sp > 1:  # this rank's contiguous points of each crop
        n_local = sp_points_per_device(first[0]["pcl_in"].shape[1], mesh.sp)[0]
        points = slice(mesh.sp_index * n_local, (mesh.sp_index + 1) * n_local)
    generator = torch.Generator(device=device).manual_seed(seed)
    forward_fn = _build_forward(cfg, model, generator, pool_samples, sample_scores, mesh)
    # the rows this rank reports when results are exchanged (one rank of each dp row)
    reports = ([] if dist.is_initialized() and mesh.active and mesh.sp_index == 0
               and mesh.mp_index == 0 else None)

    state = {"t_start": None, "timed_from": 0, "fetched": 0, "batch_no": 0}
    # per-record output holders; records complete in order
    pred_results: List[Dict] = []
    crops: Dict[str, List] = {k: [] for k in crop_keys}
    ids: List = []
    syms: List = []
    means: List = []
    owners: List = []
    # (outputs on the device, owners of this rank's rows, n_valid, batch number)
    in_flight = None

    def ingest(rec):
        data, detection_dict, gts = rec
        rec_idx = len(pred_results)
        n = len(data["cat_id_0base"])
        for k in ["gt_class_ids", "gt_RTs", "gt_scales", "gt_handle_visibility"]:
            if k not in detection_dict and k in gts:
                detection_dict[k] = gts[k]
        detection_dict["pred_RTs"] = np.zeros((n, 4, 4))
        detection_dict["pred_scales"] = np.zeros((n, 3))
        if cfg.eval.recon:
            detection_dict["chamfer_dis_cass"] = np.zeros(n)
            detection_dict["emd_dis_cass"] = np.zeros(n)
        pred_results.append(detection_dict)
        for j in range(n):
            for k in crop_keys:
                crops[k].append(data[k][j])
            ids.append(data["cat_id_0base"][j])
            syms.append(data["sym_info"][j])
            means.append(data["mean_shape"][j])
            owners.append((rec_idx, j))

    def fill(rec_idx, j, values):
        for key, v in zip(RESULT_KEYS, values):
            pred_results[rec_idx][key][j] = v

    def pull():
        """The next record, ingested; None at the end of the records."""
        with span("harness.ingest"):
            rec = next(records, None)
            if rec is not None:
                ingest(rec)
        return rec

    def land(flight):
        outs, flight_owners, n_valid, batch_no = flight
        with span("harness.land", batch_no):
            fetched = []
            for o in outs:
                with span("sync.fetch"):  # the synchronisation point
                    fetched.append(o.cpu().numpy())
            for i, (rec_idx, j) in enumerate(flight_owners):
                values = [o[i] for o in fetched]
                fill(rec_idx, j, values)
                if reports is not None:
                    reports.append((rec_idx, j, values))
            state["fetched"] += n_valid
            if state["t_start"] is None:
                # the first batch (kernel builds, allocator warm-up) is not timed
                state["t_start"] = time.time()
                state["timed_from"] = state["fetched"]

    def to_device(v, n_valid, dtype, cut=None):
        """This rank's rows of the padded batch (and ``cut`` of each row),
        stacked and cast in one pass into host memory, pinned for the card."""
        items = (v[:n_valid] + [v[0]] * (B - n_valid))[rows]
        if cut is not None:
            items = [x[cut] for x in items]
        batch = torch.empty((len(items), *np.shape(items[0])), dtype=dtype,
                            pin_memory=device.type == "cuda")
        np.stack(items, out=batch.numpy(), casting="unsafe")  # astype's cast
        if device.type == "cuda":
            # from pinned memory the copy is queued behind the forwards in flight,
            # and the caching host allocator keeps the block until it has run
            return batch.to(device, non_blocking=True)
        with span("sync.upload"):  # a pageable copy waits for the device's queue
            return batch.to(device)

    def submit(n_valid):
        nonlocal in_flight
        batch_no = state["batch_no"]
        if mesh.active:
            with span("harness.to_device", batch_no):
                inputs = ({k: to_device(v, n_valid, torch.float32,
                                        points if k == "pcl_in" else None)
                           for k, v in crops.items()},
                          to_device(ids, n_valid, torch.int32),
                          to_device(syms, n_valid, torch.float32),
                          to_device(means, n_valid, torch.float32))
            with span("harness.forward", batch_no):
                outs = forward_fn(*inputs, batch_no)
            mine = owners[rows.start:min(rows.stop, n_valid)]
        state["batch_no"] += 1
        for v in crops.values():
            del v[:n_valid]
        del ids[:n_valid], syms[:n_valid], means[:n_valid], owners[:n_valid]
        if mesh.active:
            prev, in_flight = in_flight, (outs, mine, n_valid, batch_no)
            if prev is not None:
                land(prev)

    with span("harness.ingest"):
        ingest(first)
    while pull() is not None:
        while len(ids) >= B:
            submit(B)
    while ids:
        submit(min(B, len(ids)))
    if in_flight is not None:
        land(in_flight)

    elapsed = (time.time() - state["t_start"]) if state["t_start"] else 0.0
    timed = state["fetched"] - state["timed_from"]
    crops_per_sec = timed / elapsed if timed > 0 and elapsed > 0 else 0.0
    if dist.is_initialized():
        # every dp row's results to every rank
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, reports or [])
        for part in everyone:
            for rec_idx, j, values in part:
                fill(rec_idx, j, values)
    return pred_results, crops_per_sec


def iter_eval_images(cfg: HSPoseConfig, seed: int, num_workers: int = 8,
                     limit: Optional[int] = None, window: int = 32):
    """Stream eval image records with a bounded look-ahead window: a thread
    pool keeps at most ``window`` images in flight.  Image i samples its
    points from ``SeedSequence([seed, i])``, as the JAX harness does, or in
    device mode (``eval.sample_mode``) ships its crops."""
    from collections import deque

    from hspose_tpu_torch.evaluation.eval_dataset import PoseEvalDataset

    ds = PoseEvalDataset(cfg.data, mode="test", sample_mode=cfg.eval.sample_mode)
    n = len(ds) if limit is None else min(limit, len(ds))

    def load(i):
        return ds.get_image(i, np.random.default_rng(np.random.SeedSequence([seed, i])))

    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as ex:
        futs = deque()
        nxt = 0
        while nxt < n or futs:
            while nxt < n and len(futs) < window:
                futs.append(ex.submit(load, nxt))
                nxt += 1
            rec = futs.popleft().result()
            if rec is not None:
                yield rec


def load_eval_images(cfg: HSPoseConfig, seed: int, num_workers: int = 8,
                     limit: Optional[int] = None):
    """Materialized list variant of :func:`iter_eval_images` (tests/tools)."""
    return list(iter_eval_images(cfg, seed, num_workers, limit))


def report_lines(iou_aps, pose_aps, degree_thres_list, shift_thres_list,
                 iou_thres_list, idx: int = -1) -> List[str]:
    """The README-style metric table (reference evaluation/evaluate.py:143-207)."""
    d05 = degree_thres_list.index(5)
    d10 = degree_thres_list.index(10)
    s02 = shift_thres_list.index(2)
    s05 = shift_thres_list.index(5)
    s10 = shift_thres_list.index(10)
    return [
        "mAP:",
        "3D IoU at 25: {:.1f}".format(iou_aps[idx, iou_thres_list.index(0.25)] * 100),
        "3D IoU at 50: {:.1f}".format(iou_aps[idx, iou_thres_list.index(0.5)] * 100),
        "3D IoU at 75: {:.1f}".format(iou_aps[idx, iou_thres_list.index(0.75)] * 100),
        "5 degree, 2cm: {:.1f}".format(pose_aps[idx, d05, s02] * 100),
        "5 degree, 5cm: {:.1f}".format(pose_aps[idx, d05, s05] * 100),
        "10 degree, 2cm: {:.1f}".format(pose_aps[idx, d10, s02] * 100),
        "10 degree, 5cm: {:.1f}".format(pose_aps[idx, d10, s05] * 100),
        "10 degree, 10cm: {:.1f}".format(pose_aps[idx, d10, s10] * 100),
        "5 degree: {:.1f}".format(pose_aps[idx, d05, -1] * 100),
        "10 degree: {:.1f}".format(pose_aps[idx, d10, -1] * 100),
        "2cm: {:.1f}".format(pose_aps[idx, -1, s02] * 100),
        "5cm: {:.1f}".format(pose_aps[idx, -1, s05] * 100),
        "10cm: {:.1f}".format(pose_aps[idx, -1, s10] * 100),
    ]


def evaluate(cfg: HSPoseConfig, device=None,
             pool_samples: Optional[Sequence[torch.Tensor]] = None,
             sample_scores: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, float]:
    """Weights (``train.resume_model``) -> predictions -> the mAP table, on
    ``device`` (the CUDA card unless the caller names another), in the
    sample mode ``eval.sample_mode`` names; ``pool_samples`` and
    ``sample_scores`` as in :func:`batched_pose_inference`.  The AP curves
    are plotted where matplotlib is installed.  In a process group every
    rank serves its share and rank 0 alone writes the predictions, the log
    file and the table; the other ranks return their crops/s only."""
    from hspose_tpu_torch.evaluation.metrics import compute_degree_cm_mAP

    check_parallel(cfg)
    seed = [cfg.eval.eval_seed if cfg.eval.eval_seed != -1 else int(time.time())]
    rank = 0
    if dist.is_initialized():
        dist.broadcast_object_list(seed)  # one seed: rank 0's clock
        rank = dist.get_rank()
    seed = seed[0]
    model_name = os.path.basename(cfg.train.resume_model).split(".")[0] or "model"
    output_path = os.path.join(cfg.train.model_save, f"eval_result_{model_name}")
    os.makedirs(output_path, exist_ok=True)
    logger = setup_logger("eval_log", os.path.join(cfg.train.model_save, "log_eval.txt")
                          if rank == 0 else None)

    pred_path = os.path.join(output_path, "pred_result.pkl")
    crops_per_sec = 0.0
    if os.path.exists(pred_path):
        with open(pred_path, "rb") as f:
            pred_results = pickle.load(f)
    else:
        from hspose_tpu_torch.data.dataset import resolve_num_workers
        from hspose_tpu_torch.models.hspose import build_model
        from hspose_tpu_torch.utils.params_io import load_params

        model = build_model(cfg.model, device=device, train_heads=cfg.eval.recon)
        load_params(model, cfg.train.resume_model)
        logger.info("streaming eval images through batched inference...")
        pred_results, crops_per_sec = batched_pose_inference(
            cfg, model, iter_eval_images(cfg, seed, resolve_num_workers(cfg.data.num_workers)),
            seed, pool_samples, sample_scores)
        logger.info(f"{len(pred_results)} images evaluated")
        if rank == 0:
            with open(pred_path, "wb") as f:
                pickle.dump(pred_results, f)
        logger.info(f"inference throughput: {crops_per_sec:.1f} crops/s")

    if cfg.eval.eval_inference_only or rank != 0:
        return {"crops_per_sec": crops_per_sec}

    degree_thres_list = list(range(0, 61, 1))
    shift_thres_list = [i / 2 for i in range(21)]
    iou_thres_list = [i / 100 for i in range(101)]

    plot = importlib.util.find_spec("matplotlib") is not None
    if not plot:
        logger.info("matplotlib is not installed: the AP curves are not plotted")
    iou_aps, pose_aps = compute_degree_cm_mAP(
        pred_results, SYNSET_NAMES, output_path, degree_thres_list,
        shift_thres_list, iou_thres_list, iou_pose_thres=0.1,
        use_matches_for_pose=True, plot_figure=plot, eval_recon=cfg.eval.recon)
    if cfg.eval.recon:
        from hspose_tpu_torch.evaluation.metrics import aggregate_recon_metrics

        recon_stats = aggregate_recon_metrics(pred_results, SYNSET_NAMES)
        logger.info("recon metrics (eval_recon): %s", recon_stats)

    full_deg = degree_thres_list + [360]
    full_shift = shift_thres_list + [100]
    idx = (SYNSET_NAMES.index(cfg.data.per_obj)
           if cfg.data.per_obj in SYNSET_NAMES else -1)
    logger.info("Evaluation Seed: {}".format(seed))
    for line in report_lines(iou_aps, pose_aps, full_deg, full_shift, iou_thres_list, idx):
        logger.info(line)
    if idx == -1:
        for cls_id in range(1, len(SYNSET_NAMES)):
            logger.info(f"category {SYNSET_NAMES[cls_id]}")
            for line in report_lines(iou_aps, pose_aps, full_deg, full_shift,
                                     iou_thres_list, cls_id):
                logger.info(line)

    return {
        "IoU25": iou_aps[-1, iou_thres_list.index(0.25)] * 100,
        "IoU50": iou_aps[-1, iou_thres_list.index(0.5)] * 100,
        "IoU75": iou_aps[-1, iou_thres_list.index(0.75)] * 100,
        "5d2cm": pose_aps[-1, full_deg.index(5), full_shift.index(2)] * 100,
        "5d5cm": pose_aps[-1, full_deg.index(5), full_shift.index(5)] * 100,
        "10d2cm": pose_aps[-1, full_deg.index(10), full_shift.index(2)] * 100,
        "10d5cm": pose_aps[-1, full_deg.index(10), full_shift.index(5)] * 100,
        "10d10cm": pose_aps[-1, full_deg.index(10), full_shift.index(10)] * 100,
        "crops_per_sec": crops_per_sec,
    }


def main(argv=None):
    """The CLI.  Under ``torchrun`` (``WORLD_SIZE`` set) it first joins the
    process group: ``nccl`` on ``cuda:LOCAL_RANK``, or ``gloo`` on the CPU
    with ``HSPOSE_PLATFORM=cpu``."""
    cfg = parse_overrides(sys.argv[1:] if argv is None else argv)
    device = "cpu" if os.environ.get("HSPOSE_PLATFORM") == "cpu" else None
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        from hspose_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(device)
    try:
        evaluate(cfg, device=device)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
