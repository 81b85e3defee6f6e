"""Serving cells: the eval harness ``batched_pose_inference`` under a traffic
mix of detection requests, and the comparison of the poses it returned
with the plain reference.

A request is one frame's detections: records of a few crops each (the
traffic file's ``records``, in an order drawn per request), whose clouds
are drawn from a pool made at set-up.  One client sends its next request
when the last has returned (a closed loop).  Set-up builds the
model, makes the weights, the crop pool and the pooling samples from the
seed, and serves ``warmup_requests`` requests (the kernels' build and
every shape of the cell); a traced run then measures the harness against
the forward alone and profiles ``trace_units`` requests twice
(``trace.py``).  The window then runs for ``--seconds`` and ends when the
last request returns.

After the window and once the program is freed, ``check_requests``
requests drawn from the seed among those served are run again through the
reference, in blocks of a batch, with the same weights, clouds and pooling
samples; per crop the gap is the largest absolute difference over its
rotation, translation and scales.  ``pose_gap_max`` is the largest over
the crops, ``pose_gap_median`` their median (``gaps`` gives quantiles
between).  A bfloat16 configuration's gaps are also read in units of the
gap that the reference computed in bfloat16 itself opens (``_rel``): the
network's sensitivity to rounding changes with the seed's weights, and
this yardstick moves with it.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench import inputs
from portbench.common import (Cell, Outcome, checks_of, device_of, free_device_memory,
                              rng, sub_seed, synchronize)
from portbench.readings import Readings
from portbench.reference import model as ref
from portbench.reference.precision import Precision
from portbench.trace import traced
from portbench.weights import make_weights

CHIPS = 1  # one process drives one card

# purposes of the run's sub-seeds
WEIGHTS, CROPS, POOLS, REQUESTS, WARMUP, OVERHEAD, SAMPLE, TRACE = range(8)


class Plan:
    """The requests of a run: the crops of request i of a purpose."""

    def __init__(self, cell: Cell, seed: int):
        t = cell.traffic
        self.sizes = list(t["records"])
        self.crops = sum(self.sizes)
        if self.crops != t["crops_per_request"]:
            raise ValueError(f"traffic records sum to {self.crops}, not crops_per_request")
        self.pool = t["pool_crops"]
        self.seed = seed

    def crop_ids(self, purpose: int, i: int) -> np.ndarray:
        return rng(self.seed, REQUESTS, purpose, i).choice(self.pool, self.crops, replace=False)

    def sizes_of(self, purpose: int, i: int) -> List[int]:
        order = rng(self.seed, REQUESTS, purpose, i, 1).permutation(len(self.sizes))
        return [self.sizes[j] for j in order]


def records(pool: Dict[str, np.ndarray], ids: np.ndarray, sizes: List[int]):
    """The harness's (data, detection, gts) records of one request."""
    out, at = [], 0
    for n in sizes:
        rows = ids[at:at + n]
        at += n
        out.append(({k: v[rows] for k, v in pool.items()}, {}, {}))
    return out


def poses(pred_results) -> np.ndarray:
    """(crops, 15): each crop's rotation (9), translation (3) and scales (3)."""
    rt = np.concatenate([d["pred_RTs"] for d in pred_results])
    s = np.concatenate([d["pred_scales"] for d in pred_results])
    return np.concatenate([rt[:, :3, :3].reshape(-1, 9), rt[:, :3, 3], s], axis=1)


def reference_poses(weights, cell: Cell, pool, ids, pool_samples, device,
                    prec: Precision) -> np.ndarray:
    """The reference's poses of the crops ``ids``, in blocks of a batch."""
    import torch

    arch = ref.Arch.of(cell.model)
    B = cell.traffic["batch"]
    out = []
    for at in range(0, len(ids), B):
        rows = ids[at:at + B]

        def t(key, dtype=torch.float32):
            return torch.as_tensor(pool[key][rows], device=device).to(dtype)

        RT, s = ref.serve(weights, arch, t("pcl_in"), t("cat_id_0base", torch.int64),
                          t("sym_info"), t("mean_shape"), pool_samples, prec)
        out.append(torch.cat([RT[:, :3, :3].reshape(-1, 9), RT[:, :3, 3], s], 1).double()
                   .cpu().numpy())
    return np.concatenate(out)


def gaps(program: np.ndarray, reference: np.ndarray,
         tier: np.ndarray | None = None) -> Dict[str, float]:
    """Statistics over the crops of each crop's gap to the reference; with
    ``tier`` (the reference in the configuration's own precision) each also
    as a multiple of the same statistic of the tier's gap (``_rel``)."""
    def stats(other):
        per_crop = np.abs(other - reference).max(axis=1)
        per_crop = np.where(np.isfinite(per_crop), per_crop, np.inf)
        return {"pose_gap_max": float(per_crop.max()),
                "pose_gap_p99": float(np.quantile(per_crop, 0.99)),
                "pose_gap_p90": float(np.quantile(per_crop, 0.9)),
                "pose_gap_median": float(np.median(per_crop))}

    out = stats(program)
    if tier is not None:
        yard = stats(tier)
        out.update({k + "_rel": v / yard[k] for k, v in list(out.items())})
    return out


def setup(cell: Cell, seed: int, device):
    """The program and the inputs: (model, weights, crop pool, pool samples)."""
    import torch

    from hspose_tpu_torch.models.hspose import build_model
    from portbench.common import port_config

    cfg = port_config(cell, eval={"eval_batch": cell.traffic["batch"]})
    model = build_model(cfg.model, device=device)
    weights = make_weights(cell.model, False, sub_seed(seed, WEIGHTS), device)
    model.load_state_dict(weights)
    pool = inputs.serve_crops(cell.traffic["pool_crops"], cell.points,
                              sub_seed(seed, CROPS), device)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, POOLS))
    return cfg, model, weights, pool, inputs.pool_samples(cell.points, g)


TIER = {"bfloat16": "bf16"}  # the reference's precision that a configuration states


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        yardstick: bool | None = None) -> Outcome:
    """One run of a serving cell; ``t_process`` is the process's start on
    the ``time.perf_counter`` clock.  ``yardstick`` computes the reference
    in the configuration's precision too (by default where a limit reads a
    ``_rel`` number)."""
    import torch

    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference

    t = cell.traffic
    cfg, model, weights, pool, pool_samples = setup(cell, seed, device)
    plan = Plan(cell, seed)

    def serve(purpose: int, i: int):
        ids = plan.crop_ids(purpose, i)
        recs = records(pool, ids, plan.sizes_of(purpose, i))
        with torch.profiler.record_function("portbench.request"):
            results, _ = batched_pose_inference(cfg, model, recs, seed=0, pool_samples=pool_samples)
        return ids, poses(results)

    for i in range(t["warmup_requests"]):
        serve(WARMUP, i)
    synchronize(device)
    host, traces = {}, (None, None)
    if trace:
        host = harness_overhead(cell, cfg, model, plan, pool, pool_samples, serve, device)
        traces = tuple(traced(lambda j: serve(TRACE, j + 1), t["trace_units"], host_ranges)
                       for host_ranges in (False, True))

    served, latencies = {}, []
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    end = t0
    while end - t0 < seconds:
        sent = time.perf_counter()
        ids, out = serve(REQUESTS, len(served))
        end = time.perf_counter()
        latencies.append(end - sent)
        served[len(served)] = (ids, out)
    elapsed = time.perf_counter() - t0
    failed = sum(not np.isfinite(out).all() for _, out in served.values())
    window = {"units": len(served), "elapsed_s": elapsed, "crops": len(served) * plan.crops,
              "latencies_s": latencies}
    readings = Readings("serve", cell.dtype, cell.model, t, setup_s, window, *traces, host)
    device_info = device_of(device)
    del model
    free_device_memory(device)

    picked = sorted(rng(seed, SAMPLE).choice(len(served), min(t["check_requests"], len(served)),
                                             replace=False))
    ids = np.concatenate([served[i][0] for i in picked])
    program = np.concatenate([served[i][1] for i in picked])
    reference = reference_poses(weights, cell, pool, ids, pool_samples, device, Precision())
    if yardstick is None:
        yardstick = any(k.endswith("_rel") for k in cell.limits)
    tier = (reference_poses(weights, cell, pool, ids, pool_samples, device,
                            Precision(TIER[cell.dtype]))
            if yardstick and cell.dtype in TIER else None)
    numbers = gaps(program, reference, tier)
    return Outcome(readings, len(served), failed, checks_of(numbers, cell.limits),
                   device_info["memory_peak_bytes"],
                   {"device": device_info, "numbers": numbers, "checked_crops": len(ids),
                    "served": served, "weights": weights, "pool": pool,
                    "pool_samples": pool_samples, "reference": reference, "tier": tier,
                    "ids": ids})


def harness_overhead(cell, cfg, model, plan, pool, pool_samples, serve, device) -> dict:
    """crops/s of the harness and of ``eval_forward`` + ``generate_RT``
    alone on the same requests' batches, already on the card, host clock."""
    import torch

    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    n = cell.traffic["overhead_requests"]
    B = cell.traffic["batch"]
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(n):
        serve(OVERHEAD, i)
    harness_s = time.perf_counter() - t0
    batches = []
    for i in range(n):
        ids = plan.crop_ids(OVERHEAD, i)
        for at in range(0, len(ids), B):
            rows = ids[at:at + B]
            batches.append([torch.as_tensor(pool[k][rows], device=device)
                            for k in ("pcl_in", "cat_id_0base", "sym_info")])
    synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for pc, obj, sym in batches:
            o = eval_forward(model, pc, obj.to(torch.int32), pool_samples=pool_samples)
            generate_RT(o.p_green_R, o.p_red_R, o.f_green_R, o.f_red_R, o.pred_T, sym)
    synchronize(device)
    forward_s = time.perf_counter() - t0
    crops = n * plan.crops
    return {"harness_crops_per_s": crops / harness_s, "forward_crops_per_s": crops / forward_s}
