"""The train step on one card per rank, per (dp, mp) layout: step 0 held
against one process, the step's own rate on in-memory batches, and the
loader's rate apart.

    python hspose_tpu_torch/tools/multigpu_step.py [--tree DIR] [--run DP MP B ...] \
        [--iters 20] [--loader-batches 8] [--points 1028] [--share-card] [--out F.json]

Each ``--run DP MP B`` (default: (1,1,16), (2,1,16), (1,2,16), (2,2,16),
(4,1,16), (4,1,64), as far as the cards go) runs this file under ``python
-m torch.distributed.run --standalone --nproc_per_node=DP*MP`` (nccl, one
card per rank) on a synthetic NOCS tree (``tools/make_synth_nocs.py``, 24
train images, unless ``--tree`` names one).  Every rank does what the
train CLI does (``engine/train.py``: seed 13, the model from
``torch.manual_seed``, the batch of (seed, step), each step's generator
seeded from ``step_seed(seed, step)``, its ``B / DP`` rows), in three
parts:

1. the loader alone: the CLI's pool (``resolve_num_workers(-1,
   local_ranks=DP*MP)`` workers) makes batch 0 (its start-up), then
   ``--loader-batches`` batches on every rank at once: the workers' own
   samples/s (the CLI's ``loader_samples_per_s``) and the wall clock's
   after batch 0 (flattered by the batches prefetched meanwhile);
2. step 0 on batch 0, with every k-NN search's indices and searched map
   recorded (``models/face_recon.py::knn``);
3. the step alone: 3 warm-up steps, then ``--iters`` steps on the
   in-memory batches between two barriers.

The parent prints one JSON row per run: steps/s and samples/s of the step
alone, the loader's samples/s a rank, and step 0 against the first run of
the same B with one rank: each loss term's relative gap and, per search,
the query rows whose neighbour sets differ and the largest gap of the
searched map; at the first search where a row differs, each flipped
row's margin (how far, in the one-process map, a neighbour that one side
kept and the other dropped lies from the k-th) against what the two maps'
gap and the search's fp32 arithmetic can move (``flip_margins``).  A flip
within that is a near tie that any last-bit change of the search's input
can turn; a wider one, or loss gaps with no search differing, would be
the code's.  It needs a CUDA card per
rank and names the cards (``nvidia-smi``); ``--share-card`` puts every
rank on ``cuda:0`` over gloo instead (up to four ranks on a one-card
machine: its step 0 traces hold, its rates are no multi-GPU rates), and
``HSPOSE_PLATFORM=cpu`` runs it
over gloo on the CPU (four ranks at most) to try it at a small
``--points``.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
RUNS = ((1, 1, 16), (2, 1, 16), (1, 2, 16), (2, 2, 16), (4, 1, 16), (4, 1, 64))
SEED = 13
WARMUP = 3


def cards() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def rank_main(tree: str, dp: int, mp: int, bs: int, iters: int, loader_batches: int,
              points: int, share: bool, out: str) -> None:
    """One rank of a run (module docstring): writes ``rank<r>.pt`` to ``out``."""
    import logging

    import torch.distributed as dist

    from hspose_tpu_torch.config import HSPoseConfig, parse_overrides
    from hspose_tpu_torch.data.dataset import (
        PoseTrainDataset,
        make_worker_pool,
        resolve_num_workers,
        train_batches,
    )
    from hspose_tpu_torch.engine.train import step_seed
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models import face_recon
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.parallel.mesh import batch_sharding, init_distributed, resolve_mesh

    if os.environ.get("HSPOSE_PLATFORM") == "cpu":
        device = init_distributed("cpu")
    else:
        device = init_distributed("cuda:0", backend="gloo") if share else init_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg: HSPoseConfig = parse_overrides([f"data.dataset_dir={tree}/NOCS",
                                         f"train.batch_size={bs}", f"parallel.dp={dp}",
                                         f"parallel.mp={mp}", f"train.seed={SEED}",
                                         f"data.num_points={points}"])
    mesh = resolve_mesh(cfg.parallel, bs, logging.getLogger("multigpu_step"))
    rows = batch_sharding(mesh, bs)

    # 1. the loader alone, every rank at once
    dataset = PoseTrainDataset(cfg.data, mode="train", sample_mode="host")
    workers = resolve_num_workers(-1, local_ranks=world)
    pool, stats = make_worker_pool(cfg.data, "train", "host", workers), {}
    try:
        stream = train_batches(dataset, bs, 1 + loader_batches, seed=SEED,
                               prefetch=cfg.data.prefetch, pool=pool, stats=stats)
        batches = [next(stream)]
        t0 = time.perf_counter()
        batches += list(stream)
        loader_s = time.perf_counter() - t0
    finally:
        pool.terminate()
    # the workers' own rate (the CLI's loader_samples_per_s) and the wall
    # clock's after batch 0, which the prefetched batches flatter
    worker_rate = bs * stats["batches"] / stats["worker_s"] * workers

    torch.manual_seed(SEED)
    model = build_model(cfg.model, device=device, train_heads=True)
    generator = torch.Generator(device=device)
    step = build_train_step(cfg, model, generator, mesh if mesh.dp * mesh.mp > 1 else None)

    def run(i: int) -> dict:
        generator.manual_seed(step_seed(SEED, i))
        return step(to_device({k: v[rows] for k, v in batches[i % len(batches)].items()},
                              device))

    # 2. step 0, its searches recorded
    searches, maps, saved = [], [], face_recon.knn

    def search(points, *args, **kwargs):
        idx = saved(points, *args, **kwargs)
        searches.append(idx.cpu())
        maps.append(points.detach().float().cpu())
        return idx

    face_recon.knn = search
    try:
        metrics0 = run(0)
    finally:
        face_recon.knn = saved

    # 3. the step alone on in-memory batches
    for i in range(1, 1 + WARMUP):
        run(i)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(1 + WARMUP, 1 + WARMUP + iters):
        run(i)
    sync(device)
    dist.barrier()
    step_s = time.perf_counter() - t0
    torch.save({"metrics0": metrics0, "searches": searches, "maps": maps, "rows": rows,
                "mp_index": mesh.mp_index, "steps_per_s": iters / step_s,
                "loader_samples_per_s": worker_rate,
                "loader_wall_samples_per_s": loader_batches * bs / loader_s, "workers": workers},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def flip_margins(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> list:
    """Per query row whose neighbour sets differ (``a`` searched in the map
    ``y``, ``b`` in the one-process map ``x``; each (N, k) into the N rows
    of its (N, C) map): (margin, moves, rounding), in squared distances.
    ``margin``: the largest gap, in ``x``, between the squared distance of
    a neighbour only one set holds and ``b``'s k-th; ``moves``: how far the
    two maps' gap can move those two squared distances (each point moved by
    at most ``delta``, the largest ||y_p - x_p|| of the query and of every
    point in either set); ``rounding``: how far the fp32 ||q||^2 + ||p||^2 -
    2 q.p expansion that the search computes for C > 8 can err on them,
    (C + 2) 2^-24 (||q|| + ||p||)^2 each.  A flip with margin <= moves is
    a near tie of the maps' gap; one with margin <= moves + rounding, a
    near tie of the search's own fp32 arithmetic, which any last-bit change
    of its inputs can flip; a wider one would be the code's."""
    out = []
    x, y = x.double(), y.double()
    gamma = (x.shape[-1] + 2) * 2.0 ** -24
    for q in torch.nonzero((a.sort(-1).values != b.sort(-1).values).any(-1)).ravel().tolist():
        def sq(j):
            return ((x[j] - x[q]) ** 2).sum().item()

        def rounding(j):
            return gamma * (x[q].norm().item() + x[j].norm().item()) ** 2

        kth = max(b[q].tolist(), key=sq)
        points = [q, *set(a[q].tolist()) | set(b[q].tolist())]
        delta = (y[points] - x[points]).norm(dim=-1).max().item()

        def moves(j):
            return (sq(j) ** 0.5 + 2 * delta) ** 2 - sq(j)

        j = max(set(a[q].tolist()) ^ set(b[q].tolist()), key=lambda j: abs(sq(j) - sq(kth)))
        out.append((abs(sq(j) - sq(kth)), moves(j) + moves(kth), rounding(j) + rounding(kth)))
    return out


def compare(ranks: list, ref: dict) -> dict:
    """A run's step 0 (``ranks``, one record per rank) against the
    one-process record ``ref`` on its B: module docstring."""
    m, w = ranks[0]["metrics0"], ref["metrics0"]
    rel = {k: abs(m[k] - v) / max(abs(v), 1e-12) for k, v in w.items() if k != "skipped_nan"}
    out = {"loss_0": m["total_loss"], "loss_0_ref": w["total_loss"],
           "total_rel": rel["total_loss"], "worst_term": max(rel, key=rel.get),
           "worst_term_rel": max(rel.values())}
    differ, gaps, first = [], [], None
    for s in range(len(ref["searches"])):
        n_rows, gap, flips = 0, 0.0, []
        for r in ranks:
            if r["mp_index"]:
                continue
            x, a, b = ref["maps"][s][r["rows"]], r["searches"][s], ref["searches"][s][r["rows"]]
            diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
            n_rows += int(diff.sum())
            gap = max(gap, (r["maps"][s] - x).abs().max().item())
            if first is None:
                flips += [f for i in range(a.shape[0]) if diff[i].any()
                          for f in flip_margins(x[i], r["maps"][s][i], a[i], b[i])]
        differ.append(n_rows)
        gaps.append(gap)
        if flips:
            first = {"search": s, "flipped_rows": len(flips),
                     "within_moves": sum(m <= mv for m, mv, _ in flips),
                     "within_moves_and_rounding": sum(m <= mv + r for m, mv, r in flips),
                     "worst_margin_over_moves": max(m / max(mv, 1e-300) for m, mv, _ in flips),
                     "worst_margin_over_moves_and_rounding": max(m / (mv + r)
                                                                 for m, mv, r in flips)}
    out.update({"search_rows_differing": differ, "search_map_gap": gaps,
                "search_map_scale": [m.abs().max().item() for m in ref["maps"]],
                "first_differing_search": first})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default="")
    ap.add_argument("--run", type=int, nargs=3, action="append", metavar=("DP", "MP", "B"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--loader-batches", type=int, default=8)
    ap.add_argument("--points", type=int, default=1028)
    ap.add_argument("--share-card", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--rank-of", nargs=3, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        rank_main(args.tree, *args.rank_of, args.iters, args.loader_batches, args.points,
                  args.share_card, args.rank_out)
        return 0
    n = torch.cuda.device_count()
    if os.environ.get("HSPOSE_PLATFORM") == "cpu" or (args.share_card and n):
        n = 4
    if n == 0:
        print("multigpu_step: no CUDA device", file=sys.stderr)
        return 2
    runs = [tuple(r) for r in (args.run or RUNS) if r[0] * r[1] <= n]
    smi = cards() if torch.cuda.is_available() else "cpu"
    print(smi, flush=True)
    rows, refs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = args.tree
        if not tree:
            tree = os.path.join(tmp, "tree")
            subprocess.run([sys.executable, os.path.join(REPO, "hspose_tpu_torch", "tools",
                                                         "make_synth_nocs.py"), tree,
                            "--train", "24", "--test", "4"], check=True, capture_output=True)
        for n_run, (dp, mp, bs) in enumerate(runs):
            out = os.path.join(tmp, f"run{n_run}_{dp}_{mp}_{bs}")
            os.makedirs(out)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc_per_node={dp * mp}", os.path.abspath(__file__), "--tree", tree,
                   "--iters", str(args.iters), "--loader-batches", str(args.loader_batches),
                   "--points", str(args.points), *(["--share-card"] if args.share_card else []),
                   "--rank-of", str(dp), str(mp), str(bs), "--rank-out", out]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
            if proc.returncode:
                raise RuntimeError(f"dp={dp} mp={mp} B={bs} failed:\n{proc.stdout[-3000:]}\n"
                                   f"{proc.stderr[-3000:]}")
            ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                     for r in range(dp * mp)]
            row = {"dp": dp, "mp": mp, "batch": bs, "world": dp * mp,
                   "steps_per_s": float(np.mean([r["steps_per_s"] for r in ranks[:1]])),
                   "loader_workers_per_rank": ranks[0]["workers"],
                   "loader_samples_per_s_per_rank": [r["loader_samples_per_s"] for r in ranks],
                   "loader_wall_samples_per_s_per_rank": [r["loader_wall_samples_per_s"]
                                                          for r in ranks],
                   "wall_s": time.perf_counter() - t0}
            row["samples_per_s"] = row["steps_per_s"] * bs
            if dp * mp == 1 and bs not in refs:
                refs[bs] = ranks[0]
                row["loss_0"] = ranks[0]["metrics0"]["total_loss"]
            elif bs in refs:
                row.update(compare(ranks, refs[bs]))
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cards": smi, "iters": args.iters, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
