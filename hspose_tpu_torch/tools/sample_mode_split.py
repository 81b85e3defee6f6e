"""Split the train loop's time by sample mode: where device sampling's steps go.

The train loop (``engine/train.py``) makes each batch in the spawned worker
pool, copies it to the card (``engine/train_step.py::to_device``) and takes
the step.  In host mode a B=24 batch is about 0.3 MB of clouds; in device
mode (``data.sample_mode=device``) it is about 25 MB of 256² crops, which
the step samples on the card.  For each mode this script times, on a tree
rendered by ``tools/make_synth_nocs.py`` (or ``--tree``), with the recipe's
model (B=24, ``--dtype``, seed 7):

1. ``bytes``: one batch's size, and ``make_ms``: one batch made in this
   process (``data/dataset.py::_make_batch_from``);
2. ``copy_ms``: ``to_device`` of an in-memory batch, synchronised;
3. ``step_ms``: ``to_device`` and the step on ``IN_MEMORY`` in-memory
   batches, cycled for ``--steps`` steps, median, the first ``WARMUP``
   steps left out (the kernels' build, the allocator);
4. ``pool_batches_per_s``: the worker pool (``--workers`` processes)
   delivering ``--steps`` batches with no step taken, after ``WARMUP``
   batches that wait for the workers' start;
5. ``loop_steps_per_s``: the pool and the step together, as the loop runs
   them, the first ``WARMUP`` steps left out.

Host and device mode are measured twice each, in turns.

Usage::

    python hspose_tpu_torch/tools/sample_mode_split.py [--tree DIR] [--steps 60]
        [--dtype bfloat16|float32] [--workers 7] [--out F.json]

Prints one line per mode and, last, one JSON object with the card's name
and power limit.  Needs a CUDA card: without one it exits with code 2.
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

from hspose_tpu_torch.config import parse_overrides  # noqa: E402
from hspose_tpu_torch.data import dataset as pds  # noqa: E402
from hspose_tpu_torch.engine.train_step import build_train_step, to_device  # noqa: E402
from hspose_tpu_torch.models.hspose import build_model  # noqa: E402

WARMUP = 3
BATCH = 24
IN_MEMORY = 12  # batches made in this process, cycled for the in-memory steps


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def synced(fn):
    """fn's result and its host-clock seconds, ending in a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def measure(tree: str, mode: str, steps: int, dtype: str, workers: int, device) -> dict:
    cfg = parse_overrides([f"data.dataset_dir={tree}/NOCS", f"data.sample_mode={mode}",
                           f"train.batch_size={BATCH}", f"model.compute_dtype={dtype}",
                           f"train.train_steps={steps}", "optim.lr=4.5e-4",
                           "optim.warmup_iters=100"])
    ds = pds.PoseTrainDataset(cfg.data, sample_mode=mode)
    t0 = time.perf_counter()
    batches = [pds._make_batch_from(ds, 7, i, BATCH) for i in range(IN_MEMORY)]
    make_s = (time.perf_counter() - t0) / IN_MEMORY

    torch.manual_seed(7)
    model = build_model(cfg.model, device=device, train_heads=True)
    generator = torch.Generator(device=device).manual_seed(7)
    step = build_train_step(cfg, model, generator)
    copy_s = [synced(lambda b=b: to_device(b, device))[1] for b in batches]
    step_s = [synced(lambda b=b: step(to_device(b, device)))[1]
              for b in (batches * steps)[:steps]]

    pool = pds.make_worker_pool(cfg.data, "train", mode, workers)
    try:
        stream = pds.train_batches(ds, BATCH, steps, seed=11, pool=pool)
        for i, _ in enumerate(stream):
            if i == WARMUP - 1:
                t0 = time.perf_counter()
        pool_s = time.perf_counter() - t0
        stream = pds.train_batches(ds, BATCH, steps, seed=13, pool=pool)
        for i, b in enumerate(stream):
            step(to_device(b, device))
            if i == WARMUP - 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        pool.terminate()
    return {"mode": mode, "bytes": int(sum(v.nbytes for v in batches[0].values())),
            "make_ms": make_s * 1e3, "copy_ms": float(np.median(copy_s[WARMUP:])) * 1e3,
            "step_ms": float(np.median(step_s[WARMUP:])) * 1e3,
            "pool_batches_per_s": (steps - WARMUP) / pool_s,
            "loop_steps_per_s": (steps - WARMUP) / loop_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default="", help="a NOCS tree (default: render 24 / 4 images)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--workers", type=int, default=7)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sample_mode_split: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    with tempfile.TemporaryDirectory() as tmp:
        tree = args.tree
        if not tree:
            tree = tmp
            subprocess.run([sys.executable, os.path.join(REPO, "hspose_tpu_torch", "tools",
                                                         "make_synth_nocs.py"), tree,
                            "--train", "24", "--test", "4"], check=True, capture_output=True)
        rows = []
        for mode in ("host", "device", "host", "device"):
            r = measure(tree, mode, args.steps, args.dtype, args.workers, "cuda")
            print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in r.items()), flush=True)
            rows.append(r)
    rec = {"card": smi, "dtype": args.dtype, "batch": BATCH, "steps": args.steps,
           "workers": args.workers, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
