"""Steps/s of the train CLI on one card per rank, per world size.

    python hspose_tpu_torch/tools/multigpu_train_rate.py [--tree DIR] [--steps 30] \
        [--run DP MP B ...] [--out F.json]

Runs ``python -m torch.distributed.run --standalone --nproc_per_node=<dp*mp>
-m hspose_tpu_torch.engine.train`` (nccl, one card per rank) for one epoch of
``--steps`` steps on a synthetic NOCS tree (rendered by
``tools/make_synth_nocs.py`` with 24 train and 4 test images unless
``--tree`` names one), once per ``--run DP MP B`` (default: (1,1,16),
(2,1,16), (1,2,16), (2,1,32), (2,2,16), (4,1,16), (4,1,64), as far as the
cards go), and prints per run, from rank 0's ``metrics.jsonl``: steps/s
after the first step, samples/s, seconds waiting for batches, the loader's
workers and samples/s per rank (every rank makes the whole batch of (seed,
step): see ``engine/train.py``), and step 0's loss (equal across runs of one
B up to the summation order of the BatchNorm sums and the gradient
reduction).  It needs a CUDA card per rank and names the cards
(``nvidia-smi``) beside the rates.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS = ((1, 1, 16), (2, 1, 16), (1, 2, 16), (2, 1, 32), (2, 2, 16), (4, 1, 16), (4, 1, 64))


def cards() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def measure(tree: str, out: str, dp: int, mp: int, bs: int, steps: int) -> dict:
    """One train CLI run on dp * mp cards: rank 0's epoch record."""
    save = os.path.join(out, f"run_{dp}_{mp}_{bs}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={dp * mp}", "-m", "hspose_tpu_torch.engine.train",
           f"data.dataset_dir={tree}/NOCS", f"train.batch_size={bs}", f"train.train_steps={steps}",
           "train.total_epoch=1", "train.log_every=1", "train.seed=13", f"parallel.dp={dp}",
           f"parallel.mp={mp}", f"train.model_save={save}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    if proc.returncode:
        raise RuntimeError(f"dp={dp} mp={mp} B={bs} failed:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epoch = [r for r in recs if "steps_per_s" in r][-1]
    rate = epoch["steps_per_s_after_first"]
    return {"world": dp * mp, "dp": dp, "mp": mp, "batch": bs, "steps_per_s_after_first": rate,
            "samples_per_s": rate * bs, "data_wait_s": epoch["data_wait_s"],
            "num_workers": epoch["num_workers"],
            "loader_samples_per_s": epoch["loader_samples_per_s"],
            "loss_0": next(r["total_loss"] for r in recs if "total_loss" in r),
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--run", type=int, nargs=3, action="append", metavar=("DP", "MP", "B"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n == 0:
        print("multigpu_train_rate: no CUDA device", file=sys.stderr)
        return 2
    runs = [r for r in (args.run or RUNS) if r[0] * r[1] <= n]
    smi = cards()
    print(smi, flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tree = args.tree
        if not tree:
            tree = os.path.join(tmp, "tree")
            subprocess.run([sys.executable, os.path.join(REPO, "hspose_tpu_torch", "tools",
                                                         "make_synth_nocs.py"), tree,
                            "--train", "24", "--test", "4"], check=True, capture_output=True)
        for dp, mp, bs in runs:
            row = measure(tree, tmp, dp, mp, bs, args.steps)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cards": smi, "steps": args.steps, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
