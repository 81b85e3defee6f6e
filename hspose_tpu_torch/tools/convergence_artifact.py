"""Production-CLI convergence artifact of the port: train CLI -> checkpoint ->
eval CLI -> mAP (a copy of ``scripts/convergence_artifact.py`` on the
port's entry points, with the same recipe and the same pass bar).

Drives ``python -m hspose_tpu_torch.engine.train`` (dataset walk, loader
pool, augmentation, the train step on the card, checkpoints) and ``python -m
hspose_tpu_torch.evaluation.evaluate`` (streamed detection crops, batched
inference, full mAP grids) on the rendered synthetic NOCS tree
(``hspose_tpu_torch/tools/make_synth_nocs.py``), and prints the trained
checkpoint's mAP table next to an init-weights table.  This is the stand-in
for the reference's demonstrated recipe (engine/train.py:72-130 +
evaluation/evaluate.py:79-140); the REAL275 oracle itself needs the NOCS
data and released weights, which the repository does not hold.

Recipe (the JAX script's): B=24, bf16, lr 4.5e-4 with 100 warm-up steps,
one epoch of ``--steps`` steps, seed 7; ``--dtype float32`` trains the fp32
tier instead.  ``--sample-mode device`` passes ``data.sample_mode=device``
to the train CLI and ``eval.sample_mode=device`` to both eval CLIs (the
loader ships 256² crops and the card samples them), and adds ``_device``
to the run directories' names; the default is host sampling.  ``--set section.key=value`` (repeatable) is
passed to the train CLI after the recipe and chooses the training route
(``model.bwd_store=false``, ``model.train_v4_small=true``); the run
directories are named after the dtype and the overrides, so that routes do
not share checkpoints, and the heading and ``convergence_tables.json``
record them.  The eval CLI serves the default fp32 tier whatever the
route: ``bwd_store`` and ``train_v4_small`` act in training only.  The
init table comes from a 2-step run at lr · 1e-3 (the warm-up's start) on
the same route, which leaves the net at its initial weights.  Pass:
trained 3D IoU at 25 above init + 20 and 10 degree, 10cm above init + 10.
Also printed: the train wall time, the loop's steps/s, the loader's
samples/s and worker count (from the run's ``metrics.jsonl``), the trained
eval CLI's harness crops/s, and the card's name and power limit.

Usage:
  python hspose_tpu_torch/tools/convergence_artifact.py [--tree DIR] [--runs DIR]
      [--steps N] [--dtype bfloat16|float32] [--sample-mode host|device]
      [--set section.key=value ...] [--skip-train]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

HEADLINE = ["3D IoU at 25", "3D IoU at 50", "3D IoU at 75", "5 degree, 2cm",
            "5 degree, 5cm", "10 degree, 2cm", "10 degree, 5cm",
            "10 degree, 10cm", "5 degree", "10 degree", "2cm", "5cm", "10cm"]


def run(cmd, log):
    print(f"$ {' '.join(cmd)}  (log: {log})", flush=True)
    with open(log, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT)
    if p.returncode != 0:
        with open(log) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"command failed rc={p.returncode}: {' '.join(cmd)}")


def train_cmd(tree, out_dir, steps, dtype, overrides=(), seed=7, sample_mode="host"):
    """The train CLI's command line: the recipe, then ``overrides``."""
    return [sys.executable, "-u", "-m", "hspose_tpu_torch.engine.train",
            f"data.dataset_dir={tree}/NOCS",
            f"data.detection_dir={tree}/segmentation_results",
            f"data.sample_mode={sample_mode}",
            "train.batch_size=24", f"model.compute_dtype={dtype}",
            "optim.lr=4.5e-4", "optim.warmup_iters=100",
            "train.total_epoch=1", f"train.train_steps={steps}",
            "train.save_every=1", "train.log_every=100",
            f"train.seed={seed}", f"train.model_save={out_dir}", *overrides]


def train_cli(tree, out_dir, steps, dtype, overrides=(), seed=7, sample_mode="host"):
    t0 = time.perf_counter()
    run(train_cmd(tree, out_dir, steps, dtype, overrides, seed, sample_mode),
        os.path.join(out_dir, "train_cli.log"))
    return time.perf_counter() - t0


def run_dirs(runs, dtype, overrides=(), sample_mode="host"):
    """(trained, init) run directories of one route: named after the dtype
    and the overrides (``model.bwd_store=false`` adds
    ``_model.bwd_store-false``), and device sampling (``_device``).  The
    overrides are checked against the config first, so a misspelt key fails
    before any run."""
    from hspose_tpu_torch.config import parse_overrides

    parse_overrides(list(overrides))
    tag = dtype + "".join("_" + re.sub(r"[^A-Za-z0-9_.-]", "-", o) for o in overrides)
    if sample_mode != "host":
        tag += f"_{sample_mode}"
    return (os.path.join(runs, f"conv_{tag}"), os.path.join(runs, f"conv_init_{tag}"))


def eval_cmd(tree, ckpt, out_dir, sample_mode="host"):
    """The eval CLI's command line on checkpoint ``ckpt``.  It serves the
    default fp32 tier: the checkpoint's parameters are fp32 whatever the
    training compute dtype."""
    return [sys.executable, "-u", "-m", "hspose_tpu_torch.evaluation.evaluate",
            f"data.dataset_dir={tree}/NOCS",
            f"data.detection_dir={tree}/segmentation_results",
            f"eval.sample_mode={sample_mode}", "eval.eval_seed=1677483078",
            f"train.resume_model={ckpt}", f"train.model_save={out_dir}"]


def eval_cli(tree, ckpt_dir, out_dir, sample_mode="host"):
    from hspose_tpu_torch.engine.checkpoint import latest_checkpoint

    ckpt = latest_checkpoint(ckpt_dir)
    assert ckpt, f"no checkpoints under {ckpt_dir}"
    run(eval_cmd(tree, ckpt, out_dir, sample_mode), os.path.join(out_dir, "eval_cli.log"))
    return parse_table(os.path.join(out_dir, "log_eval.txt"))


def parse_table(log_eval):
    """Headline mAP rows from the eval CLI's README-style log output."""
    with open(log_eval) as f:
        text = f.read()
    # the overall table is the first block after "mAP:"; per-category tables
    # follow, so take the FIRST match of each metric
    table = {}
    for name in HEADLINE:
        # anchor on "INFO <name>: " so '2cm' cannot match '5 degree, 2cm'
        m = re.search(rf"INFO {re.escape(name)}: (-?[\d.]+|nan)$", text,
                      re.MULTILINE)
        table[name] = float(m.group(1)) if m else float("nan")
    # the harness's crops/s (first batch left out), from the same log
    m = re.search(r"inference throughput: ([\d.]+) crops/s", text)
    table["crops_per_s"] = float(m.group(1)) if m else float("nan")
    return table


def epoch_record(run_dir):
    """The train loop's last per-epoch record (steps/s, loader rates)."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if '"steps_per_s"' in line]
    return recs[-1]


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main():
    default = os.path.join(ROOT, "build", "convergence")
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(default, "synth_nocs"))
    ap.add_argument("--runs", default=os.path.join(default, "runs"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--sample-mode", default="host", choices=["host", "device"],
                    help="data.sample_mode of the train CLI and eval.sample_mode of both "
                         "eval CLIs")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="section.key=value",
                    help="train CLI override after the recipe (the training route)")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse existing checkpoints/run dirs")
    args = ap.parse_args()
    trained_dir, init_dir = run_dirs(args.runs, args.dtype, args.overrides, args.sample_mode)

    if not os.path.isdir(os.path.join(args.tree, "NOCS")):
        os.makedirs(args.tree, exist_ok=True)
        run([sys.executable, "hspose_tpu_torch/tools/make_synth_nocs.py", args.tree,
             "--train", "400", "--test", "50"], os.path.join(args.tree, "make_synth_nocs.log"))

    os.makedirs(trained_dir, exist_ok=True)
    os.makedirs(init_dir, exist_ok=True)

    wall = None
    if not args.skip_train:
        wall = train_cli(args.tree, trained_dir, args.steps, args.dtype, args.overrides,
                         sample_mode=args.sample_mode)
    # init-weights baseline: 2 warmup steps at lr*1e-3 leaves the net at init
    if not any(d.startswith("model_") for d in os.listdir(init_dir)):
        train_cli(args.tree, init_dir, 2, args.dtype, args.overrides, seed=7,
                  sample_mode=args.sample_mode)

    table_trained = eval_cli(args.tree, trained_dir, trained_dir, args.sample_mode)
    table_init = eval_cli(args.tree, init_dir, init_dir, args.sample_mode)
    rec = epoch_record(trained_dir)

    print(f"\n=== convergence artifact ({args.dtype}, B=24, {args.steps} steps, "
          f"sample_mode={args.sample_mode}, overrides {args.overrides}) on {card()} ===")
    print(f"{'metric':>16s} | {'init':>7s} | {'trained':>7s}")
    for name in HEADLINE:
        print(f"{name:>16s} | {table_init[name]:7.1f} | "
              f"{table_trained[name]:7.1f}")
    print(f"train CLI wall {wall if wall is None else round(wall, 1)} s; epoch "
          f"{rec['epoch_s']:.1f} s: {rec['steps_per_s']:.3f} steps/s "
          f"({rec['steps_per_s_after_first']:.3f} after the first step), "
          f"{rec['data_wait_s']:.1f} s waiting for batches; loader "
          f"{int(rec['num_workers'])} workers, {rec['loader_samples_per_s']:.1f} samples/s "
          f"({rec['worker_samples_per_s']:.1f} per worker); eval harness "
          f"{table_trained['crops_per_s']:.1f} crops/s")
    with open(os.path.join(trained_dir, "convergence_tables.json"), "w") as f:
        json.dump({"init": table_init, "trained": table_trained, "steps": args.steps,
                   "dtype": args.dtype, "sample_mode": args.sample_mode,
                   "overrides": args.overrides, "train_wall_s": wall,
                   "epoch": rec, "card": card()}, f, indent=1)
    # the pass bar: the trained table must dwarf init on the coarse bins
    ok = (table_trained["3D IoU at 25"] > table_init["3D IoU at 25"] + 20
          and table_trained["10 degree, 10cm"]
          > table_init["10 degree, 10cm"] + 10)
    print("CONVERGENCE ARTIFACT", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
