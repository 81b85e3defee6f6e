#!/usr/bin/env python3
"""Readings that the limits of ``portbench/limits/<cell>.json`` are set from,
on the card, at the cell's own size, many seeds in one process:

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 3] [--out FILE.json]

For each seed it makes one run of the cell as ``run.py`` does, with a short
window, and reads the numbers compared against the reference (the
program's readings; the largest over the seeds is the lower reading of a
limit).  It then puts the reference itself in the program's place in the
nearest precision below the configuration's (``control``: TF32 operands for
float32, fp8 for bfloat16) and reads the same numbers against the float32
reference; for a training cell also the reference with half of each batch
left out and the loss the mean over the rest (``half_batch``).  The
smallest reading of a control or fault over the seeds is a limit's upper
reading.  A step that leaves the state unchanged reads 1 on
``update_gap`` by construction and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def half(batches, draws):
    """The first half of each batch's rows, and of its draws."""
    from portbench.inputs import Draws

    out_b, out_d = [], []
    for b, d in zip(batches, draws):
        h = next(iter(b.values())).shape[0] // 2
        out_b.append({k: v[:h] for k, v in b.items()})
        flags, up, down, defor = d.aug
        out_d.append(Draws((flags[:, :h], up[:h], down[:h], defor[:h]), d.pools,
                           tuple(k[:h] for k in d.keep)))
    return out_b, out_d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import manifest
    from portbench.kinds import serve, train
    from portbench.reference.precision import Precision

    cell, _ = manifest.find_cell(manifest.load(), args.workload)
    control = CONTROL[cell.dtype]
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            out = serve.run(cell, seed, args.seconds, False, "cuda", t0, yardstick=True)
            x = out.extra
            ctrl = serve.reference_poses(x["weights"], cell, x["pool"], x["ids"],
                                         x["pool_samples"], "cuda", Precision(control))
            readings = {"control": serve.gaps(ctrl, x["reference"], x["tier"])}
        else:
            out = train.run(cell, seed, args.seconds, False, "cuda", t0, yardstick=True)
            x = out.extra
            ctrl = train.reference_steps(cell, x["weights"], x["batches"], x["draws"],
                                         Precision(control))
            hb, hd = half(x["batches"], x["draws"])
            faulty = train.reference_steps(cell, x["weights"], hb, hd, Precision())
            readings = {"control": train.gaps(ctrl, x["reference"], x["tier"]),
                        "half_batch": train.gaps(faulty, x["reference"], x["tier"]),
                        "worst_leaves": train.worst_leaves(x["program"], x["reference"])}
            readings["program_losses"] = x["program"]["losses"]
            readings["reference_losses"] = x["reference"]["losses"]
        row = {"seed": seed, "program": out.extra["numbers"], **readings,
               "units": out.readings.window["units"], "setup_s": out.readings.setup_s,
               "memory_peak_bytes": out.memory_peak_bytes, "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out, x
    summary = {"workload": cell.name, "control": control,
               "lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for what in ("control", "half_batch"):
        if what in rows[0]:
            summary[what] = {k: min(r[what][k] for r in rows) for k in rows[0][what]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
