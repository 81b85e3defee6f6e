#!/usr/bin/env python3
"""Run one cell of the benchmark of ``hspose_tpu_torch`` once, on the CUDA
card of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's traffic mix names its kind, whose
module (``portbench/kinds/<kind>.py``) drives the program.  ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics,
from ``trace_units`` requests or steps profiled before the window, and the
``breakdown``.
Every run compares what its window produced with the plain reference
(``portbench/reference``) and prints each number compared beside its
limit, as the last lines of standard error and under ``checks``, the last
key of the result.  The result is the last line of standard output, one
JSON object.  Without a card, with fewer cards than the cell asks for, or
with JAX loaded once the window has closed, it prints no result and exits
with a code other than 0; so it does for a cell that asks for more chips
than its traffic kind drives.  The kernels' build, the Triton and extension
caches live under ``build/`` in the checkout, at fixed paths.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "hspose_tpu")


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - started)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = process_start()


def environment() -> None:
    """The program's build and kernel caches at fixed paths in the checkout,
    and one host thread for CPU ops: the run's load comes from one process
    with few threads."""
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    from portbench import kinds, manifest
    from portbench.readings import reader
    from portbench.trace import is_port_kernel

    bench = manifest.load()
    cell, work = manifest.find_cell(bench, args.workload)
    kind = kinds.load(cell.traffic["kind"])
    if work["chips"] > kind.CHIPS:
        print(f"portbench: the cell asks for {work['chips']} chips; traffic kind "
              f"{cell.traffic['kind']!r} drives {kind.CHIPS}", file=sys.stderr)
        return 3
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"portbench: the cell needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    import hspose_tpu_torch  # noqa: F401  (the system under test; absent: no result)

    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 4

    r = out.readings
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, section, cell.name):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(out.extra["device"])
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device, "card": card()}
    if r.trace is not None:
        device["busy_s"] = r.trace.busy_s()
        device["window_s"] = r.trace.window_s
        result["breakdown"] = {"device_ops": r.trace.top_ops(),
                               "idle_gaps": r.trace_host.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    w = r.window
    print(f"portbench: {cell.name} seed {args.seed}: {w['units']} "
          f"{'requests' if r.kind == 'serve' else 'steps'} in {w['elapsed_s']:.3f} s, "
          f"{w.get('crops', w.get('samples'))} {'crops' if r.kind == 'serve' else 'samples'}, "
          f"{out.failed} failed; set-up {r.setup_s:.3f} s"
          + (f"; traced {r.trace.units} over {r.trace.window_s:.4f} s" if r.trace else ""))
    if r.trace is not None:
        for name, spent in r.trace.top_ops():
            print(f"traced {'port' if is_port_kernel(name) else 'library'} kernel {spent:.6f} s "
                  f"{name}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
