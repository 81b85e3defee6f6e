"""Where a train step's time goes on one CUDA card, per tier.

    python hspose_tpu_torch/tools/profile_train.py [--tiers float32 bfloat16 v4 bf16v4] [--out FILE.json]

A tier is a ``compute_dtype``, or ``v4`` / ``bf16v4``: fp32 / bf16 with
``bwd_store=False`` and ``train_v4_small=True``.  For each tier: ``build_train_step`` at B=16, N=1028 with seeded random
weights and 3 warm-up steps; then every tier is timed without the profiler
(best of 3 windows of 5 steps, the tiers in turn), and only then is each
profiled over 5 steps (CPU and CUDA activities): launches after a profiler
session are slower, so no unprofiled window follows one.  Prints, per step:
the wall time (host clock around the unprofiled window, ending in
``torch.cuda.synchronize()``), the same under the profiler, the device
kernel time (the CUDA kernels' own time; the profiler's user annotations on
the device timeline, such as ``Optimizer.step``, are not kernels and are
left out), the idle share (1 - kernel time / unprofiled wall), the number of
kernel launches, and the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

B, N, STEPS, WARMUP, TOP = 16, 1028, 5, 3, 12


def prepare(dtype: str):
    """A warmed-up train step of one tier: a function that runs STEPS steps
    and returns the wall ms per step."""
    import torch

    from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    flags = {"v4": ("float32", False, True), "bf16v4": ("bfloat16", False, True)}
    dt, store, v4 = flags.get(dtype, (dtype, True, False))
    cfg = HSPoseConfig(model=ModelConfig(compute_dtype=dt, bwd_store=store, train_v4_small=v4))
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cuda", train_heads=True)
    step = build_train_step(cfg, model, torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(synthetic_train_batch(B, N, seed=0), "cuda")
    for _ in range(WARMUP):
        step(batch)
    torch.cuda.synchronize()

    def timed_steps() -> float:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    return timed_steps


def profile(dtype: str, timed_steps, walls: list[float]) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = timed_steps()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3 / STEPS  # us -> ms per step
            k[1] += 1
    device = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    wall = min(walls)
    return {"tier": dtype, "wall_ms": wall, "wall_windows_ms": walls,
            "profiled_wall_ms": profiled_wall, "kernel_ms": device,
            "idle_share": 1.0 - device / wall,
            "launches": sum(v[1] for v in kernels.values()) / STEPS,
            "top": [{"kernel": name[:90], "ms": ms, "calls": n / STEPS}
                    for name, (ms, n) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiers", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {t: prepare(t) for t in args.tiers}
    walls = {t: [] for t in args.tiers}
    for _ in range(3):
        for t in args.tiers:
            walls[t].append(runs[t]())
    results = [profile(t, runs[t], walls[t]) for t in args.tiers]
    for r in results:
        print(f"{r['tier']} train step, B={B}, N={N}, {card}: wall {r['wall_ms']:.2f} ms "
              f"(windows {', '.join(f'{w:.2f}' for w in r['wall_windows_ms'])}; "
              f"{r['profiled_wall_ms']:.2f} under the profiler), device kernels "
              f"{r['kernel_ms']:.2f} ms, idle {r['idle_share']:.3f}, "
              f"{r['launches']:.0f} launches per step")
        for k in r["top"]:
            print(f"  {k['ms']:8.3f} ms {k['calls']:6.1f} calls  {k['kernel']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
