"""Where a train step's or a serving forward's time goes on one CUDA card,
per tier.

    python hspose_tpu_torch/tools/profile_train.py [--tiers float32 bfloat16 v4 bf16v4 serve bf16serve] [--out FILE.json]

A tier is a ``compute_dtype``, or ``v4`` / ``bf16v4``: fp32 / bf16 with
``bwd_store=False`` and ``train_v4_small=True``, or ``serve`` / ``bf16serve``:
the serving forward (``eval_forward`` + ``generate_RT`` under no_grad) at
B=24 in fp32 / bf16, a "step" being one forward, where the kernels of K1
(the KNN), K2 (the HS surface reduction), K3 (the HS support projection and
reduction) and K4 (the ORL reduction) are also summed apart, with their
launches; in the training tiers the kernels of K11 (the HS support forward:
its projection and reduction), K13 and K14 (the HS support backward: its
rows, reduction and recompute kernels, and before them its W transposes), K8
(the fused support backward), K12 (the HS surface forward) and K15 (its
backward: the routing kernel and, from the redesign that gave it its own,
its partial sum) are summed the same way (``TRAIN_GROUPS``), beside the
shared partial-sum kernel that each of their calls (and other backwards')
also launches.  To compare two trees, run this script's copy in
both.  For each
training tier: ``build_train_step`` at B=16, N=1028 with
seeded random weights and 3 warm-up steps; then every tier is timed without the profiler
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
SERVE_B = 24
SERVE_TIERS = {"serve": "float32", "bf16serve": "bfloat16"}
# kernels of the serving forward's K1-K4, by name (csrc/knn.cu, csrc/hs_surface.cu,
# csrc/hs_support.cu, csrc/orl.cu; PyTorch's own reductions are at::native::reduce_kernel);
# K3's fp32 projection and K4 also by the names of the launches they replaced
# (project_f32_kernel; orl_partial_kernel, orl_finish_kernel), so that a tree
# from before them profiles alike
GROUPS = {"K1": ("(anonymous namespace)::knn_kernel<",),
          "K2": ("(anonymous namespace)::surface_kernel<",),
          "K3": ("hsp::gemm_kernel<float, false, false, false",
                 "(anonymous namespace)::project_f32_kernel(",
                 "(anonymous namespace)::project_bf16_kernel(",
                 "(anonymous namespace)::reduce_kernel<"),
          "K4": ("(anonymous namespace)::orl_kernel<",
                 "(anonymous namespace)::orl_partial_kernel<",
                 "(anonymous namespace)::orl_finish_kernel(")}
# the training tiers' kernels of K11 (csrc/hs_support_train.cu: its projection
# tile, csrc/hs_project.cuh, and its reduction; in the fp32 v4 tier K3's
# projection has the same instantiation and is counted here too, in every
# tree), K13/K14 (the fp32 instantiations of hs::transpose_w_kernel are
# theirs alone in trees that still transpose W) and K8 (csrc/hs_fused_bwd.cuh
# with SUPPORT, csrc/hs_support.cu; its inverse lists are shared with K10 and
# left out), K12 and K15 (csrc/hs_surface_train.cu), by the names of this
# tree and of the trees before it, and hs::sum_partials_kernel, which K13,
# K14, K8, K9 and K10 all launch (and K15 in the trees before its own
# partial sum, hs::sum_tiles_kernel, which K9 launches too)
TRAIN_GROUPS = {"K11": ("(anonymous namespace)::support_fwd_kernel<",
                        "hsp::gemm_kernel<float, false, false, false",
                        "hsp::gemm_kernel<__nv_bfloat16, false, false, true",
                        "(anonymous namespace)::project_f32_kernel("),
                "K13/K14": ("(anonymous namespace)::support_bwd_rows_kernel<",
                            "(anonymous namespace)::support_bwd_reduce_kernel<",
                            "(anonymous namespace)::recompute_kernel<",
                            "transpose_w_kernel<false, float>", "transpose_w_kernel<true, float>"),
                "K8": ("hsb::route_kernel<true,", "hsb::rf_grad_kernel<",
                       "hsb::dd_partial_kernel<true,", "hsb::source_kernel<true,",
                       "hsb::source_proj_kernel<", "hsb::dverts_kernel<",
                       "(anonymous namespace)::dg_rows_kernel", "dfeat_source_kernel",
                       "transpose_w_kernel<true, __nv_bfloat16>",
                       "(anonymous namespace)::project_kernel<", "hsp::gemm_kernel<float, false, true",
                       "hsp::gemm_kernel<float, true", "hsp::gemm_kernel<__nv_bfloat16, true"),
                "K12": ("(anonymous namespace)::surface_fwd_kernel<",),
                "K15": ("(anonymous namespace)::surface_bwd_kernel<",
                        "sum_tiles_kernel("),
                "partial sums (shared)": ("sum_partials_kernel",)}


def prepare_serve(dtype: str):
    """A warmed-up serving forward of one tier: a function that runs STEPS
    forwards and returns the wall ms per forward."""
    import torch

    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import build_model, eval_forward

    torch.manual_seed(0)
    model = build_model(ModelConfig(compute_dtype=dtype), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    pc = torch.randn((SERVE_B, N, 3), device="cuda", generator=g) * 0.2
    obj = torch.arange(SERVE_B, device="cuda") % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device="cuda").repeat(SERVE_B, 1)

    def serve():
        with torch.no_grad():
            o = eval_forward(model, pc, obj, generator=g)
            generate_RT(o.p_green_R, o.p_red_R, o.f_green_R, o.f_red_R, o.pred_T, sym)

    for _ in range(WARMUP):
        serve()
    torch.cuda.synchronize()

    def timed_steps() -> float:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            serve()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    return timed_steps


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
    out = {"tier": dtype, "wall_ms": wall, "wall_windows_ms": walls,
           "profiled_wall_ms": profiled_wall, "kernel_ms": device,
           "idle_share": 1.0 - device / wall,
           "launches": sum(v[1] for v in kernels.values()) / STEPS,
           "top": [{"kernel": name[:90], "ms": ms, "calls": n / STEPS}
                   for name, (ms, n) in top]}
    out["groups"] = {}
    for g, pats in (GROUPS if dtype in SERVE_TIERS else TRAIN_GROUPS).items():
        hits = [v for name, v in kernels.items() if any(p in name for p in pats)]
        out["groups"][g] = {"ms": sum(ms for ms, _ in hits),
                            "launches": sum(n for _, n in hits) / STEPS}
    return out


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
    runs = {t: prepare_serve(SERVE_TIERS[t]) if t in SERVE_TIERS else prepare(t)
            for t in args.tiers}
    walls = {t: [] for t in args.tiers}
    for _ in range(3):
        for t in args.tiers:
            walls[t].append(runs[t]())
    results = [profile(t, runs[t], walls[t]) for t in args.tiers]
    for r in results:
        what = (f"serving forward, B={SERVE_B}" if r["tier"] in SERVE_TIERS
                else f"train step, B={B}")
        print(f"{r['tier']} {what}, N={N}, {card}: wall {r['wall_ms']:.3f} ms "
              f"(windows {', '.join(f'{w:.3f}' for w in r['wall_windows_ms'])}; "
              f"{r['profiled_wall_ms']:.3f} under the profiler), device kernels "
              f"{r['kernel_ms']:.3f} ms, idle {r['idle_share']:.3f}, "
              f"{r['launches']:.0f} launches per step"
              + "".join(f", {g} {v['ms']:.3f} ms ({v['launches']:.0f} launches)"
                        for g, v in r.get("groups", {}).items()))
        for k in r["top"]:
            print(f"  {k['ms']:8.3f} ms {k['calls']:6.1f} calls  {k['kernel']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
