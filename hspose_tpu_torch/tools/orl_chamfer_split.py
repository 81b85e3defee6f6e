"""Where K9's, K10's and K16's to K18's time goes on one CUDA card: the
fused surface backward (``ops/cuda_hs_fused.py::hs_surface_fused_bwd``,
``csrc/hs_surface.cu``), the v4 step's ORL backward
(``ops/cuda_hs_fused.py::orl_global_fused_bwd``, ``csrc/orl.cu``), the
chamfer search (``ops/chamfer.py::chamfer_min_cuda`` and
``chamfer_min_argmin_cuda``) and its gradient (``chamfer_grad_cuda``,
``csrc/chamfer.cu``), per launch.

    python hspose_tpu_torch/tools/orl_chamfer_split.py --tree DIR [--out F.json]
        [--passes K9 K10 K16 K17 K18]

For the tree DIR (a checkout, such as a ``git archive`` of another commit) it
times, from seeded inputs:

* K10 at the B=16 v4 step's three ORL calls, conv_2 .. conv_4 ((C, N, K) =
  (256, 257, 20) twice and (512, 64, 8)), in fp32 and bf16, on the winners
  of the tree's K4 forward;
* K16 and K17 at the recon tier's shape (24, 1028) x (24, 1028), both
  directions, and K18 there for both clouds, on the tree's K17 argmins;
* K9 at the B=16 step's conv_0 (N=1028, K=20, S=7, Co=128) in fp32 and bf16,
  on the winners of the tree's K2 forward;

each call's device time (CUDA events, mean of 20 calls after 3, enqueued
behind a sleep kernel, as ``chip_smoke.py::cuda_ms``) and each launch's, by
kernel name (``torch.profiler`` over 10 calls after one, queued behind a
sleep kernel, as ``chip_smoke.py::launch_parts``), summed over one pass: the
step's three calls, or the search's two directions.  It prints one JSON
object (and writes it to F.json): per pass, the call time, and per kernel
its launches per call and its time.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

QUEUE_CYCLES = 20_000_000  # the sleep kernel ahead of the timed calls (about 10 ms)
CALLS = 10


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn) -> dict:
    """Kernel (short name) -> (launches per call, device ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        if "spin_kernel" in e.name:  # torch.cuda._sleep's
            continue
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.name)
        name = (m.group(1) + (m.group(2) or "")) if m else e.name[:60]
        n, ms = out.get(name, (0, 0.0))
        out[name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {k: (n / CALLS, ms / CALLS) for k, (n, ms) in out.items()}


def add(total: dict, label: str, ms: float, kernels: dict) -> None:
    e = total.setdefault(label, {"ms": 0.0, "kernels": {}})
    e["ms"] += ms
    for name, (n, kms) in kernels.items():
        k = e["kernels"].setdefault(name, {"launches_per_call": n, "ms": 0.0})
        k["ms"] += kms


def collect(tree: str, passes=("K9", "K10", "K16", "K17", "K18")) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import hspose_tpu_torch
    from hspose_tpu_torch.ops import chamfer as ch, cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda

    where = Path(hspose_tpu_torch.__file__).resolve()
    if Path(tree).resolve() not in where.parents:
        raise RuntimeError(f"imported {where}, not the tree {tree}")
    dev = "cuda"
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def unit(n):
        d = normal(3, n)
        return d / d.norm(dim=0, keepdim=True)

    total = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16) if "K10" in passes else ():
            label = f"K10 {'fp32' if dtype == torch.float32 else 'bf16'} per v4 step"
            for c, n, k in [(256, 257, 20), (256, 257, 20), (512, 64, 8)]:
                feat = normal(16, n, c).to(dtype)
                idx = knn_indices_cuda(normal(16, n, 3, scale=0.2), k)
                win, gb = f.orl_global_fused_fwd(feat, idx)[1], normal(16, 1, c)

                def bwd():
                    return f.orl_global_fused_bwd(idx, win, gb, dtype)

                add(total, label, call_ms(bwd), kernel_ms(bwd))
        a = normal(24, 1028, 3, scale=0.2)
        b = (normal(24, 1028, 3, scale=0.2) + 0.05).contiguous()
        for label, fn in (("K16 per pass", ch.chamfer_min_cuda),
                          ("K17 per pass", ch.chamfer_min_argmin_cuda)):
            if label[:3] not in passes:
                continue
            for x, y in ((a, b), (b, a)):
                add(total, label, call_ms(lambda: fn(x, y)), kernel_ms(lambda: fn(x, y)))
        if "K18" in passes:  # both clouds' gradients: one pass of the backward
            ia, ib = ch.chamfer_min_argmin_cuda(a, b)[1], ch.chamfer_min_argmin_cuda(b, a)[1]
            gda, gdb = normal(24, 1028), normal(24, 1028)
            for args in ((a, b, ia, ib, gda, gdb), (b, a, ib, ia, gdb, gda)):
                add(total, "K18 per pass", call_ms(lambda: ch.chamfer_grad_cuda(*args)),
                    kernel_ms(lambda: ch.chamfer_grad_cuda(*args)))
        for fast in (False, True) if "K9" in passes else ():
            verts = normal(16, 1028, 3, scale=0.2)
            idx = knn_indices_cuda(verts, 20, packed=fast)
            dirs, gb = unit(7 * 128), normal(16, 1028, 128)
            win = f.hs_surface_fused_fwd(verts, idx, dirs, 7, 128, exact=not fast)[1]

            def bwd():
                return f.hs_surface_fused_bwd(verts, idx, dirs, win, gb, 7, 128, exact=not fast)

            add(total, f"K9 {'bf16' if fast else 'fp32'} conv_0", call_ms(bwd), kernel_ms(bwd))
    return {"tree": tree, "card": torch.cuda.get_device_name(0), "passes": total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose hspose_tpu_torch to run")
    ap.add_argument("--out", help="where to write the JSON object")
    ap.add_argument("--passes", nargs="+", default=["K9", "K10", "K16", "K17", "K18"],
                    choices=["K9", "K10", "K16", "K17", "K18"], help="what to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("orl_chamfer_split: no CUDA device", file=sys.stderr)
        return 2
    res = collect(args.tree, args.passes)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
