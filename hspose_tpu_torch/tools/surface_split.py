"""Where K12's and K15's time goes on one CUDA card: the training path's HS
surface forward and backward (``ops/cuda_hs.py::hs_surface_fwd`` /
``hs_surface_bwd``, ``csrc/hs_surface_train.cu``) at the B=16, N=1028 train
step's conv_0 shape (K=20, S=7, Co=128), in both tiers.

    python hspose_tpu_torch/tools/surface_split.py --tree DIR [--clock]

For the tree DIR (a checkout, such as a ``git archive`` of another commit) it
prints each call's device time (CUDA events, mean of 20 calls after 3,
enqueued behind a sleep kernel, as ``chip_smoke.py::cuda_ms``) and each
launch's (``torch.profiler`` over 10 calls, by kernel name, as
``chip_smoke.py::launch_parts``).

``--clock`` also splits the backward's first launch of the design before the
redesign (a block per 16-query tile walking 32-column chunks, the tree's
``surface_bwd_kernel`` as it stood up to the commit that replaced it): it
builds a copy of the tree's ``csrc/hs_surface_train.cu`` with ``clock64()``
marks at the chunk loop's phase boundaries, and prints thread 0's cycles per
block in staging (winners, cotangents, directions), the dd partial, the drf
walk and the barrier wait, with their shares.  A tree whose source lacks the
marked lines is refused.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

QUEUE_CYCLES = 20_000_000  # the sleep kernel ahead of the timed calls (about 10 ms)
B, N, K, S, CO = 16, 1028, 20, 7, 128

# the replaced backward's phase boundaries: (source line, mark inserted after it)
CLOCK_MARKS = [
    ("  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;\n",
     "  long long c_stage = 0, c_dd = 0, c_drf = 0, c_wait = 0, c_all = clock64();\n"),
    ("  for (int c0 = 0; c0 < SC; c0 += CH) {\n", "    long long t0 = clock64();\n"),
    ("    // this block's partial of dd, its queries added in order\n",
     "    long long t1 = clock64();\n"),
    ("    // drf: each (query, k) row collects the columns it won\n",
     "    long long t2 = clock64();\n"),
]
CLOCK_LOOP_END = ("      sdrf[r * 3 + 2] = a2;\n    }\n    __syncthreads();\n  }\n",
                  "      sdrf[r * 3 + 2] = a2;\n    }\n    long long t3 = clock64();\n"
                  "    __syncthreads();\n    long long t4 = clock64();\n"
                  "    c_stage += t1 - t0; c_dd += t2 - t1; c_drf += t3 - t2; c_wait += t4 - t3;\n"
                  "  }\n")
CLOCK_KERNEL_END = (
    "  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) hs::store_f(drfb + e, sdrf[e]);\n}\n",
    "  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) hs::store_f(drfb + e, sdrf[e]);\n"
    "  if (threadIdx.x == 0) {\n"
    "    atomicAdd(&g_clk[0], (unsigned long long)c_stage);\n"
    "    atomicAdd(&g_clk[1], (unsigned long long)c_dd);\n"
    "    atomicAdd(&g_clk[2], (unsigned long long)c_drf);\n"
    "    atomicAdd(&g_clk[3], (unsigned long long)c_wait);\n"
    "    atomicAdd(&g_clk[4], (unsigned long long)(clock64() - c_all));\n"
    "    atomicAdd(&g_clk[5], 1ull);\n  }\n}\n")
CLOCK_API = """
extern "C" int clk_zero() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
extern "C" int clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
"""


def inputs(dtype):
    """Seeded conv_0 inputs: rf of a cloud's 20 nearest neighbours, unit
    directions, the cotangent gb (fp32), in the tier's operand dtype."""
    import numpy as np
    import torch

    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import neighbor_directions_normalized

    rng = np.random.default_rng(0)
    verts = torch.from_numpy((rng.normal(size=(B, N, 3)) * 0.2).astype(np.float32)).cuda()
    idx = knn_indices_cuda(verts, K, packed=dtype == torch.bfloat16)
    rf = neighbor_directions_normalized(verts.to(dtype), idx)
    d = torch.from_numpy(rng.normal(size=(3, S * CO)).astype(np.float32)).cuda()
    gb = torch.from_numpy(rng.normal(size=(B, N, CO)).astype(np.float32)).cuda()
    return rf, (d / d.norm(dim=0, keepdim=True)).to(dtype), gb


def call_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
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


def launch_ms(fn, calls: int = 10) -> dict:
    """Mean device ms per launch and launches per call, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        if "spin_kernel" in e.name or "sleep" in e.name:
            continue
        name = e.name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
        t = out.setdefault(name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3
        t[1] += 1
    return {k: (ms / n, n / calls) for k, (ms, n) in out.items()}


def clock_split(tree: Path, dtype, args) -> str:
    """Build the clock64-marked copy of the tree's backward and split one call."""
    import torch

    from hspose_tpu_torch.ops import _build

    src = (tree / "hspose_tpu_torch" / "csrc" / "hs_surface_train.cu").read_text()
    for old, new in CLOCK_MARKS + [CLOCK_LOOP_END, CLOCK_KERNEL_END]:
        if src.count(old) != 1:
            raise SystemExit(f"--clock: {tree} is not the design this split marks "
                             f"(line not found once: {old.strip()!r})")
        src = src.replace(old, old + new if (old, new) in CLOCK_MARKS else new)
    src = src.replace("namespace {\n", "__device__ unsigned long long g_clk[8];\nnamespace {\n", 1)
    work = Path(tempfile.mkdtemp(prefix="surface_split_"))
    for h in (tree / "hspose_tpu_torch" / "csrc").glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    (work / "marked.cu").write_text(src + CLOCK_API)
    lib_path = work / "libmarked.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(work / "marked.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.hs_surface_bwd.argtypes = _build.SIGNATURES["hs_surface_bwd"]
    lib.hs_surface_bwd_parts.argtypes = _build.SIGNATURES["hs_surface_bwd_parts"]
    rf, d, win, gb = args
    partial = torch.empty((lib.hs_surface_bwd_parts(B, N), 3, S * CO), device="cuda")
    drf, dd = torch.empty_like(rf), torch.empty((3, S * CO), device="cuda")

    def call():
        lib.hs_surface_bwd(rf.data_ptr(), d.data_ptr(), win.data_ptr(), gb.data_ptr(),
                           drf.data_ptr(), partial.data_ptr(), dd.data_ptr(), B, N, K, S, CO,
                           int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)

    call()
    torch.cuda.synchronize()
    lib.clk_zero()
    call()
    torch.cuda.synchronize()
    v = (ctypes.c_ulonglong * 8)()
    lib.clk_read(v)
    stage, ddp, walk, wait, whole, blocks = list(v)[:6]
    return (f"clock64, thread 0, cycles per block ({blocks} blocks): staging {stage / blocks:.0f}, "
            f"dd partial {ddp / blocks:.0f}, drf walk {walk / blocks:.0f}, barrier wait "
            f"{wait / blocks:.0f}, whole {whole / blocks:.0f}; shares {stage / whole:.3f}, "
            f"{ddp / whole:.3f}, {walk / whole:.3f}, {wait / whole:.3f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose hspose_tpu_torch to run")
    ap.add_argument("--clock", action="store_true",
                    help="also split the replaced backward's first launch by clock64")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("surface_split: no CUDA device", file=sys.stderr)
        return 2
    import hspose_tpu_torch
    from hspose_tpu_torch.ops import cuda_hs

    if tree not in Path(hspose_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {hspose_tpu_torch.__file__}, not the tree {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{tree}, {card}, B={B} N={N} K={K} S={S} Co={CO}")
    for dtype in (torch.float32, torch.bfloat16):
        rf, d, gb = inputs(dtype)
        _, win = cuda_hs.hs_surface_fwd(rf, d, S, CO)
        fwd = lambda: cuda_hs.hs_surface_fwd(rf, d, S, CO)  # noqa: E731
        bwd = lambda: cuda_hs.hs_surface_bwd(rf, d, win, gb, S, CO)  # noqa: E731
        for name, fn in (("K12", fwd), ("K15", bwd)):
            parts = ", ".join(f"{k} {ms:.4f} ms x {n:g}" for k, (ms, n) in launch_ms(fn).items())
            print(f"  {name} {dtype}: {call_ms(fn):.4f} ms a call; launches: {parts}")
        if args.clock:
            print(f"  K15 {dtype} first launch, " + clock_split(tree, dtype, (rf, d, win, gb)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
