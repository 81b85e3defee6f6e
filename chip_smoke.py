"""Drive the PyTorch port's serving path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. environment: card name and power limit, torch / CUDA / nvcc versions,
   whether triton imports; TF32 off for matrix products and cuDNN;
2. build: the kernels of ``hspose_tpu_torch/csrc`` with nvcc (sm_90a);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at every shape the B=24, N=1028 forward gives it, with kernel and plain
   times from CUDA events;
4. slice: ``PoseNet9D`` at full width with seeded random weights serves a few
   (24, 1028, 3) requests through ``eval_forward`` and ``generate_RT``; the
   launch counters must show 9 KNN, 1 surface, 4 support and 5 ORL launches
   per forward, the poses must be finite and orthonormal, and the same
   weights, input and pooling samples through the plain ops on the CPU must
   agree within 1e-3;
5. throughput: crops/s at B=24, fp32, best of 3 windows.

The line before the last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits with code 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, N = 24, 1028  # the serving batch and points per crop
DEVICE = "cuda"
REQUESTS = 3
TOL_REL = 1e-4  # K2-K4: max |kernel - plain| <= TOL_REL * max |plain| (summation order)
KNN_AGREE = 0.999  # K1: share of kernel neighbours in the plain version's set
KNN_TIE_REL = 1e-5  # K1: sorted neighbour distances agree to this (fp32 near-ties)
SLICE_ATOL = 1e-3  # card against CPU on the pose outputs
SEED = 0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> str:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    log("env", f"card: {smi}")
    log("env", f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
               f"python {sys.version.split()[0]}")
    from hspose_tpu_torch.ops import _build

    log("env", "nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton  # noqa: F401
        log("env", f"triton {triton.__version__} imports")
    except ImportError as e:
        log("env", f"triton does not import: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off (cuda.matmul, cudnn)")
    return smi


def phase_build() -> None:
    from hspose_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    how = ("built" if _build.build_seconds is not None else "found cached")
    log("build", f"{how} {_build.library_path().name} in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s; "
                 f"ptxas report in {_build.library_path().with_suffix('.log').name})")


def cloud(rng, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.normal(scale=0.2, size=(B, n, 3)).astype(np.float32)).to(DEVICE)


def normal(rng, *shape, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE)


def unit_dirs(rng, n: int) -> torch.Tensor:
    d = normal(rng, 3, n)
    return d / d.norm(dim=0, keepdim=True)


def phase_kernels() -> dict:
    """Every kernel against its plain version at the forward's shapes.
    Returns per-kernel records; ms and plain_ms sum the forward's calls."""
    from hspose_tpu_torch.ops.cuda_hs_fused import (
        hs_support_fused, hs_support_plain, hs_surface_fused, hs_surface_plain,
        orl_global_fused, orl_global_plain)
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices

    rng = np.random.default_rng(SEED)
    n1, n2 = N // 4, N // 16
    clouds = {n: cloud(rng, n) for n in (N, n1, n2)}
    rec = {}

    def add(name, err, ms, plain_ms):
        r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms

    # K1: the nine searches of one forward, (points, D, k)
    for n, d, k in [(N, 3, 20), (N, 128, 20), (N, 3, 4),
                    (n1, 3, 20), (n1, 128, 20), (n1, 256, 20), (n1, 3, 4),
                    (n2, 3, 8), (n2, 256, 8)]:
        pts = clouds[n] if d == 3 else normal(rng, B, n, d)
        got, want = knn_indices_cuda(pts, k), knn_indices(pts, k)
        torch.cuda.synchronize()
        agree = (got[..., :, None] == want[..., None, :]).any(-1).double().mean().item()
        p64 = pts.double()

        def sorted_d(idx):
            diff = gather_neighbors(p64, idx) - p64[:, :, None]
            return (diff * diff).sum(-1).sort(-1).values

        dg, dw = sorted_d(got), sorted_d(want)
        err = (dg - dw).abs().max().item()
        rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
        ms = cuda_ms(lambda: knn_indices_cuda(pts, k))
        pms = cuda_ms(lambda: knn_indices(pts, k))
        log("kernels", f"K1 knn N={n} D={d} k={k}: agreement {agree:.6f}, max rel "
                       f"distance gap {rel:.3e}, {ms:.4f} ms (plain {pms:.4f} ms)")
        if agree < KNN_AGREE or rel > KNN_TIE_REL:
            raise AssertionError(f"K1 knn N={n} D={d} k={k} disagrees with its plain "
                                 f"version: agreement {agree}, distance gap {rel}")
        add("knn", err, ms, pms)

    def close(name, label, got, want, ms, pms):
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log("kernels", f"{name} {label}: max abs err {err:.3e} (bound "
                       f"{TOL_REL * scale:.3e}), {ms:.4f} ms (plain {pms:.4f} ms)")
        if not err <= TOL_REL * scale:
            raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}")
        add(name, err, ms, pms)

    S = 7
    # K2: conv_0
    verts, idx = clouds[N], knn_indices_cuda(clouds[N], 20)
    dirs = unit_dirs(rng, S * 128)
    args = (verts, idx, dirs, S, 128)
    close("hs_surface", f"conv_0 N={N} K=20 Co=128", hs_surface_fused(*args),
          hs_surface_plain(*args), cuda_ms(lambda: hs_surface_fused(*args)),
          cuda_ms(lambda: hs_surface_plain(*args)))

    # K3: conv_1 .. conv_4, weights as column slices of the (Cin, (S+1)Co) matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, n1, 20),
                                 (3, 256, 256, n1, 20), (4, 256, 512, n2, 8)]:
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        args = (normal(rng, B, n, cin), clouds[n], knn_indices_cuda(clouds[n], k),
                w_full[:, co:], b_full[co:], unit_dirs(rng, S * co), S, co)
        close("hs_support", f"conv_{layer} {cin}->{co} N={n} K={k}",
              hs_support_fused(*args), hs_support_plain(*args),
              cuda_ms(lambda: hs_support_fused(*args)),
              cuda_ms(lambda: hs_support_plain(*args)))

    # K4: the ORL branch of each layer
    for layer, c, n, k in [(0, 128, N, 20), (1, 128, N, 20), (2, 256, n1, 20),
                           (3, 256, n1, 20), (4, 512, n2, 8)]:
        feat, idx = normal(rng, B, n, c), knn_indices_cuda(clouds[n], k)
        close("orl_global", f"conv_{layer} C={c} N={n} K={k}",
              orl_global_fused(feat, idx), orl_global_plain(feat, idx),
              cuda_ms(lambda: orl_global_fused(feat, idx)),
              cuda_ms(lambda: orl_global_plain(feat, idx)))
    return rec


def build_seeded_model(device):
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    model = build_model(ModelConfig(), device=device)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):  # running statistics that matter
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


def counters():
    from hspose_tpu_torch.ops import cuda_hs_fused, cuda_knn

    return {"knn": cuda_knn.knn_indices_cuda, "hs_surface": cuda_hs_fused.hs_surface_fused,
            "hs_support": cuda_hs_fused.hs_support_fused,
            "orl_global": cuda_hs_fused.orl_global_fused}


def phase_slice() -> dict:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward

    model = build_seeded_model(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    obj = torch.arange(B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [cloud(rng, N) for _ in range(REQUESTS)]
    samples = [draw_pool_samples(N, gen, DEVICE) for _ in range(REQUESTS)]

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    results = []
    for pc, smp in zip(requests, samples):
        out = eval_forward(model, pc, obj, pool_samples=smp)
        results.append((out, generate_RT(out.p_green_R, out.p_red_R, out.f_green_R,
                                         out.f_red_R, out.pred_T, sym)))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    want = {"knn": 9, "hs_surface": 1, "hs_support": 4, "orl_global": 5}
    log("slice", f"{REQUESTS} requests of ({B}, {N}, 3): launches {launches}")
    for name, per_forward in want.items():
        if launches[name] != per_forward * REQUESTS:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{per_forward} per forward")

    eye = torch.eye(3, device=DEVICE)
    for i, (out, RT) in enumerate(results):
        for name, v in zip(out._fields, out):
            if not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {name} is not finite")
        R = RT[:, :3, :3]
        ortho = (R.transpose(1, 2) @ R - eye).abs().max().item()
        det = (torch.linalg.det(R) - 1).abs().max().item()
        log("slice", f"request {i}: |R^T R - I| {ortho:.2e}, |det R - 1| {det:.2e}, "
                     f"RT shape {tuple(RT.shape)}")
        if not (ortho < 1e-4 and det < 1e-4 and RT.shape == (B, 4, 4)):
            raise AssertionError(f"request {i}: R is not a rotation")

    # the same weights, input and pooling samples through the plain ops on the CPU
    cpu_model = copy.deepcopy(model).to("cpu")
    out_cpu = eval_forward(cpu_model, requests[0].cpu(), obj.cpu(),
                           pool_samples=[s.cpu() for s in samples[0]])
    RT_cpu = generate_RT(out_cpu.p_green_R, out_cpu.p_red_R, out_cpu.f_green_R,
                         out_cpu.f_red_R, out_cpu.pred_T, sym.cpu())
    out, RT = results[0]
    diffs = {name: (a.cpu() - b).abs().max().item()
             for name, a, b in zip(out._fields, out, out_cpu)}
    diffs["RT"] = (RT.cpu() - RT_cpu).abs().max().item()
    log("slice", "card against CPU plain ops, max abs diff: "
                 + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= SLICE_ATOL}
    if bad:
        raise AssertionError(f"card and CPU disagree beyond {SLICE_ATOL}: {bad}")
    return launches


def phase_throughput(smi: str) -> None:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    model = build_seeded_model(DEVICE)
    pc = cloud(np.random.default_rng(SEED + 3), N)
    obj = torch.arange(B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def serve():
        out = eval_forward(model, pc, obj, generator=gen)
        return generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                           out.pred_T, sym)

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    iters, rates = 20, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            serve()
        torch.cuda.synchronize()
        rates.append(B * iters / (time.perf_counter() - t0))
    log("throughput", f"{max(rates)} crops/s at B={B} fp32 (best of 3 windows of "
                      f"{iters} forwards: {rates}) on {smi}")


SOURCES = {
    "knn": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:163"),
    "hs_surface": ("hspose_tpu_torch/csrc/hs_surface.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:299"),
    "hs_support": ("hspose_tpu_torch/csrc/hs_support.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:219"),
    "orl_global": ("hspose_tpu_torch/csrc/orl.cu", "hspose_tpu/ops/pallas_hs_fused.py:358"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    rec = phase_kernels()
    launches = phase_slice()
    phase_throughput(smi)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **rec[name]}
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
