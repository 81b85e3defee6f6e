"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

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
5. throughput: crops/s at B=24, fp32, best of 3 windows;
6. training kernels: K12, K15, K11 and K13 against their plain versions at
   every shape of the B=16, N=1028 train step: forwards within 1e-4 of the
   largest value, winners equal on >= 99.9% of entries and near-ties where
   not; backwards fed the same residuals as their plain versions, every
   cotangent within 1e-4 of its largest value; kernel and plain times;
7. training slice: ``build_train_step`` at full width takes 3 steps on a
   (16, 1028) synthetic batch; the launch counters must show 9 KNN, 1 + 1
   surface and 4 + 4 support training launches per step and no serving
   launch, the losses must be finite, the parameters move and the optimizer
   count advance; one train forward and backward at B=4 on the card and on
   the CPU plain ops, with the same weights, batch and draws, must agree
   (losses within 1e-3 relative, parameter gradients within the N=1028
   gates of tests/test_torch_parity.py); then steps/s at B=16.

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
TRAIN_B = 16  # the train batch (train.batch_size)
TRAIN_STEPS = 3
WIN_AGREE = 0.999  # K11, K12: share of winners equal to the plain version's
LOSS_REL = 1e-3  # card against CPU, each loss term
GRAD_LEAF = (0.98, 0.2, 0.9, 1.1)  # per leaf: min cos, max norm_rel, norm ratio range
GRAD_COS = 0.9995  # all parameter gradients as one vector
ZERO_LEAF = 1e-5  # a leaf gradient below this share of the largest is rounding noise


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
    return cloud_b(rng, B, n)


def cloud_b(rng, b: int, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.normal(scale=0.2, size=(b, n, 3)).astype(np.float32)).to(DEVICE)


def normal(rng, *shape, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE)


def unit_dirs(rng, n: int) -> torch.Tensor:
    d = normal(rng, 3, n)
    return d / d.norm(dim=0, keepdim=True)


def record(rec: dict, name: str, err: float, ms: float, plain_ms: float) -> None:
    """Add one call's numbers to a kernel's record: the largest error, and the
    kernel and plain times summed over the calls of one pass of the path."""
    r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms


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
        record(rec, name, err, ms, plain_ms)

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


def train_counters():
    from hspose_tpu_torch.ops import cuda_hs

    return {"hs_surface_fwd": cuda_hs.hs_surface_fwd, "hs_surface_bwd": cuda_hs.hs_surface_bwd,
            "hs_support_fwd": cuda_hs.hs_support_fwd, "hs_support_bwd": cuda_hs.hs_support_bwd}


def phase_train_kernels() -> dict:
    """K12, K15, K11, K13 against their plain versions at the train step's
    shapes (B=16).  The backwards get the kernel forward's residuals on both
    sides, so winner flips do not enter their comparison.  Returns per-kernel
    records; ms and plain_ms sum the calls of one train step."""
    from hspose_tpu_torch.ops import cuda_hs
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    rng = np.random.default_rng(SEED + 4)
    rec = {}
    S, B = 7, TRAIN_B

    def compare(name, label, pairs, ms, pms):
        """pairs: (what, kernel tensor, plain tensor); each within TOL_REL of
        its largest plain value.  Returns the largest error."""
        torch.cuda.synchronize()
        worst, parts = 0.0, []
        for what, got, want in pairs:
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            parts.append(f"{what} {err:.3e} (bound {TOL_REL * scale:.3e})")
            if not err <= TOL_REL * scale:
                raise AssertionError(f"{name} {label} {what}: error {err} > {TOL_REL} * {scale}")
            worst = max(worst, err)
        log("train-kernels", f"{name} {label}: " + ", ".join(parts)
            + f"; {ms:.4f} ms (plain {pms:.4f} ms)")
        record(rec, name, worst, ms, pms)

    def winners(name, label, wk, wp, mk, mp):
        """Winners agree on >= WIN_AGREE of entries; where not, the values at
        the two winners (mk, mp) are fp32 near-ties."""
        agree = (wk == wp).double().mean().item()
        scale = mp.abs().max().item()
        gap = (mk - mp)[wk != wp].abs().max().item() if agree < 1 else 0.0
        log("train-kernels", f"{name} {label}: winners agree {agree:.6f}, largest value "
                             f"gap where not {gap:.3e} (bound {TOL_REL * scale:.3e})")
        if agree < WIN_AGREE or not gap <= TOL_REL * scale:
            raise AssertionError(f"{name} {label}: winners agree {agree}, gap {gap}")

    # K12 / K15: conv_0
    verts = cloud_b(rng, B, N)
    rf = neighbor_directions_normalized(verts, knn_indices_cuda(verts, 20))
    co, dirs = 128, unit_dirs(rng, S * 128)
    label = f"conv_0 N={N} K=20 Co={co}"
    out_k, win_k = cuda_hs.hs_surface_fwd(rf, dirs, S, co)
    out_p, win_p = cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co)
    theta = torch.relu(rf.double() @ dirs.double())  # (B, N, K, S*Co)
    winners("hs_surface_fwd", label, win_k, win_p,
            theta.gather(2, win_k.long()[:, :, None]).squeeze(2),
            theta.gather(2, win_p.long()[:, :, None]).squeeze(2))
    del theta
    compare("hs_surface_fwd", label, [("out", out_k, out_p)],
            cuda_ms(lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, co), 10),
            cuda_ms(lambda: cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co), 10))
    gb = normal(rng, B, N, co)
    args = (rf, dirs, win_k, gb, S, co)
    compare("hs_surface_bwd", label,
            list(zip(("drf", "dd"), cuda_hs.hs_surface_bwd(*args),
                     cuda_hs.hs_surface_bwd_plain(*args))),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd(*args), 10),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd_plain(*args), 10))

    # K11 / K13: conv_1 .. conv_4, w and b as column slices of the layer's matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                 (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        verts = cloud_b(rng, B, n)
        feat = torch.relu(normal(rng, B, n, cin))
        idx = knn_indices_cuda(feat, k)
        g = gather_neighbors(feat, idx)
        rf = neighbor_directions_normalized(verts, idx)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        fargs = (g, rf, w_full[:, co:], b_full[co:], unit_dirs(rng, S * co), S, co)
        out_k, win_k, tw_k, pw_k = cuda_hs.hs_support_fwd(*fargs)
        out_p, win_p, tw_p, pw_p = cuda_hs.hs_support_fwd_plain(*fargs)
        winners("hs_support_fwd", label, win_k, win_p, tw_k * pw_k, tw_p * pw_p)
        same = win_k == win_p
        compare("hs_support_fwd", label,
                [("out", out_k, out_p), ("twin", tw_k * same, tw_p * same),
                 ("pwin", pw_k * same, pw_p * same)],
                cuda_ms(lambda: cuda_hs.hs_support_fwd(*fargs), 10),
                cuda_ms(lambda: cuda_hs.hs_support_fwd_plain(*fargs), 10))
        gb = normal(rng, B, n, co)
        bargs = (g, rf, fargs[2], fargs[4], win_k, tw_k, pw_k, gb, S, co)
        compare("hs_support_bwd", label,
                list(zip(("dg", "drf", "dw", "db", "dd"), cuda_hs.hs_support_bwd(*bargs),
                         cuda_hs.hs_support_bwd_plain(*bargs))),
                cuda_ms(lambda: cuda_hs.hs_support_bwd(*bargs), 10),
                cuda_ms(lambda: cuda_hs.hs_support_bwd_plain(*bargs), 10))
    return rec


def build_train_model(device):
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    return build_model(ModelConfig(), device=device, train_heads=True)


def grad_gates(got: dict, want: dict) -> str:
    """The N=1028 gates of tests/test_torch_parity.py on parameter gradients:
    per leaf cosine, norm_rel and norm ratio, and the global cosine.

    A bias that a train-mode BatchNorm follows has a zero gradient in exact
    arithmetic (BN removes any constant shift), so both sides hold rounding
    noise there and its direction means nothing: a leaf whose reference norm
    is below ZERO_LEAF of the largest is held only to being as small on the
    card."""
    lo_cos, hi_rel, lo_ratio, hi_ratio = GRAD_LEAF
    top = max(w.double().norm().item() for w in want.values())
    worst, zero = (1.0, 0.0, 1.0), []
    all_g, all_w = [], []
    for name, w in want.items():
        g = got[name].double().ravel()
        w = w.double().ravel()
        nw, ng = max(w.norm().item(), 1e-30), max(g.norm().item(), 1e-30)
        if nw <= ZERO_LEAF * top:
            zero.append(name)
            if not ng <= ZERO_LEAF * top:
                raise AssertionError(f"grad {name}: norm {ng:.3e} where the reference's "
                                     f"{nw:.3e} is rounding noise (bound {ZERO_LEAF * top:.3e})")
            continue
        cos = (g @ w).item() / (ng * nw)
        rel = (g - w).norm().item() / nw
        if not (cos >= lo_cos and rel <= hi_rel and lo_ratio <= ng / nw <= hi_ratio):
            raise AssertionError(f"grad {name}: cos {cos:.5f} norm_rel {rel:.3e} "
                                 f"ratio {ng / nw:.4f}")
        worst = (min(worst[0], cos), max(worst[1], rel),
                 ng / nw if abs(ng / nw - 1) > abs(worst[2] - 1) else worst[2])
        all_g.append(g)
        all_w.append(w)
    g, w = torch.cat(all_g), torch.cat(all_w)
    cos = (g @ w).item() / (g.norm().item() * w.norm().item())
    if not cos >= GRAD_COS:
        raise AssertionError(f"global gradient cosine {cos} < {GRAD_COS}")
    return (f"{len(all_g)} leaves gated, worst cos {worst[0]:.5f}, worst norm_rel "
            f"{worst[1]:.3e}, worst norm ratio {worst[2]:.4f}, global cos {cos:.6f}; "
            f"{len(zero)} leaves zero up to rounding on both sides ({', '.join(zero)})")


def phase_train(smi: str) -> dict:
    """The train step at full width: launches, sanity, card against CPU,
    steps/s.  Returns the training kernels' launches of the main run."""
    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models.hspose import draw_train, train_forward
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    cfg = HSPoseConfig()
    model = build_train_model(DEVICE)
    step = build_train_step(cfg, model, torch.Generator(device=DEVICE).manual_seed(SEED))
    batch = to_device(synthetic_train_batch(TRAIN_B, N, seed=SEED), DEVICE)
    before = [p.detach().clone() for p in model.parameters()]

    wrappers = {**counters(), **train_counters()}
    for fn in wrappers.values():
        fn.launches = 0
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log("train", f"{TRAIN_STEPS} steps of ({TRAIN_B}, {N}, 3): launches {launches}")
    want = {"knn": 9, "hs_surface": 0, "hs_support": 0, "orl_global": 0,
            "hs_surface_fwd": 1, "hs_surface_bwd": 1, "hs_support_fwd": 4,
            "hs_support_bwd": 4}
    for name, per_step in want.items():
        if launches[name] != per_step * TRAIN_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{per_step} per train step")
    for i, m in enumerate(metrics):
        log("train", f"step {i}: total_loss {m['total_loss']:.6f}, skipped_nan "
                     f"{m['skipped_nan']}, {len(m) - 2} loss terms")
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or m["skipped_nan"]:
            raise AssertionError(f"step {i}: non-finite {bad}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    change = max((a - p.detach()).abs().max().item() for a, p in zip(before, model.parameters()))
    # at the start of the warm-up the rate is lr * 1e-3, so small steps round away
    log("train", f"{moved} of {len(before)} parameter tensors moved (largest change "
                 f"{change:.3e}), optimizer count {step.optimizer.count}")
    if moved == 0 or step.optimizer.count != TRAIN_STEPS:
        raise AssertionError("the train step did not update the model")

    # one train forward and backward on the card and on the CPU plain ops
    cpu_model = build_train_model("cpu").train()
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    small = synthetic_train_batch(4, N, seed=SEED + 5)
    draws = draw_train(torch.Generator().manual_seed(SEED + 6), 4, N)
    results = []
    for mdl, dev, dr in ((card_model, DEVICE, draws.to(DEVICE)), (cpu_model, "cpu", draws)):
        total, losses = train_forward(cfg, mdl, to_device(small, dev), draws=dr)
        total.backward()
        results.append(({f"{f}/{k}": v.item() for f, d in losses.items() for k, v in d.items()},
                        {n: p.grad.detach().cpu() for n, p in mdl.named_parameters()}))
    (card_loss, card_grad), (cpu_loss, cpu_grad) = results
    rel = {k: abs(card_loss[k] - v) / max(abs(v), 1e-12) for k, v in cpu_loss.items()}
    log("train", "card against CPU, loss terms: worst rel diff "
                 f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
    if not max(rel.values()) <= LOSS_REL:
        raise AssertionError(f"losses disagree beyond {LOSS_REL}: "
                             f"{ {k: v for k, v in rel.items() if v > LOSS_REL} }")
    log("train", "card against CPU, parameter gradients: " + grad_gates(card_grad, cpu_grad))

    # throughput
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    iters, rates = 5, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
        rates.append(iters / (time.perf_counter() - t0))
    log("train", f"{max(rates)} steps/s at B={TRAIN_B} fp32 (best of 3 windows of {iters} "
                 f"steps: {rates}) on {smi}")
    return launches


SOURCES = {
    "knn": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:163"),
    "hs_surface": ("hspose_tpu_torch/csrc/hs_surface.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:299"),
    "hs_support": ("hspose_tpu_torch/csrc/hs_support.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:219"),
    "orl_global": ("hspose_tpu_torch/csrc/orl.cu", "hspose_tpu/ops/pallas_hs_fused.py:358"),
    "hs_support_fwd": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                       "hspose_tpu/ops/pallas_hs.py:151"),
    "hs_surface_fwd": ("hspose_tpu_torch/csrc/hs_surface_train.cu",
                       "hspose_tpu/ops/pallas_hs.py:215"),
    "hs_support_bwd": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                       "hspose_tpu/ops/pallas_hs.py:336"),
    "hs_surface_bwd": ("hspose_tpu_torch/csrc/hs_surface_train.cu",
                       "hspose_tpu/ops/pallas_hs.py:410"),
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
    rec.update(phase_train_kernels())
    train_launches = phase_train(smi)
    launches.update({name: train_launches[name] for name in train_counters()})
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
