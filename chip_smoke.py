"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. environment: card name and power limit, torch / CUDA / nvcc versions,
   whether triton imports; TF32 off for matrix products and cuDNN;
2. build: the kernels of ``hspose_tpu_torch/csrc`` with nvcc (sm_90a), and
   the registers, shared memory and spills ptxas reports for K1's to K4's
   kernels, K11's projection tile and reduction, K13's and K14's rows,
   reduction and recompute kernels, K8's dg rows and drf walks, K12's
   and K15's kernels, K10's, K16's / K17's and K18's, and K9's three
   (``PTXAS_KERNELS``);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at every shape the B=24, N=1028 forward gives it, with kernel and plain
   times from CUDA events; K1's nine searches are also kept one by one
   (``searches``), K4's five layers likewise (``layers``), each beside its
   bound, and K3's two launches are timed apart (``parts``: the
   projection with its bound and a library product as yardstick, the
   reduction with its bound);
4. slice: ``PoseNet9D`` at full width with seeded random weights serves a few
   (24, 1028, 3) requests through ``eval_forward`` and ``generate_RT``; the
   launch counters must show 9 KNN, 1 surface, 4 support and 5 ORL launches
   per forward, the poses must be finite and orthonormal, and the same
   weights, input and pooling samples through the plain ops on the CPU must
   agree within 1e-3;
5. throughput: crops/s at B=24, fp32, best of 3 windows;
6. bf16 kernels: the packed-key KNN and the bf16 surface, support and ORL
   kernels against their plain versions on the card at every shape the
   B=24 bf16 forward gives them (KNN: >= 99.9% of the neighbours shared and
   swapped neighbours within 2^-10 relative distance; the reductions within
   1e-4 of the largest value), with kernel and plain times, the nine
   searches, K4's five layers and K3's parts kept as in phase 3;
7. bf16 slice: the same model built with ``compute_dtype="bfloat16"``
   serves the same requests; the launch counters must show 9 packed-key
   KNN, no exact KNN, 1 surface, 4 support and 5 ORL bf16 launches and no
   fp32 HS launch per forward, the poses must be finite and orthonormal,
   the plain ops on the CPU must agree within 3e-2, and the deviation from
   the fp32 tier is printed; then crops/s at B=24 in bf16, best of 3;
8. training kernels: K12, K15, K11 and K13 against their plain versions at
   every shape of the B=16, N=1028 train step: forwards within 1e-4 of the
   largest value, winners equal on >= 99.9% of entries and near-ties where
   not; backwards fed the same residuals as their plain versions, every
   cotangent within 1e-4 of its largest value; kernel and plain times;
   K12 and K15 also per launch (``parts``: K12's reduction; K15's routing
   with its drf walk and dd tile partials, and the partial sum, each with
   its bound, timed by torch.profiler); K13 also per layer (``layers``) and
   per launch (``parts``: rows, reduction, partial sum, each with its
   bound), with at most one launch of each per call; K11 (fed the source rows
   ``feat`` and index ``idx`` that g gathers, g formed as their gather) per
   layer and per launch (``parts``: the projection of the source rows with
   its bound and a library product as yardstick, the gather-reduction with
   its bound), with the bound of the design it replaced
   (``bound_gathered_ms``: every gathered row projected);
9. training slice: ``build_train_step`` at full width takes 3 steps on a
   (16, 1028) synthetic batch; the launch counters must show 9 KNN, 1 + 1
   surface and 4 + 4 support training launches per step and no serving
   launch, the losses must be finite, the parameters move and the optimizer
   count advance; one train forward and backward at B=4 on the card and on
   the CPU plain ops, with the same weights, batch and draws, must agree
   (losses within 1e-3 relative, parameter gradients within the N=1028
   gates of tests/test_torch_parity.py); then steps/s at B=16;
10. bf16 training kernels: the bf16 instantiations of K12, K15, K11 and K13
   against their plain versions (which make the same bf16 roundings) at
   every shape of the B=16 bf16 train step: fp32 outputs within 1e-4 of
   the largest value, winners as in phase 8, and the bf16 cotangents
   (drf, dg, dd) within one bf16 ulp of each element plus 1e-4 of the
   largest (the fp32 sums differ in order, which can move a rounding to
   bf16 by one ulp); K12's and K15's ``parts``, K13's ``layers`` and
   ``parts`` as in phase 8;
11. bf16 training slice: ``build_train_step`` on ``compute_dtype="bfloat16"``
   takes 3 steps at (16, 1028); the counters must show 9 packed-key KNN and
   1 + 1 surface and 4 + 4 support bf16 training launches per step, nothing
   else (no exact KNN, no fp32 training kernel, no serving kernel); finite
   losses, moved parameters; one bf16 train forward and backward at B=4 on
   the card against the CPU plain ops, gated by ``SPREAD_MULT`` times the
   card's own spread (the card against itself with the input cloud moved by
   1e-6 relative), both printed; then bf16 steps/s beside the fp32 steps/s;
12. v4 training kernels: K11 without winner values and K14 (``bwd_store=False``)
   at the four HS layers' shapes of the B=16 step, the fused ops' forwards
   with winners (K2, K3, K4) and their backwards (K9 at conv_0's shape, K8
   at conv_2..conv_4's, K10 at their ORL branches') against their plain
   versions, with phase 8's gates; K14 against K13 on the same inputs; the
   forwards with winners against the serving kernels and every backward
   against a second launch, bit for bit; then one autograd backward through
   ``hs_surface_fused``, K9's carrier (no model path reaches K9), which must
   launch one K2 with winners and one K9; K14 per layer and per launch
   (recompute, rows, reduction, partial sum) as K13 in phase 8; K11 without
   values per layer and per launch as in phase 8; K8 per layer and per
   launch (inverse lists, route, drf walk, dd partial sums, the source-row
   scatter, dverts, the two partial sums, and dfeat's and dW's products,
   each beside one library product, or in the bf16 tier the dg rows and
   their source-row sums for dfeat); K10 per launch (``parts``): one
   kernel, at most one launch a call, no inverse lists; K9 per launch
   (``parts``: the fused route / drf / dd kernel, the partial sum, dverts;
   three launches a call, no inverse lists) at conv_0, and against its
   plain version and a second launch, bit for bit, at (N, K, S, Co) =
   (2056, 20, 7, 128), (1001, 5, 3, 64), (257, 31, 9, 96) and (5000, 12,
   10, 32), B=4 (``K9_SHAPES``: K up to 31, S*Co not a multiple of 32, a
   dverts window short of a batch's N*K entries);
13. v4 training slice: ``build_train_step`` on ``ModelConfig(bwd_store=False,
   train_v4_small=True)`` takes 3 steps at (16, 1028); the counters must show
   9 KNN, 1 + 1 K12/K15, 1 K11 without winner values + 1 K14, 3 K3 with
   winners + 3 K8 and 3 K4 with winners + 3 K10 per step and nothing else
   (no K13, no serving launch, no bf16 launch); finite losses, moved
   parameters; one train forward and backward at B=4 on the card against
   the CPU plain ops with phase 9's gates; then its steps/s beside phase 9's;
14. bf16 v4 training kernels: phase 12 on the bf16 instantiations (bf16
   features, rf and directions as the bf16 step forms them): K11 without
   winner values and K14 at conv_1..conv_4, K14 bit for bit against K13
   bf16; K2/K3/K4 with winners bit for bit against the bf16 serving
   kernels; K9 at conv_0's shape, K8 at conv_2..conv_4's and K10 at their
   ORL branches' against their plain versions with phase 10's gates; every
   backward twice, bit for bit; K9 per launch and at ``K9_SHAPES`` as in
   phase 12; one autograd backward through a bf16 ``hs_surface_fused``
   (K9's carrier);
15. bf16 v4 training slice: phase 13 on ``ModelConfig(compute_dtype=
   "bfloat16", bwd_store=False, train_v4_small=True)``: 9 packed KNN, 1 + 1
   K12/K15 bf16, 1 K11 bf16 without winner values + 1 K14 bf16, 3 + 3
   K3/K8 bf16 and 3 + 3 K4/K10 bf16 per step and nothing else; finite
   losses, moved parameters; card against CPU within ``SPREAD_MULT`` times
   the card's own spread, as phase 11; steps/s beside phase 11's;
16. each training flag alone, in both tiers: one train forward and backward
   at (16, 1028) with its exact launch counts (``bwd_store=False``: 4 K11
   without winner values + 4 K14, no K13; ``train_v4_small=True``: 1 K11 +
   1 K13 at conv_1 and 3 + 3 K3/K8 and K4/K10), finite losses and
   gradients;
17. chamfer kernels: K16 (minimum), K17 (minimum and argmin) and K18 (the
   gradient for one cloud) against their plain versions at the recon tier's
   shape (24, 1028) x (24, 1028), at (24, 1028) x (24, 700) and on a cloud
   with duplicated points: distances within 1e-5 of the largest distance or
   squared norm of a query point (the scale of the expansion's rounding,
   all there is where the clouds coincide), argmins
   equal on >= 99.9% and within 1e-6 in exact distance where not, gradients
   within 1e-4 of the largest, K18 twice bit for bit; K18 also at (4, 5000)
   x (4, 300) (long lists) and where every point of b, 3000 of them, shares
   one nearest point of a (a tile's list over two windows); K16, K17 and
   K18 per launch (``parts``; K18 one launch a call, no inverse lists) at
   the recon shape; then one autograd call of ``chamfer_distance`` (2 K17,
   2 K18);
18. eval harness: ``batched_pose_inference`` on in-memory records (3
   batches of 24 crops of 1028 points; no PNG, cv2 or matplotlib) in fp32,
   bf16, and fp32 with ``eval.recon`` on a model with the train heads:
   exact launch counts per batch (recon: 2 K16, no K17/K18), the fp32 poses
   bit for bit those of ``eval_forward`` + ``generate_RT`` on the same crops
   and pool samples, chamfer and EMD finite and positive, then
   ``compute_degree_cm_mAP``; crops/s over 20 batches beside the forward
   alone's (phases 5 and 7), and the recon tier's chamfer and EMD ms per
   batch;
19. K5: the exact KNN above N = 2048 (the JAX package's streamed kernel)
   against its plain version at N = 2056 and 4096 (xyz k=20 and k=4,
   features k=20 in fp32 and bf16), with times, and one fp32 harness batch
   at ``data.num_points=2056``: 3 streamed and 6 other KNN launches;
20. K2, K4 and K10 off the forward's shapes, fp32 and bf16, so that each
   branch of their launches runs: K4 at the N = 2056 harness forward's five
   ORL shapes (B=24), at B=4 N=2056, N=5000, K=5 and on an index tensor off
   16-byte alignment; K2 at S, K and Co other than 7, 20 and 128; each
   against its plain version within 1e-4 of the largest value, the
   forwards with winners bit for bit the serving kernels' and their
   winners as in phase 8; K4 must refuse features off 16-byte alignment;
   K10 at (N, C, K) = (1028, 128, 20), (2056, 64, 20), (5000, 48, 5), (257,
   50, 20), (20000, 32, 8) and (33, 36, 7) on random winners, against its
   plain version with phase 12's gates and twice bit for bit;
21. K11, K13 and K14 off the step's shapes, fp32 and bf16, so that each
   branch of their launches runs: (K, Cin, Co, S) = (5, 132, 128, 3), (31,
   128, 512, 7) and (20, 256, 256, 9) at B=3, N=1001 (every template width
   of K, Cin beyond one 128-channel block, column tiles of other widths, a
   row count that is a multiple of no tile): K11 against its plain version
   at phase 8's gates, twice with the same bits, its no-values launch bit
   for bit its stored one; K13 against its plain version at phase 8's gates
   (phase 10's in bf16), K14 bit for bit K13 on the forward's stored
   values, each launched twice with the same bits; and K12 and K15 at
   (K, S, Co) = (5, 3, 64), (31, 9, 128) and (12, 10, 96), B=3, N=1001 (K
   and S read at run time, a part-full last block and tile), against
   their plain versions at phase 8's gates (phase 10's in bf16), each
   launched twice with the same bits;
22. the relaxed-KNN serving tier (``serve_k=16``, the kernels' generic-K
   branches) in fp32 and bf16: phase 4's and 7's launch counts, poses and
   card-against-CPU gates on the same seeded weights.

Each kernel's ``bound_ms`` is the least time the card could take for its
calls: per call the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its multiply-adds (2 operations
each) over the peak rate of their operand type (67 TFLOP/s fp32 outside the
tensor cores, 989 TFLOP/s bf16), summed over the calls of one pass;
``bound_by`` names the larger part.  K16's and K17's ``library_ms`` is
``torch.cdist(a, b).pow(2).min(-1)`` over both directions, a reference the
port never calls; no single PyTorch call computes the other functions (the
backwards are winner- or argmin-routed scatters), so theirs is null.  K3's
projection alone has one: ``parts.project.library_ms`` is ``torch.addmm(b,
feat, W)`` in fp32 with TF32 off, ``torch.matmul`` on bf16 operands in the
bf16 tier, neither called by the port; so has K11's (the same calls on its
source rows), and K8's two products (``torch.matmul`` of the same shapes,
fp32, TF32 off).  K11's, K13's, K14's and K8's ``parts`` are their launches
timed apart, each with the bound of its own inputs and outputs; K11's
``bound_ms`` is the least work of the function (the source rows projected
once), ``bound_gathered_ms`` that of the design it replaced.
K12's and K15's ``parts`` likewise.
``launches`` is each kernel's count in the main run of its path: phases 4,
7, 9, 11, 13 and 15, for K2 with winners and K9 the autograd call of phases
12 and 14, for K16 the recon harness run, for K17 and K18 the autograd call
of phase 17, and for K5 the N = 2056 harness batch.

The line before the last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits with code 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import re
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
KNN_SWAP_REL = 2.0 ** -10  # packed-key KNN: distance gap of a swapped neighbour
SLICE_ATOL_BF16 = 3e-2  # bf16 tier, card against CPU on the pose outputs
SEED = 0
SERVE_K_RELAXED = 16  # phase 22: the relaxed-KNN serving tier's neighbour count
TRAIN_B = 16  # the train batch (train.batch_size)
TRAIN_STEPS = 3
WIN_AGREE = 0.999  # K11, K12: share of winners equal to the plain version's
LOSS_REL = 1e-3  # card against CPU, each loss term
GRAD_LEAF = (0.98, 0.2, 0.9, 1.1)  # per leaf: min cos, max norm_rel, norm ratio range
GRAD_COS = 0.9995  # all parameter gradients as one vector
ZERO_LEAF = 1e-5  # a leaf gradient below this share of the largest is rounding noise
SPREAD_MULT = 4.0  # bf16 train step, card against CPU: at most this multiple of the card's spread
SPREAD_EPS = 1e-6  # the relative move of the input cloud that measures the spread
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per operand type


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# clock cycles of the sleep kernel that holds the stream while cuda_ms
# enqueues its calls (about 10 ms on an H100)
QUEUE_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up.  A
    sleep kernel ahead of the first event holds the stream while the host
    enqueues the ``iters`` calls, so that a kernel shorter than its
    wrapper's host time (an ORL layer: 5 to 20 us against about 25 us) is timed
    back to back on the device, not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
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


# kernels whose registers, shared memory and spills phase 2 prints: K1's to
# K4's, K11's (the projection tile gemm_kernel, shared with K3's fp32
# projection and K8's products, and support_fwd_kernel), K13's and K14's
# (support_bwd_rows_kernel, support_bwd_reduce_kernel, recompute_kernel),
# K8's rows and drf walks (dg_rows_kernel, rf_grad_kernel), and K12's and
# K15's (surface_fwd_kernel; surface_bwd_kernel, sum_tiles_kernel, which K9
# shares), K10's (orl_bwd_kernel), K16's / K17's (chamfer_min_kernel), K18's
# (chamfer_grad_kernel) and K9's (fused_bwd_kernel, dverts_rows_kernel)
PTXAS_KERNELS = ("knn_kernel", "surface_kernel", "gemm_kernel", "project_bf16_kernel",
                 "reduce_kernel", "orl_kernel", "support_fwd_kernel", "support_bwd_rows_kernel",
                 "recompute_kernel", "dg_rows_kernel", "rf_grad_kernel", "surface_fwd_kernel",
                 "surface_bwd_kernel", "sum_tiles_kernel", "orl_bwd_kernel", "chamfer_min_kernel",
                 "chamfer_grad_kernel", "fused_bwd_kernel", "dverts_rows_kernel")


def ptxas_report(text: str, names=PTXAS_KERNELS) -> list[str]:
    """One line per compiled instantiation of the kernels in ``names`` from
    ptxas' -v output: registers, shared memory, spill stores and loads."""
    rows, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and any(n in fn for n in names):
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((fn, int(m.group(1)), int(smem.group(1)) if smem else 0, *spill))
            fn, spill = None, (0, 0)
    try:  # demangle where binutils is installed
        names_out = run(["c++filt", *[r[0] for r in rows]]).splitlines() if rows else []
    except (OSError, subprocess.CalledProcessError):
        names_out = [r[0] for r in rows]
    return [f"{name}: {regs} registers, {smem} bytes static smem, spill stores {st} B, "
            f"loads {ld} B" for name, (_, regs, smem, st, ld) in zip(names_out, rows)]


def phase_build() -> None:
    from hspose_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    how = ("built" if _build.build_seconds is not None else "found cached")
    report = _build.library_path().with_suffix(".log")
    log("build", f"{how} {_build.library_path().name} in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s; "
                 f"ptxas report in {report.name})")
    if report.exists():
        for line in ptxas_report(report.read_text()):
            log("build", "ptxas " + line)


def cloud(rng, n: int) -> torch.Tensor:
    return cloud_b(rng, B, n)


def cloud_b(rng, b: int, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.normal(scale=0.2, size=(b, n, 3)).astype(np.float32)).to(DEVICE)


def normal(rng, *shape, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE)


def unit_dirs(rng, n: int) -> torch.Tensor:
    d = normal(rng, 3, n)
    return d / d.norm(dim=0, keepdim=True)


def bound(tensors, macs: float, dtype, nbytes: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it) of the least time the card could take for one
    call: the bytes of ``tensors`` (its inputs and outputs, each once) and
    ``nbytes`` more over HBM_BYTES_PER_S, or ``macs`` multiply-adds at the
    peak of ``dtype``."""
    nbytes += sum(t.numel() * t.element_size() for t in tensors)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / PEAK_OPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def record(rec: dict, name: str, err: float, ms: float, plain_ms: float,
           bnd: tuple[float, str]) -> None:
    """Add one call's numbers to a kernel's record: the largest error, and the
    kernel, plain and bound times summed over the calls of one pass of the
    path; ``bound_by`` is whichever part holds most of the bound."""
    r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                              "bound_by": "", "library_ms": None, "_by": {}})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bnd[0]
    r["_by"][bnd[1]] = r["_by"].get(bnd[1], 0.0) + bnd[0]
    r["bound_by"] = max(r["_by"], key=r["_by"].get)


def phase_kernels(dtype: str = "float32") -> dict:
    """Every kernel of one tier against its plain version at the B=24
    forward's shapes: the exact KNN and fp32 HS kernels, or the packed-key
    KNN and the HS kernels' bf16 variants (xyz stays fp32, features are
    bf16).  Returns per-kernel records; ms and plain_ms sum the forward's
    calls."""
    from hspose_tpu_torch.ops.cuda_hs_fused import (
        hs_support_fused, hs_support_plain, hs_surface_fused, hs_surface_plain,
        orl_global_fused, orl_global_plain)
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices, knn_indices_packed

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-kernels", "_bf16") if fast else ("kernels", "")
    knn_name, knn_plain = ("knn_packed", knn_indices_packed) if fast else ("knn", knn_indices)
    knn_gap = KNN_SWAP_REL if fast else KNN_TIE_REL
    rng = np.random.default_rng(SEED)
    n1, n2 = N // 4, N // 16
    clouds = {n: cloud(rng, n) for n in (N, n1, n2)}
    rec = {}

    def features(n, c):
        x = normal(rng, B, n, c)
        return x.to(torch.bfloat16) if fast else x

    def knn_cuda(pts, k):
        return knn_indices_cuda(pts, k, packed=fast)

    # the nine searches of one forward, (points, D, k)
    for n, d, k in [(N, 3, 20), (N, 128, 20), (N, 3, 4),
                    (n1, 3, 20), (n1, 128, 20), (n1, 256, 20), (n1, 3, 4),
                    (n2, 3, 8), (n2, 256, 8)]:
        pts = clouds[n] if d == 3 else features(n, d)
        got, want = knn_cuda(pts, k), knn_plain(pts, k)
        torch.cuda.synchronize()
        agree = (got[..., :, None] == want[..., None, :]).any(-1).double().mean().item()
        p64 = pts.double()

        def sorted_d(idx):
            diff = gather_neighbors(p64, idx) - p64[:, :, None]
            return (diff * diff).sum(-1).sort(-1).values

        dg, dw = sorted_d(got), sorted_d(want)
        err = (dg - dw).abs().max().item()
        rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
        ms = cuda_ms(lambda: knn_cuda(pts, k))
        pms = cuda_ms(lambda: knn_plain(pts, k))
        log(phase, f"{knn_name} N={n} D={d} {pts.dtype} k={k}: agreement {agree:.6f}, max "
                   f"rel distance gap {rel:.3e}, {ms:.4f} ms (plain {pms:.4f} ms)")
        if agree < KNN_AGREE or rel > knn_gap:
            raise AssertionError(f"{knn_name} N={n} D={d} k={k} disagrees with its plain "
                                 f"version: agreement {agree}, distance gap {rel}")
        bnd = bound([pts, got], B * n * n * d, torch.float32 if d == 3 else pts.dtype)
        record(rec, knn_name, err, ms, pms, bnd)
        rec[knn_name].setdefault("searches", []).append(
            {"N": n, "D": d, "k": k, "ms": ms, "plain_ms": pms, "bound_ms": bnd[0]})

    op_dtype = torch.bfloat16 if fast else torch.float32

    def close(name, label, got, want, ms, pms, tensors, macs):
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log(phase, f"{name} {label}: max abs err {err:.3e} (bound "
                   f"{TOL_REL * scale:.3e}), {ms:.4f} ms (plain {pms:.4f} ms)")
        if not (err <= TOL_REL * scale and got.dtype == torch.float32):
            raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}")
        bnd = bound(tensors + [got], macs, op_dtype)
        record(rec, name, err, ms, pms, bnd)
        return bnd

    S = 7
    # conv_0
    verts, idx = clouds[N], knn_cuda(clouds[N], 20)
    dirs = unit_dirs(rng, S * 128)
    args = (verts, idx, dirs, S, 128)
    close("hs_surface" + tag, f"conv_0 N={N} K=20 Co=128",
          hs_surface_fused(*args, exact=not fast), hs_surface_plain(*args, exact=not fast),
          cuda_ms(lambda: hs_surface_fused(*args, exact=not fast)),
          cuda_ms(lambda: hs_surface_plain(*args, exact=not fast)),
          [verts, idx, dirs], 3 * idx.numel() * S * 128)

    # conv_1 .. conv_4, weights as column slices of the (Cin, (S+1)Co) matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, n1, 20),
                                 (3, 256, 256, n1, 20), (4, 256, 512, n2, 8)]:
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        args = (features(n, cin), clouds[n], knn_cuda(clouds[n], k),
                w_full[:, co:], b_full[co:], unit_dirs(rng, S * co), S, co)
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        close("hs_support" + tag, label,
              hs_support_fused(*args), hs_support_plain(*args),
              cuda_ms(lambda: hs_support_fused(*args)),
              cuda_ms(lambda: hs_support_plain(*args)),
              list(args[:6]), B * n * cin * S * co + 3 * args[2].numel() * S * co)
        support_parts(phase, rec["hs_support" + tag], label, args, fast)

    # the ORL branch of each layer
    for layer, c, n, k in [(0, 128, N, 20), (1, 128, N, 20), (2, 256, n1, 20),
                           (3, 256, n1, 20), (4, 512, n2, 8)]:
        feat, idx = features(n, c), knn_cuda(clouds[n], k)
        ms, pms = cuda_ms(lambda: orl_global_fused(feat, idx)), cuda_ms(
            lambda: orl_global_plain(feat, idx))
        bnd = close("orl_global" + tag, f"conv_{layer} C={c} N={n} K={k}",
                    orl_global_fused(feat, idx), orl_global_plain(feat, idx), ms, pms,
                    [feat, idx], 0)
        rec["orl_global" + tag].setdefault("layers", []).append(
            {"layer": layer, "N": n, "C": c, "K": k, "ms": ms, "plain_ms": pms,
             "bound_ms": bnd[0]})
    return rec


def support_parts(phase: str, r: dict, label: str, args, fast: bool) -> None:
    """K3's two launches timed apart and summed over the forward into
    r["parts"]: the projection (with its bound and, as a yardstick the port
    never calls, one library product: ``torch.addmm`` in fp32 with TF32 off,
    ``torch.matmul`` on bf16 operands) and the reduction (with its bound)."""
    from hspose_tpu_torch.ops import _build
    from hspose_tpu_torch.ops.cuda_hs_fused import _support_project

    feat, verts, idx, w, b, dirs, S, co = args
    Bn, n, cin = feat.shape
    proj = _support_project(feat, w, b, S, co, fast)
    out = torch.empty((Bn, n, co), dtype=torch.float32, device=DEVICE)
    feat2d = feat.reshape(-1, cin)
    if fast:
        w16 = w.to(torch.bfloat16)
        library = lambda: torch.matmul(feat2d, w16)  # noqa: E731
    else:
        library = lambda: torch.addmm(b, feat2d, w)  # noqa: E731
    p_ms = cuda_ms(lambda: _support_project(feat, w, b, S, co, fast))
    r_ms = cuda_ms(lambda: _build.launch("hs_support_reduce", proj, verts, idx, dirs, out, Bn, n,
                                         idx.shape[2], S, co, int(fast)))
    l_ms = cuda_ms(library)
    p_bound = bound([feat, w, b, proj], Bn * n * cin * S * co,
                    torch.bfloat16 if fast else torch.float32)
    r_bound = bound([proj, verts, idx, dirs, out], 3 * idx.numel() * S * co, torch.float32)
    log(phase, f"  {label}: projection {p_ms:.4f} ms (bound {p_bound[0]:.4f} "
               f"{p_bound[1]}, library {l_ms:.4f}), reduction {r_ms:.4f} ms (bound "
               f"{r_bound[0]:.4f} {r_bound[1]})")
    parts = r.setdefault("parts", {"project": {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0},
                                   "reduce": {"ms": 0.0, "bound_ms": 0.0}})
    for part, ms, bnd in (("project", p_ms, p_bound), ("reduce", r_ms, r_bound)):
        parts[part]["ms"] += ms
        parts[part]["bound_ms"] += bnd[0]
    parts["project"]["library_ms"] += l_ms


def build_seeded_model(device, dtype: str = "float32", serve_k: int = 0):
    """The serving model with weights from SEED: the same in both tiers (and
    with any ``serve_k``)."""
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    model = build_model(ModelConfig(compute_dtype=dtype, serve_k=serve_k), device=device)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):  # running statistics that matter
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


def counters() -> dict:
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from hspose_tpu_torch.ops import chamfer as ch
    from hspose_tpu_torch.ops import cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda as knn

    return {"knn": (knn, "launches"), "knn_streamed": (knn, "streamed_launches"),
            "chamfer_min": (ch.chamfer_min_cuda, "launches"),
            "chamfer_min_argmin": (ch.chamfer_min_argmin_cuda, "launches"),
            "chamfer_grad": (ch.chamfer_grad_cuda, "launches"),
            "hs_surface": (f.hs_surface_fused, "launches"),
            "hs_support": (f.hs_support_fused, "launches"),
            "orl_global": (f.orl_global_fused, "launches"),
            "knn_packed": (knn, "packed_launches"),
            "hs_surface_bf16": (f.hs_surface_fused, "bf16_launches"),
            "hs_support_bf16": (f.hs_support_fused, "bf16_launches"),
            "orl_global_bf16": (f.orl_global_fused, "bf16_launches"),
            **{name: (getattr(f, name), "launches") for name in FUSED_TRAIN_KERNELS},
            **{name + "_bf16": (getattr(f, name), "bf16_launches") for name in FUSED_TRAIN_KERNELS}}


def reset_counts(counts: dict) -> None:
    for fn, attr in counts.values():
        setattr(fn, attr, 0)


def read_counts(counts: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counts.items()}


def check_counts(launches: dict, per_run: dict, runs: int, what: str) -> None:
    """Every counter must read its per-run count times ``runs``; a kernel
    missing from ``per_run`` must not have launched."""
    for name, n in launches.items():
        if n != per_run.get(name, 0) * runs:
            raise AssertionError(f"{name}: {n} launches, expected {per_run.get(name, 0)} "
                                 f"per {what}")


SERVE_LAUNCHES = {
    "float32": {"knn": 9, "hs_surface": 1, "hs_support": 4, "orl_global": 5},
    "bfloat16": {"knn_packed": 9, "hs_surface_bf16": 1, "hs_support_bf16": 4,
                 "orl_global_bf16": 5},
}


def serve_requests(model, requests, samples, obj, sym) -> list:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    results = []
    for pc, smp in zip(requests, samples):
        out = eval_forward(model, pc, obj, pool_samples=smp)
        results.append((out, generate_RT(out.p_green_R, out.p_red_R, out.f_green_R,
                                         out.f_red_R, out.pred_T, sym)))
    torch.cuda.synchronize()
    return results


def phase_slice(dtype: str = "float32", fp32_results: list | None = None, serve_k: int = 0):
    """A few requests through the serving path of one tier: launch counts,
    finite orthonormal poses, card against the CPU plain ops; for bf16 also
    the deviation from the fp32 tier's ``fp32_results``.  ``serve_k`` > 0
    serves the relaxed-KNN tier (each search and reduction at that K, the
    kernels' generic-K branches).  Returns the launches and the results."""
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward

    phase = ("slice" if dtype == "float32" else "bf16-slice") + (
        f"-serve_k{serve_k}" if serve_k else "")
    bound = SLICE_ATOL if dtype == "float32" else SLICE_ATOL_BF16
    model = build_seeded_model(DEVICE, dtype, serve_k)
    rng = np.random.default_rng(SEED + 2)
    obj = torch.arange(B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [cloud(rng, N) for _ in range(REQUESTS)]
    samples = [draw_pool_samples(N, gen, DEVICE) for _ in range(REQUESTS)]

    counts = counters()
    reset_counts(counts)
    results = serve_requests(model, requests, samples, obj, sym)
    launches = read_counts(counts)
    log(phase, f"{REQUESTS} requests of ({B}, {N}, 3): launches {launches}")
    check_counts(launches, SERVE_LAUNCHES[dtype], REQUESTS, "forward")

    eye = torch.eye(3, device=DEVICE)
    for i, (out, RT) in enumerate(results):
        for name, v in zip(out._fields, out):
            if not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {name} is not finite")
        R = RT[:, :3, :3]
        ortho = (R.transpose(1, 2) @ R - eye).abs().max().item()
        det = (torch.linalg.det(R) - 1).abs().max().item()
        log(phase, f"request {i}: |R^T R - I| {ortho:.2e}, |det R - 1| {det:.2e}, "
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
    log(phase, "card against CPU plain ops, max abs diff: "
               + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= bound}
    if bad:
        raise AssertionError(f"card and CPU disagree beyond {bound}: {bad}")

    if fp32_results is not None:
        dev = {name: max((a - b).abs().max().item()
                         for (o, _), (o32, _) in zip(results, fp32_results)
                         for a, b in [(getattr(o, name), getattr(o32, name))])
               for name in out._fields}
        R, R32 = (torch.cat([rt[:, :3, :3] for _, rt in res]) for res in (results, fp32_results))
        cos = ((R32.transpose(1, 2) @ R).diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
        angle = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
        log(phase, f"deviation from the fp32 tier over {REQUESTS * B} crops, max abs: "
                   + ", ".join(f"{k} {v:.2e}" for k, v in dev.items())
                   + f"; rotation angle mean {angle.mean().item():.4f} deg, max "
                     f"{angle.max().item():.4f} deg")
    return launches, results


def phase_throughput(smi: str, dtype: str = "float32") -> float:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    model = build_seeded_model(DEVICE, dtype)
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
    tier = "fp32" if dtype == "float32" else "bf16"
    log("throughput", f"{max(rates)} crops/s at B={B} {tier} (best of 3 windows of "
                      f"{iters} forwards: {rates}) on {smi}")
    return max(rates)


TRAIN_KERNELS = ("hs_surface_fwd", "hs_surface_bwd", "hs_support_fwd", "hs_support_bwd")
# the differentiable fused ops' kernels (ops/cuda_hs_fused.py)
FUSED_TRAIN_KERNELS = ("hs_surface_fused_fwd", "hs_surface_fused_bwd", "hs_support_fused_fwd",
                       "hs_support_fused_bwd", "orl_global_fused_fwd", "orl_global_fused_bwd")


def train_counters() -> dict:
    """The training kernels' counters: fp32 launches under the wrapper's
    name, bf16 launches under the name with ``_bf16``."""
    from hspose_tpu_torch.ops import cuda_hs

    fp32 = {name: (getattr(cuda_hs, name), "launches") for name in TRAIN_KERNELS}
    bf16 = {name + "_bf16": (getattr(cuda_hs, name), "bf16_launches") for name in TRAIN_KERNELS}
    return {**fp32, **bf16, "hs_support_fwd_novals": (cuda_hs.hs_support_fwd, "novals_launches"),
            "hs_support_fwd_novals_bf16": (cuda_hs.hs_support_fwd, "novals_bf16_launches"),
            "hs_support_bwd_recompute": (cuda_hs.hs_support_bwd_recompute, "launches"),
            "hs_support_bwd_recompute_bf16": (cuda_hs.hs_support_bwd_recompute, "bf16_launches")}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits), as fp32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_cotangents(phase: str, rec: dict, name: str, label: str, pairs, ms: float | None,
                       pms: float, tensors, macs: float, op_dtype=torch.float32):
    """pairs: (what, kernel tensor, plain tensor); fp32 ones within TOL_REL of
    their largest plain value, bf16 ones also one bf16 ulp of each element
    (the two fp32 sums differ in order, which can move the final rounding by
    one ulp).  Logs and records the call under ``name`` and returns its
    bound; with ``ms`` None only checks and logs."""
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for what, got, want in pairs:
        scale = want.abs().max().item()
        diff = (got.float() - want.float()).abs()
        slack = bf16_ulp(want) if got.dtype == torch.bfloat16 else torch.zeros_like(diff)
        err = diff.max().item()
        over = (diff - slack).max().item()
        parts.append(f"{what} {err:.3e} (bound {TOL_REL * scale:.3e}"
                     + (" + 1 bf16 ulp" if got.dtype == torch.bfloat16 else "") + ")")
        if not (over <= TOL_REL * scale and got.dtype == want.dtype):
            raise AssertionError(f"{name} {label} {what}: error {err} ({over} beyond the "
                                 f"ulp slack) > {TOL_REL} * {scale}, or {got.dtype} is "
                                 f"not {want.dtype}")
        worst = max(worst, err)
    if ms is None:
        log(phase, f"{name} {label}: " + ", ".join(parts))
        return None
    log(phase, f"{name} {label}: " + ", ".join(parts) + f"; {ms:.4f} ms (plain {pms:.4f} ms)")
    bnd = bound(tensors + [got for _, got, _ in pairs], macs, op_dtype)
    record(rec, name, worst, ms, pms, bnd)
    return bnd


def check_winners(phase: str, name: str, label: str, wk, wp, mk, mp) -> None:
    """Winners agree on >= WIN_AGREE of entries; where not, the values at
    the two winners (mk, mp) are fp32 near-ties."""
    differ = wk != wp
    n_differ = int(differ.sum().item())  # a count: a mean can round below 1 with none
    agree = 1.0 - n_differ / wk.numel()
    scale = mp.abs().max().item()
    gap = (mk - mp)[differ].abs().max().item() if n_differ else 0.0
    log(phase, f"{name} {label}: winners agree {agree:.6f}, largest value gap where not "
               f"{gap:.3e} (bound {TOL_REL * scale:.3e})")
    if agree < WIN_AGREE or not gap <= TOL_REL * scale:
        raise AssertionError(f"{name} {label}: winners agree {agree}, gap {gap}")


# launches by kernel name, per kernel: (substring of the profiler's kernel
# name, part), the first match wins.  K13's and K14's (csrc/hs_support_train.cu;
# the partial sum is hs_common.cuh's, shared with other backwards), K11's (the
# projection tile of csrc/hs_project.cuh and the gather-reduction) and K8's
# (csrc/hs_fused_bwd.cuh, csrc/hs_support.cu: dfeat's and dW's products are
# the tile with W, or feat, read transposed)
SUPPORT_BWD_PARTS = (("support_bwd_rows_kernel", "rows"), ("support_bwd_reduce_kernel", "reduction"),
                     ("recompute_kernel", "recompute"), ("sum_partials_kernel", "partial_sum"))
SUPPORT_FWD_PARTS = (("gemm_kernel", "projection"), ("support_fwd_kernel", "reduction"))
# K12's one launch and K15's two (csrc/hs_surface_train.cu)
SURFACE_FWD_PARTS = (("surface_fwd_kernel", "reduction"),)
SURFACE_BWD_PARTS = (("surface_bwd_kernel", "route_drf_dd"), ("sum_tiles_kernel", "partial_sum"))
# K10's one launch (csrc/orl.cu; inverse_index_kernel, the inverse lists of
# the design it replaced, must not run) and K16's / K17's (csrc/chamfer.cu)
ORL_BWD_PARTS = (("inverse_index_kernel", "inverse_index"), ("orl_bwd_kernel", "orl_bwd"))
CHAMFER_PARTS = {"chamfer_min": (("chamfer_min_kernel<false", "search"),),
                 "chamfer_min_argmin": (("chamfer_min_kernel<true", "search"),),
                 "chamfer_grad": (("inverse_index_kernel", "inverse_index"),
                                  ("chamfer_grad_kernel", "grad"))}
# K9's three launches (csrc/hs_surface.cu; the partial sum is hs_common.cuh's,
# shared with K15); inverse_index_kernel, the lists of the design before, must
# not run
SURFACE_FUSED_BWD_PARTS = (("inverse_index_kernel", "inverse_index"),
                           ("fused_bwd_kernel", "route_drf_dd"),
                           ("sum_tiles_kernel", "partial_sum"), ("dverts_rows_kernel", "dverts"))
# K9 off conv_0's shape, (N, K, S, Co) at B=4: K up to 31, S*Co not a multiple
# of 32, and (5000 x 12 entries) dverts in two windows
K9_SHAPES = ((2056, 20, 7, 128), (1001, 5, 3, 64), (257, 31, 9, 96), (5000, 12, 10, 32))
FUSED_BWD_PARTS = (("inverse_index_kernel", "inverse_index"), ("route_kernel", "route"),
                   ("rf_grad_kernel", "rf_grad"), ("dd_partial_kernel", "dd_partial"),
                   ("dfeat_source_kernel", "dfeat_source"), ("source_proj_kernel", "source"),
                   ("dverts_kernel", "dverts"),
                   ("dg_rows_kernel", "dg_rows"), ("gemm_kernel<float, false, true", "dfeat_gemm"),
                   ("gemm_kernel<", "dw_gemm"), ("sum_partials_kernel", "partial_sum"))


def surface_bwd_bounds(rf, dirs, win, gb, drf, op_dtype) -> dict:
    """Each launch of one K15 call: the routing kernel reads rf, dirs, win
    and gb once and writes drf and the 16-query tiles' dd partial sums, with
    theta, drf's and dd's multiply-adds at each winner; the partial sum
    reads the tiles' rows and writes dd."""
    B, N, sc = win.shape
    tiles = B * -(-N // 16)
    return {"route_drf_dd": bound([rf, dirs, win, gb, drf], 9 * win.numel(), op_dtype,
                                  tiles * 3 * sc * 4),
            "partial_sum": bound([], 0, torch.float32, (tiles + 1) * 3 * sc * 4)}


def surface_fused_bwd_bounds(verts, idx, dirs, win, gb) -> dict:
    """Each launch of one K9 call: the fused kernel reads verts, idx, dirs,
    win and gb once and writes drf, dvq and the 64-query chunks' rows of dd
    partial sums, with theta, drfn's and dd's multiply-adds at each winner
    (at the fp32 rate, the bf16 tier's fp64 drfn sums counted as fp32); the
    partial sum reads the rows and writes dd; dverts reads idx, drf and dvq
    and writes dverts."""
    B, N, K = idx.shape
    sc, parts, f32 = win.shape[-1], B * -(-N // 64), 4
    drf, rows = idx.numel() * 3 * f32, B * N * 3 * f32
    return {"route_drf_dd": bound([verts, idx, dirs, win, gb], 9 * win.numel(), torch.float32,
                                  drf + rows + parts * 3 * sc * f32),
            "partial_sum": bound([], 0, torch.float32, (parts + 1) * 3 * sc * f32),
            "dverts": bound([idx], 0, torch.float32, drf + 2 * rows)}


def support_bwd_bounds(g, rf, w, dirs, win, gb, recompute: bool, op_dtype) -> dict:
    """Each launch of one K13 (or, with ``recompute``, K14) call: its
    bound from its own inputs and outputs, each once."""
    rows, K, cin = g.numel() // (g.shape[-2] * g.shape[-1]), g.shape[-2], g.shape[-1]
    sc, co = win.shape[-1], gb.shape[-1]
    f32, esz = 4, g.element_size()
    parts = -(-rows // 128)
    winners = 3 * rows * sc * f32 + rows * co * f32  # win, twin, pwin, gb
    out = {"rows": bound([], rows * sc * (cin + 3), op_dtype,
                         winners + cin * sc * f32 + 3 * sc * esz + rows * K * (cin + 3) * esz),
           "reduction": bound([], rows * sc * (cin + 4), op_dtype,
                              winners + rows * K * (cin + 3) * esz + parts * (cin + 4) * sc * f32),
           "partial_sum": bound([], 0, op_dtype, (parts + 1) * (cin + 4) * sc * f32)}
    if recompute:
        out = {"recompute": bound([], rows * sc * (cin + 3), op_dtype,
                                  rows * K * (cin + 3) * esz + cin * sc * f32 + sc * f32
                                  + 3 * sc * esz + 3 * rows * sc * f32), **out}
    return out


def support_fwd_bounds(feat, rf, idx, w, b, dirs, co: int, store: bool, op_dtype) -> dict:
    """Each launch of one K11 call: the projection of the source rows
    (feat, W, b in, P out) and the gather-reduction (P, rf, idx, dirs in;
    out, win and, with ``store``, twin and pwin out), each once."""
    rows, cin = feat.numel() // feat.shape[-1], feat.shape[-1]
    sc, K = w.shape[1], idx.shape[-1]
    p_bytes = rows * sc * 4
    return {"projection": bound([feat, b], rows * cin * sc, op_dtype, cin * sc * 4 + p_bytes),
            "reduction": bound([rf, idx, dirs], rows * K * sc, torch.float32,
                               p_bytes + rows * sc * 4 * (3 if store else 1) + rows * co * 4)}


def fused_bwd_bounds(feat, verts, idx, w, win, gb, op_dtype) -> dict:
    """Each launch of one K8 call, from its own inputs and outputs, each
    once; the bf16 tier's rows (dg_rows, dfeat_source) stand in for fp32's
    dfeat product."""
    B, N, K = idx.shape
    rows, cin, sc, co = B * N, feat.shape[-1], win.shape[-1], gb.shape[-1]
    f32, fast = 4, feat.dtype == torch.bfloat16
    plane = rows * sc * f32  # one (B, N, S*Co) fp32 tensor
    small = rows * 3 * f32 + idx.numel() * 4 + 3 * sc * f32  # verts, idx, dirs
    lists = (B * (N + 1) + idx.numel()) * 4
    parts, dw_parts = -(-N // 64) * B, -(-rows // 256)
    out = {"inverse_index": bound([idx], 0, torch.float32, lists),
           "route": bound([], 3 * rows * sc, torch.float32,
                          small + 4 * plane + rows * co * f32),  # win, P in; dz, dproj out
           "rf_grad": bound([], 3 * rows * sc, torch.float32,
                            small + 2 * plane + idx.numel() * 3 * f32 + rows * 3 * f32),
           "dd_partial": bound([], 4 * rows * sc, torch.float32,
                               small + 3 * plane + parts * 4 * sc * f32),
           "source": bound([idx], 0, torch.float32, 3 * plane),
           "dverts": bound([], 0, torch.float32, lists + idx.numel() * 3 * f32
                           + 2 * rows * 3 * f32),
           "dw_gemm": bound([feat], rows * cin * sc, torch.float32,
                            plane + dw_parts * cin * sc * f32),
           "partial_sum": bound([], 0, torch.float32,
                                (parts + 1) * 4 * sc * f32 + (dw_parts + 1) * cin * sc * f32)}
    if fast:
        dg = idx.numel() * cin * 2
        out["dg_rows"] = bound([], rows * sc * cin, op_dtype, 2 * plane + cin * sc * f32 + dg)
        out["dfeat_source"] = bound([], 0, torch.float32, lists + dg + rows * cin * 2)
    else:
        out["dfeat_gemm"] = bound([w], rows * sc * cin, torch.float32, plane + rows * cin * f32)
    return out


def launch_parts(phase: str, r: dict, label: str, fn, bounds: dict, names, per_call=None,
                 calls: int = 10) -> None:
    """A kernel's launches timed apart: each part's mean device time per
    launch (by torch.profiler over ``calls`` calls after one) times its
    launches per call (``per_call``, 1 unless given), summed over the pass
    into r["parts"] beside its bound.  ``names`` maps the kernels to parts
    (SUPPORT_BWD_PARTS, ...).  Each part of ``bounds`` must launch, at most
    ``per_call`` times a call, and no other part may (the profiler can drop
    a launch's record, so a part may show fewer).  A session in which the
    profiler recorded no launch of any part is run again, up to twice: the
    gate still fails if the parts never launch."""
    from torch.profiler import ProfilerActivity, profile

    per_call = per_call or {}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the calls queue behind a sleep kernel: launches that run while
            # the session starts are not recorded
            torch.cuda._sleep(QUEUE_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
                continue
            part = next((p for k, p in names if k in e.name), None)
            if part is not None:
                total[part] = total.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
                count[part] = count.get(part, 0) + 1
        if count:
            break
        log(phase, f"  {label}: the profiler recorded no launch of any part; the session again")
    if set(count) != set(bounds) or any(n > calls * per_call.get(p, 1) for p, n in count.items()):
        raise AssertionError(f"{label}: launches over {calls} calls {count}, expected at most "
                             f"{ {p: per_call.get(p, 1) for p in bounds} } a call")
    ms = {part: total[part] / count[part] * per_call.get(part, 1) for part in bounds}
    parts = r.setdefault("parts", {})
    for part, (bms, by) in bounds.items():
        e = parts.setdefault(part, {"ms": 0.0, "bound_ms": 0.0, "bound_ms_by": {}})
        e["ms"] += ms[part]
        e["bound_ms"] += bms
        e["bound_ms_by"][by] = e["bound_ms_by"].get(by, 0.0) + bms
        e["bound_by"] = max(e["bound_ms_by"], key=e["bound_ms_by"].get)
    r["launches_per_call"] = sum(per_call.get(p, 1) for p in bounds)
    log(phase, f"  {label}: " + ", ".join(f"{part} {ms[part]:.4f} ms (bound {bms:.4f} {by})"
                                         for part, (bms, by) in bounds.items())
        + f"; launches seen over {calls} calls {count}")


def library_part(r: dict, part: str, ms: float) -> None:
    """Add a library yardstick's time to r["parts"][part]["library_ms"]."""
    e = r["parts"][part]
    e["library_ms"] = e.get("library_ms", 0.0) + ms


def layer_time(r: dict, layer: int, ms: float, pms: float, bnd) -> None:
    r.setdefault("layers", []).append({"layer": layer, "ms": ms, "plain_ms": pms,
                                       "bound_ms": bnd[0]})


def support_fwd_work(fargs, src, win) -> tuple[list, float]:
    """K11's least work (with its outputs, which ``compare_cotangents``
    adds): feat, rf, idx, W, b, dirs read and win written once; the
    projection of the B*N source rows and theta at each (query, k, column)."""
    g, rf, w, b, dirs, S, co = fargs
    feat, idx = src["feat"], src["idx"]
    return [feat, rf, idx, w, b, dirs, win], feat.numel() * S * co + rf.numel() * S * co


def support_fwd_detail(phase: str, r: dict, layer: int, label: str, fargs, src, store: bool,
                       ms: float, pms: float, bnd, op_dtype) -> None:
    """K11's per-layer time, the bound of the design it replaced (every
    gathered row projected: g read and (B, N, K) * S*Co multiply-adds,
    summed in r["bound_gathered_ms"]), its two launches timed apart
    (``launch_parts``) and, for the projection, a library product as
    yardstick (``torch.addmm`` in fp32 with TF32 off, ``torch.matmul`` on
    bf16 operands; the port never calls it)."""
    from hspose_tpu_torch.ops import cuda_hs

    g, rf, w, b, dirs, S, co = fargs
    feat = src["feat"]
    layer_time(r, layer, ms, pms, bnd)
    old = bound([g, rf, w, b, dirs], (g.numel() + rf.numel()) * S * co, op_dtype,
                feat.shape[0] * feat.shape[1] * (S * co * (12 if store else 4) + co * 4))
    r["bound_gathered_ms"] = r.get("bound_gathered_ms", 0.0) + old[0]
    launch_parts(phase, r, label,
                 lambda: cuda_hs.hs_support_fwd(*fargs, store=store, **src),
                 support_fwd_bounds(feat, rf, src["idx"], w, b, dirs, co, store, op_dtype),
                 SUPPORT_FWD_PARTS)
    feat2d = feat.reshape(-1, feat.shape[-1])
    if feat.dtype == torch.bfloat16:
        w16 = w.to(torch.bfloat16)
        library_part(r, "projection", cuda_ms(lambda: torch.matmul(feat2d, w16), 10))
    else:
        library_part(r, "projection", cuda_ms(lambda: torch.addmm(b, feat2d, w), 10))
    log(phase, f"  {label}: gather-then-project bound {old[0]:.4f} ms ({old[1]}), projection "
               f"library {r['parts']['projection']['library_ms']:.4f} ms (summed so far)")


def phase_train_kernels(dtype: str = "float32") -> dict:
    """K12, K15, K11, K13 against their plain versions at the train step's
    shapes (B=16), fp32 or the bf16 instantiations (bf16 rf, gathered rows
    and directions as the bf16 train step forms them; W and b fp32).  The
    backwards get the kernel forward's residuals on both sides, so winner
    flips do not enter their comparison.  Returns per-kernel records; ms and
    plain_ms sum the calls of one train step."""
    from hspose_tpu_torch.ops import cuda_hs
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-train-kernels", "_bf16") if fast else ("train-kernels", "")
    op_dtype = torch.bfloat16 if fast else torch.float32
    rng = np.random.default_rng(SEED + 4)
    rec = {}
    S, B = 7, TRAIN_B

    def compare(name, label, pairs, ms, pms, tensors, macs):
        return compare_cotangents(phase, rec, name + tag, label, pairs, ms, pms, tensors, macs,
                                  op_dtype)

    def winners(name, label, wk, wp, mk, mp):
        check_winners(phase, name + tag, label, wk, wp, mk, mp)

    # K12 / K15: conv_0
    verts = cloud_b(rng, B, N)
    rf = neighbor_directions_normalized(verts.to(op_dtype),
                                        knn_indices_cuda(verts, 20, packed=fast))
    co, dirs = 128, unit_dirs(rng, S * 128).to(op_dtype)
    label = f"conv_0 N={N} K=20 Co={co}"
    out_k, win_k = cuda_hs.hs_surface_fwd(rf, dirs, S, co)
    out_p, win_p = cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co)
    theta = torch.relu(rf.double() @ dirs.double())  # (B, N, K, S*Co)
    winners("hs_surface_fwd", label, win_k, win_p,
            theta.gather(2, win_k.long()[:, :, None]).squeeze(2),
            theta.gather(2, win_p.long()[:, :, None]).squeeze(2))
    del theta
    fwd_bound = compare("hs_surface_fwd", label, [("out", out_k, out_p)],
                        cuda_ms(lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, co), 10),
                        cuda_ms(lambda: cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co), 10),
                        [rf, dirs, win_k], rf.numel() * S * co)
    launch_parts(phase, rec["hs_surface_fwd" + tag], label,
                 lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, co), {"reduction": fwd_bound},
                 SURFACE_FWD_PARTS)
    gb = normal(rng, B, N, co)
    args = (rf, dirs, win_k, gb, S, co)
    drf_k, dd_k = cuda_hs.hs_surface_bwd(*args)
    compare("hs_surface_bwd", label,
            list(zip(("drf", "dd"), (drf_k, dd_k), cuda_hs.hs_surface_bwd_plain(*args))),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd(*args), 10),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd_plain(*args), 10),
            [rf, dirs, win_k, gb], 9 * win_k.numel())  # theta, drf, dd at each winner
    launch_parts(phase, rec["hs_surface_bwd" + tag], label,
                 lambda: cuda_hs.hs_surface_bwd(*args),
                 surface_bwd_bounds(rf, dirs, win_k, gb, drf_k, op_dtype), SURFACE_BWD_PARTS)

    # K11 / K13: conv_1 .. conv_4, w and b as column slices of the layer's matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                 (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        verts = cloud_b(rng, B, n)
        feat = torch.relu(normal(rng, B, n, cin)).to(op_dtype)
        idx = knn_indices_cuda(feat, k, packed=fast)
        g = gather_neighbors(feat, idx)
        rf = neighbor_directions_normalized(verts.to(op_dtype), idx)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        fargs = (g, rf, w_full[:, co:], b_full[co:], unit_dirs(rng, S * co).to(op_dtype), S, co)
        src = {"feat": feat, "idx": idx}  # K11 reads the rows g gathers
        out_k, win_k, tw_k, pw_k = cuda_hs.hs_support_fwd(*fargs, **src)
        out_p, win_p, tw_p, pw_p = cuda_hs.hs_support_fwd_plain(*fargs)
        winners("hs_support_fwd", label, win_k, win_p, tw_k * pw_k, tw_p * pw_p)
        same = win_k == win_p
        ms = cuda_ms(lambda: cuda_hs.hs_support_fwd(*fargs, **src), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_fwd_plain(*fargs), 10)
        bnd = compare("hs_support_fwd", label,
                      [("out", out_k, out_p), ("twin", tw_k * same, tw_p * same),
                       ("pwin", pw_k * same, pw_p * same)], ms, pms,
                      *support_fwd_work(fargs, src, win_k))
        support_fwd_detail(phase, rec["hs_support_fwd" + tag], layer, label, fargs, src, True,
                           ms, pms, bnd, op_dtype)
        gb = normal(rng, B, n, co)
        bargs = (g, rf, fargs[2], fargs[4], win_k, tw_k, pw_k, gb, S, co)
        ms = cuda_ms(lambda: cuda_hs.hs_support_bwd(*bargs), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_bwd_plain(*bargs), 10)
        bnd = compare("hs_support_bwd", label,
                      list(zip(("dg", "drf", "dw", "db", "dd"), cuda_hs.hs_support_bwd(*bargs),
                               cuda_hs.hs_support_bwd_plain(*bargs))), ms, pms,
                      [g, rf, fargs[2], fargs[4], win_k, tw_k, pw_k, gb],
                      win_k.numel() * (2 * cin + 6))  # dg, dW at each winner; drf, dd
        r = rec["hs_support_bwd" + tag]
        layer_time(r, layer, ms, pms, bnd)
        launch_parts(phase, r, label, lambda: cuda_hs.hs_support_bwd(*bargs),
                     support_bwd_bounds(g, rf, fargs[2], fargs[4], win_k, gb, False, op_dtype),
                     SUPPORT_BWD_PARTS)
    return rec


def same_bits(name: str, label: str, first, second) -> None:
    """Two launches on the same inputs must give the same bits."""
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {label}: two launches on the same inputs differ")


def phase_v4_kernels(dtype: str = "float32") -> tuple[dict, dict]:
    """K11 without winner values and K14 at the four HS layers' shapes of
    the B=16 step (bwd_store=False); the fused ops' winner-recording
    forwards (K2-K4) and their backwards K9, K8 and K10 at conv_0's,
    conv_2..conv_4's and their ORL branches' shapes (train_v4_small): each
    against its plain version (forwards within TOL_REL of the largest value
    and winners as in phase 8; backwards fed the kernel forward's residuals
    on both sides, fp32 cotangents within TOL_REL of their largest value,
    bf16 ones within one bf16 ulp of each element more), K14 against K13 on
    the same inputs bit for bit, the forwards with winners against the
    serving kernels bit for bit, two launches with the same bits; then one
    autograd backward through ``hs_surface_fused`` (K9's carrier).  fp32
    (phase 12) or the bf16 instantiations (phase 14: bf16 features, rf and
    directions as the bf16 step forms them, W, b and the fused ops'
    vertices and directions fp32).  Returns the per-kernel records and the
    carrier's launches."""
    from hspose_tpu_torch.ops import cuda_hs, cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-v4-train-kernels", "_bf16") if fast else ("v4-train-kernels", "")
    op = torch.bfloat16 if fast else torch.float32
    rng = np.random.default_rng(SEED + (9 if fast else 8))
    rec = {}
    S, B = 7, TRAIN_B

    def compare(name, *args):
        return compare_cotangents(phase, rec, name + tag, *args, op_dtype=op)

    def winners(name, *args):
        check_winners(phase, name + tag, *args)

    def bits(name, *args):
        same_bits(name + tag, *args)

    def at_win(x, win):  # x (B, N, K, C) at each column's winner
        return x.gather(2, win.long()[:, :, None]).squeeze(2)

    def fused_theta(verts, idx, d):  # relu(rfn . d) of the fused ops, (B, N, K, C)
        if fast:
            return f._theta_fast(f._rf_fast(verts, idx), f._bf16(d))
        return torch.relu(neighbor_directions_normalized(verts, idx) @ d)

    def knn(pts, k):
        return knn_indices_cuda(pts, k, packed=fast)

    # K11 without winner values, K14: the four HS layers (bwd_store=False alone)
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                 (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        feat = torch.relu(normal(rng, B, n, cin)).to(op)
        idx = knn(feat, k)
        g = gather_neighbors(feat, idx)
        rf = neighbor_directions_normalized(cloud_b(rng, B, n).to(op), idx)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w, b = normal(rng, cin, (S + 1) * co, scale=stdv), normal(rng, (S + 1) * co, scale=stdv)
        fargs = (g, rf, w[:, co:], b[co:], unit_dirs(rng, S * co).to(op), S, co)
        src = {"feat": feat, "idx": idx}  # K11 reads the rows g gathers
        out_k, win_k = cuda_hs.hs_support_fwd(*fargs, store=False, **src)
        out_p, win_p = cuda_hs.hs_support_fwd_plain(*fargs)[:2]
        stored = cuda_hs.hs_support_fwd(*fargs, **src)
        bits("hs_support_fwd_novals", label, (out_k, win_k), stored[:2])
        theta_proj = [cuda_hs._theta(rf, fargs[4][:, sl])
                      * (g.float() @ cuda_hs._operand(fargs[2][:, sl], fast) + fargs[3][sl])
                      for sl in (slice(i * co, (i + 1) * co) for i in range(S))]
        vk = torch.cat([at_win(x, win_k[..., i * co:(i + 1) * co])
                        for i, x in enumerate(theta_proj)], -1)
        vp = torch.cat([at_win(x, win_p[..., i * co:(i + 1) * co])
                        for i, x in enumerate(theta_proj)], -1)
        del theta_proj
        winners("hs_support_fwd_novals", label, win_k, win_p, vk, vp)
        ms = cuda_ms(lambda: cuda_hs.hs_support_fwd(*fargs, store=False, **src), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_fwd_plain(*fargs), 10)
        bnd = compare("hs_support_fwd_novals", label, [("out", out_k, out_p)], ms, pms,
                      *support_fwd_work(fargs, src, win_k))
        support_fwd_detail(phase, rec["hs_support_fwd_novals" + tag], layer, label, fargs, src,
                           False, ms, pms, bnd, op)
        gb = normal(rng, B, n, co)
        bargs = (g, rf, fargs[2], fargs[3], fargs[4], win_k, gb, S, co)
        got = cuda_hs.hs_support_bwd_recompute(*bargs)
        bits("hs_support_bwd_recompute", label, got, cuda_hs.hs_support_bwd_recompute(*bargs))
        k13 = cuda_hs.hs_support_bwd(g, rf, fargs[2], fargs[4], win_k, stored[2], stored[3], gb,
                                     S, co)
        bits("hs_support_bwd_recompute", label + " (against K13 on the forward's stored values)",
             got, k13)
        log(phase, f"hs_support_bwd_recompute{tag} {label}: K13's bits on the forward's stored "
                   f"values")
        ms = cuda_ms(lambda: cuda_hs.hs_support_bwd_recompute(*bargs), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_bwd_recompute_plain(*bargs), 10)
        bnd = compare("hs_support_bwd_recompute", label,
                      list(zip(("dg", "drf", "dw", "db", "dd"), got,
                               cuda_hs.hs_support_bwd_recompute_plain(*bargs))), ms, pms,
                      [g, rf, fargs[2], fargs[3], fargs[4], win_k, gb],
                      win_k.numel() * (3 * cin + 9))  # P at each winner; dg, dW; theta, drf, dd
        r = rec["hs_support_bwd_recompute" + tag]
        layer_time(r, layer, ms, pms, bnd)
        launch_parts(phase, r, label, lambda: cuda_hs.hs_support_bwd_recompute(*bargs),
                     support_bwd_bounds(g, rf, fargs[2], fargs[4], win_k, gb, True, op),
                     SUPPORT_BWD_PARTS)

    # K2 with winners, K9: conv_0
    label = f"conv_0 N={N} K=20 Co=128"
    verts = cloud_b(rng, B, N)
    idx = knn(verts, 20)
    dirs = unit_dirs(rng, S * 128)
    fargs = (verts, idx, dirs, S, 128)
    (out_k, win_k), (out_p, win_p) = (f.hs_surface_fused_fwd(*fargs, exact=not fast),
                                      f.hs_surface_fused_fwd_plain(*fargs, exact=not fast))
    theta = fused_theta(verts, idx, dirs)
    winners("hs_surface_fused_fwd", label, win_k, win_p, at_win(theta, win_k), at_win(theta, win_p))
    del theta
    with torch.no_grad():
        serving = f.hs_surface_fused(*fargs, exact=not fast)
    bits("hs_surface_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
    compare("hs_surface_fused_fwd", label, [("out", out_k, out_p)],
            cuda_ms(lambda: f.hs_surface_fused_fwd(*fargs, exact=not fast), 10),
            cuda_ms(lambda: f.hs_surface_fused_fwd_plain(*fargs, exact=not fast), 10),
            [verts, idx, dirs, win_k], 3 * idx.numel() * S * 128)
    gb = normal(rng, B, N, 128)
    bargs = (verts, idx, dirs, win_k, gb, S, 128)
    got = f.hs_surface_fused_bwd(*bargs, exact=not fast)
    bits("hs_surface_fused_bwd", label, got, f.hs_surface_fused_bwd(*bargs, exact=not fast))
    compare("hs_surface_fused_bwd", label,
            list(zip(("dverts", "dd"), got, f.hs_surface_fused_bwd_plain(*bargs, exact=not fast))),
            cuda_ms(lambda: f.hs_surface_fused_bwd(*bargs, exact=not fast), 10),
            cuda_ms(lambda: f.hs_surface_fused_bwd_plain(*bargs, exact=not fast), 10),
            [verts, idx, dirs, win_k, gb], 9 * win_k.numel())  # theta, drfn, dd at each winner
    # three launches a call: launch_parts raises on an inverse_index_kernel launch
    launch_parts(phase, rec["hs_surface_fused_bwd" + tag], label,
                 lambda: f.hs_surface_fused_bwd(*bargs, exact=not fast),
                 surface_fused_bwd_bounds(verts, idx, dirs, win_k, gb), SURFACE_FUSED_BWD_PARTS)
    for n, k, s_, co in K9_SHAPES:  # off conv_0's shape: against plain, twice bit for bit
        shape = f"B=4 N={n} K={k} S={s_} Co={co}"
        verts = cloud_b(rng, 4, n)
        verts[:, 1] = verts[:, 0]  # a duplicated point: |rf| = 0
        idx = knn(verts, k)
        dirs = unit_dirs(rng, s_ * co)
        win = f.hs_surface_fused_fwd(verts, idx, dirs, s_, co, exact=not fast)[1]
        kargs = (verts, idx, dirs, win, normal(rng, 4, n, co), s_, co)
        got = f.hs_surface_fused_bwd(*kargs, exact=not fast)
        bits("hs_surface_fused_bwd", shape, got, f.hs_surface_fused_bwd(*kargs, exact=not fast))
        compare("hs_surface_fused_bwd", shape + " (twice, same bits)",
                list(zip(("dverts", "dd"), got,
                         f.hs_surface_fused_bwd_plain(*kargs, exact=not fast))), None, 0.0, [], 0)

    # K3 with winners, K8: conv_2 .. conv_4 (train_v4_small)
    for layer, cin, co, n, k in [(2, 128, 256, N // 4, 20), (3, 256, 256, N // 4, 20),
                                 (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        feat = torch.relu(normal(rng, B, n, cin)).to(op)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w, b = normal(rng, cin, (S + 1) * co, scale=stdv), normal(rng, (S + 1) * co, scale=stdv)
        verts, idx = cloud_b(rng, B, n), knn(feat, k)
        fargs = (feat, verts, idx, w[:, co:], b[co:], unit_dirs(rng, S * co), S, co)
        (out_k, win_k, proj_k), (out_p, win_p, proj_p) = (f.hs_support_fused_fwd(*fargs),
                                                          f.hs_support_fused_fwd_plain(*fargs))
        theta = fused_theta(verts, idx, fargs[5])
        prod = [theta[..., i * co:(i + 1) * co]
                * gather_neighbors(proj_p[..., i * co:(i + 1) * co], idx) for i in range(S)]
        del theta
        winners("hs_support_fused_fwd", label, win_k, win_p,
                torch.cat([at_win(x, win_k[..., i * co:(i + 1) * co]) for i, x in enumerate(prod)], -1),
                torch.cat([at_win(x, win_p[..., i * co:(i + 1) * co]) for i, x in enumerate(prod)], -1))
        del prod
        with torch.no_grad():
            serving = f.hs_support_fused(*fargs)
        bits("hs_support_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
        compare("hs_support_fused_fwd", label, [("out", out_k, out_p), ("proj", proj_k, proj_p)],
                cuda_ms(lambda: f.hs_support_fused_fwd(*fargs), 10),
                cuda_ms(lambda: f.hs_support_fused_fwd_plain(*fargs), 10),
                list(fargs[:6]) + [win_k], B * n * cin * S * co + 3 * idx.numel() * S * co)
        gb = normal(rng, B, n, co)
        bargs = (feat, verts, idx, fargs[3], fargs[5], win_k, proj_k, gb, S, co)
        got = f.hs_support_fused_bwd(*bargs)
        bits("hs_support_fused_bwd", label, got, f.hs_support_fused_bwd(*bargs))
        ms = cuda_ms(lambda: f.hs_support_fused_bwd(*bargs), 10)
        pms = cuda_ms(lambda: f.hs_support_fused_bwd_plain(*bargs), 10)
        bnd = compare("hs_support_fused_bwd", label,
                      list(zip(("dfeat", "dverts", "dw", "db", "dd"), got,
                               f.hs_support_fused_bwd_plain(*bargs))), ms, pms,
                      [feat, verts, idx, fargs[3], fargs[5], win_k, proj_k, gb],
                      2 * B * n * cin * S * co + 9 * win_k.numel())  # dfeat, dW; theta, drfn, dd
        r = rec["hs_support_fused_bwd" + tag]
        layer_time(r, layer, ms, pms, bnd)
        # K8's launches apart; its two products beside one library product each
        # (fp32, TF32 off; the port never calls them), on the projection P as a
        # stand-in of the same shape for dproj_src
        launch_parts(phase, r, label, lambda: f.hs_support_fused_bwd(*bargs),
                     fused_bwd_bounds(feat, verts, idx, fargs[3], win_k, gb, op),
                     FUSED_BWD_PARTS, {"partial_sum": 2})
        p2d, feat2d = proj_k.reshape(B * n, -1), feat.reshape(B * n, cin).float()
        if not fast:
            w_t = fargs[3].t()
            library_part(r, "dfeat_gemm", cuda_ms(lambda: torch.matmul(p2d, w_t), 10))
        feat_t = feat2d.t()
        library_part(r, "dw_gemm", cuda_ms(lambda: torch.matmul(feat_t, p2d), 10))

    # K4 with winners, K10: the ORL branches of conv_2 .. conv_4
    for layer, c, n, k in [(2, 256, N // 4, 20), (3, 256, N // 4, 20), (4, 512, N // 16, 8)]:
        label = f"conv_{layer} C={c} N={n} K={k}"
        feat, idx = normal(rng, B, n, c).to(op), knn(cloud_b(rng, B, n), k)
        (out_k, win_k), (out_p, win_p) = (f.orl_global_fused_fwd(feat, idx),
                                          f.orl_global_fused_fwd_plain(feat, idx))
        rows = gather_neighbors(feat, idx).float()
        winners("orl_global_fused_fwd", label, win_k, win_p, at_win(rows, win_k),
                at_win(rows, win_p))
        with torch.no_grad():
            serving = f.orl_global_fused(feat, idx)
        bits("orl_global_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
        compare("orl_global_fused_fwd", label, [("out", out_k, out_p)],
                cuda_ms(lambda: f.orl_global_fused_fwd(feat, idx), 10),
                cuda_ms(lambda: f.orl_global_fused_fwd_plain(feat, idx), 10),
                [feat, idx, win_k], 0)
        gb = normal(rng, B, 1, c)
        got = f.orl_global_fused_bwd(idx, win_k, gb, op)
        bits("orl_global_fused_bwd", label, (got,), (f.orl_global_fused_bwd(idx, win_k, gb, op),))
        bnd = compare("orl_global_fused_bwd", label,
                      [("dfeat", got, f.orl_global_fused_bwd_plain(idx, win_k, gb, op))],
                      cuda_ms(lambda: f.orl_global_fused_bwd(idx, win_k, gb, op), 10),
                      cuda_ms(lambda: f.orl_global_fused_bwd_plain(idx, win_k, gb, op), 10),
                      [idx, win_k, gb], 0)
        # one launch a call: launch_parts raises on an inverse_index_kernel
        # launch, or on more orl_bwd launches than calls (the profiler can
        # drop a record, so it may see fewer)
        launch_parts(phase, rec["orl_global_fused_bwd" + tag], label,
                     lambda: f.orl_global_fused_bwd(idx, win_k, gb, op), {"orl_bwd": bnd},
                     ORL_BWD_PARTS)

    # K9's carrier: one autograd backward through hs_surface_fused
    names = [name + tag for name in ("hs_surface", "hs_surface_fused_fwd", "hs_surface_fused_bwd")]
    counts = {name: counters()[name] for name in names}
    verts = cloud_b(rng, B, N).requires_grad_(True)
    idx = knn(verts.detach(), 20)
    dirs = unit_dirs(rng, S * 128).requires_grad_(True)
    gb = normal(rng, B, N, 128)
    reset_counts(counts)
    (f.hs_surface_fused(verts, idx, dirs, S, 128, exact=not fast) * gb).sum().backward()
    torch.cuda.synchronize()
    carrier = read_counts(counts)
    log(phase, f"autograd through hs_surface_fused at conv_0's shape: launches {carrier}")
    check_counts(carrier, {names[1]: 1, names[2]: 1}, 1, "backward")
    vd, dd = verts.detach(), dirs.detach()
    want = f.hs_surface_fused_bwd(vd, idx, dd, f.hs_surface_fused_fwd(vd, idx, dd, S, 128,
                                                                      exact=not fast)[1],
                                  gb, S, 128, exact=not fast)
    bits("hs_surface_fused autograd", "conv_0", (verts.grad, dirs.grad), want)
    return rec, carrier


def build_train_model(device, cfg):
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    return build_model(cfg, device=device, train_heads=True)


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


def train_once(cfg, model, batch: dict, draws, device) -> tuple[dict, dict, dict]:
    """One train forward and backward of ``model`` on the numpy ``batch``:
    (loss terms with the total, BatchNorm running statistics, parameter
    gradients), on the CPU."""
    from hspose_tpu_torch.engine.train_step import to_device
    from hspose_tpu_torch.models.hspose import train_forward

    total, losses = train_forward(cfg, model, to_device(batch, device), draws=draws.to(device))
    total.backward()
    terms = {"total": total.item(),
             **{f"{f}/{k}": v.item() for f, d in losses.items() for k, v in d.items()}}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return terms, stats, {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def step_gaps(a: tuple, b: tuple) -> dict:
    """How far two ``train_once`` results lie apart: the largest loss-term
    difference as a share of the total loss, the largest BatchNorm-statistic
    difference as a share of that buffer's largest value, and 1 - the cosine
    of all parameter gradients as one vector."""
    (ta, sa, ga), (tb, sb, gb) = a, b
    loss = max(abs(ta[k] - v) for k, v in tb.items()) / abs(tb["total"])
    bn = max(((sa[n] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
             for n, v in sb.items())
    g1, g2 = (torch.cat([g[n].double().ravel() for n in gb]) for g in (ga, gb))
    cos = (g1 @ g2).item() / (g1.norm().item() * g2.norm().item())
    return {"loss": loss, "bn": bn, "grad": 1.0 - cos}


def _flag_launches(tag: str, knn: str, store: bool, v4: bool) -> dict:
    """Launches per train step of one tier (``tag`` "" or "_bf16") under the
    two training flags: conv_0 on K12/K15; conv_1 .. conv_4 on K11/K13
    (``store``) or K11 without winner values and K14, except that with
    ``v4`` conv_2 .. conv_4 and their ORL branches take the fused ops'
    K3/K8 and K4/K10."""
    support = ({"hs_support_fwd": 1, "hs_support_bwd": 1} if store else
               {"hs_support_fwd_novals": 1, "hs_support_bwd_recompute": 1})
    layers = 1 if v4 else 4
    out = {knn: 9, "hs_surface_fwd" + tag: 1, "hs_surface_bwd" + tag: 1,
           **{name + tag: n * layers for name, n in support.items()}}
    if v4:
        out.update({name + tag: 3 for name in ("hs_support_fused_fwd", "hs_support_fused_bwd",
                                              "orl_global_fused_fwd", "orl_global_fused_bwd")})
    return out


# per train step, in each training configuration: the default fp32 and bf16
# steps, and in each tier the step with bwd_store=False and train_v4_small=True
# ("v4", "bf16v4": conv_1 on K11 without winner values and K14, conv_2 ..
# conv_4 and their ORL branches on the fused ops' K3/K8 and K4/K10) and with
# each flag alone ("recompute", "v4only" and their bf16 twins)
TRAIN_TIERS = {  # tier -> (compute_dtype, bwd_store, train_v4_small)
    "float32": ("float32", True, False), "bfloat16": ("bfloat16", True, False),
    "v4": ("float32", False, True), "bf16v4": ("bfloat16", False, True),
    "recompute": ("float32", False, False), "bf16recompute": ("bfloat16", False, False),
    "v4only": ("float32", True, True), "bf16v4only": ("bfloat16", True, True),
}
TRAIN_LAUNCHES = {
    tier: _flag_launches("_bf16" if dt == "bfloat16" else "",
                         "knn_packed" if dt == "bfloat16" else "knn", store, v4)
    for tier, (dt, store, v4) in TRAIN_TIERS.items()}


def train_config(tier: str):
    from hspose_tpu_torch.config import ModelConfig

    dt, store, v4 = TRAIN_TIERS[tier]
    return ModelConfig(compute_dtype=dt, bwd_store=store, train_v4_small=v4)


def phase_train(smi: str, tier: str = "float32") -> tuple[dict, float]:
    """The train step of one configuration of ``TRAIN_LAUNCHES`` at full
    width: launches, sanity, card against CPU, steps/s.  Returns the
    kernels' launches of the main run and the best steps/s."""
    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models.hspose import draw_train
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    fast = TRAIN_TIERS[tier][0] == "bfloat16"
    phase, name = {"float32": ("train", "fp32"), "bfloat16": ("bf16-train", "bf16"),
                   "v4": ("v4-train", "fp32 bwd_store=False train_v4_small=True"),
                   "bf16v4": ("bf16-v4-train", "bf16 bwd_store=False train_v4_small=True")}[tier]
    cfg = HSPoseConfig(model=train_config(tier))
    model = build_train_model(DEVICE, cfg.model)
    step = build_train_step(cfg, model, torch.Generator(device=DEVICE).manual_seed(SEED))
    batch = to_device(synthetic_train_batch(TRAIN_B, N, seed=SEED), DEVICE)
    before = [p.detach().clone() for p in model.parameters()]

    counts = {**counters(), **train_counters()}
    reset_counts(counts)
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = read_counts(counts)
    log(phase, f"{TRAIN_STEPS} steps of ({TRAIN_B}, {N}, 3): launches {launches}")
    check_counts(launches, TRAIN_LAUNCHES[tier], TRAIN_STEPS, "train step")
    for i, m in enumerate(metrics):
        log(phase, f"step {i}: total_loss {m['total_loss']:.6f}, skipped_nan "
                   f"{m['skipped_nan']}, {len(m) - 2} loss terms")
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or m["skipped_nan"]:
            raise AssertionError(f"step {i}: non-finite {bad}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    change = max((a - p.detach()).abs().max().item() for a, p in zip(before, model.parameters()))
    # at the start of the warm-up the rate is lr * 1e-3, so small steps round away
    log(phase, f"{moved} of {len(before)} parameter tensors moved (largest change "
               f"{change:.3e}), optimizer count {step.optimizer.count}")
    if moved == 0 or step.optimizer.count != TRAIN_STEPS:
        raise AssertionError("the train step did not update the model")

    # one train forward and backward on the card and on the CPU plain ops
    cpu_model = build_train_model("cpu", cfg.model).train()
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    small = synthetic_train_batch(4, N, seed=SEED + 5)
    draws = draw_train(torch.Generator().manual_seed(SEED + 6), 4, N)
    card = train_once(cfg, copy.deepcopy(card_model), small, draws, DEVICE)
    cpu = train_once(cfg, cpu_model, small, draws, "cpu")
    if not fast:
        (card_loss, _, card_grad), (cpu_loss, _, cpu_grad) = card, cpu
        rel = {k: abs(card_loss[k] - v) / max(abs(v), 1e-12) for k, v in cpu_loss.items()}
        log(phase, "card against CPU, loss terms: worst rel diff "
                   f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        if not max(rel.values()) <= LOSS_REL:
            raise AssertionError(f"losses disagree beyond {LOSS_REL}: "
                                 f"{ {k: v for k, v in rel.items() if v > LOSS_REL} }")
        log(phase, "card against CPU, parameter gradients: " + grad_gates(card_grad, cpu_grad))
    else:
        # the bf16 step is chaotic (KNN, winner and max selections flip under
        # bf16 rounding), so the card is held to its own spread: the same
        # forward with the input cloud moved by SPREAD_EPS relative, both ways
        z = np.random.default_rng(SEED + 7).standard_normal(small["pcl_in"].shape)
        spread = {}
        for sign in (1.0, -1.0):
            moved_pc = (small["pcl_in"] * (1.0 + sign * SPREAD_EPS * z)).astype(np.float32)
            gaps = step_gaps(train_once(cfg, copy.deepcopy(card_model),
                                        dict(small, pcl_in=moved_pc), draws, DEVICE), card)
            spread = {k: max(spread.get(k, 0.0), v) for k, v in gaps.items()}
        gap = step_gaps(card, cpu)
        log(phase, "card against CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in gap.items())
            + "; the card's own spread: " + ", ".join(f"{k} {v:.3e}" for k, v in spread.items())
            + f"; bound {SPREAD_MULT} x spread")
        bad = {k: v for k, v in gap.items() if not v <= SPREAD_MULT * spread[k]}
        if bad:
            raise AssertionError(f"card and CPU disagree beyond {SPREAD_MULT} x the card's "
                                 f"spread: {bad}")

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
    log(phase, f"{max(rates)} steps/s at B={TRAIN_B} {name} (best of 3 windows of {iters} "
               f"steps: {rates}) on {smi}")
    return launches, max(rates)


def phase_train_flags(tiers=("recompute", "v4only", "bf16recompute", "bf16v4only")) -> None:
    """Each training flag alone, in both tiers: one train forward and
    backward at (16, 1028) on the card, its launch counts exactly
    ``TRAIN_LAUNCHES[tier]``, finite losses and gradients; no throughput."""
    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.models.hspose import draw_train
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    batch = synthetic_train_batch(TRAIN_B, N, seed=SEED)
    for tier in tiers:
        cfg = HSPoseConfig(model=train_config(tier))
        model = build_train_model(DEVICE, cfg.model).train()
        draws = draw_train(torch.Generator().manual_seed(SEED + 6), TRAIN_B, N)
        counts = {**counters(), **train_counters()}
        reset_counts(counts)
        terms, _, grads = train_once(cfg, model, batch, draws, DEVICE)
        torch.cuda.synchronize()
        launches = read_counts(counts)
        log("train-flags", f"{tier} {cfg.model.compute_dtype} bwd_store={cfg.model.bwd_store} "
                           f"train_v4_small={cfg.model.train_v4_small}: one train forward and "
                           f"backward of ({TRAIN_B}, {N}, 3), total_loss {terms['total']:.6f}, "
                           f"launches { {k: v for k, v in launches.items() if v} }")
        check_counts(launches, TRAIN_LAUNCHES[tier], 1, f"{tier} train step")
        bad = [k for k, v in terms.items() if not np.isfinite(v)]
        bad += [k for k, g in grads.items() if not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{tier}: non-finite {bad}")

# K16/K17 distances: max |kernel - plain| <= CHAMFER_REL * the largest plain
# distance or squared norm of a query point (|a|^2 + |b|^2 - 2 a.b rounds
# relative to the norms, and where the clouds coincide that is all there is)
CHAMFER_REL = 1e-5
ARGMIN_AGREE = 0.999  # K17: share of argmins equal to the plain version's
ARGMIN_GAP = 1e-6  # K17: where they differ, the exact distances at the two indices
HARNESS_BATCHES = 3  # the gated run
# the timed run: the harness leaves its first batch out of the time and
# fetches a batch after submitting the next, so over 3 batches it times the
# third and the tail of the second only
HARNESS_RATE_BATCHES = 20
N_LARGE = 2056  # the smallest padded N > 2048 at which the JAX package streams (K5)


def chamfer_clouds(rng, m: int, duplicates: bool = False):
    """Two (B, N, 3) / (B, m, 3) clouds; with ``duplicates`` b holds points of
    a, each twice or more (exact zero distances and ties)."""
    a = cloud(rng, N)
    if not duplicates:
        return a, (cloud(rng, m) + 0.05).contiguous()
    pick = torch.from_numpy(rng.integers(0, N // 2, (B, m))).to(DEVICE)
    return a, torch.gather(a, 1, pick[..., None].expand(B, m, 3)).contiguous()


def library_min_ms(a, b) -> float:
    """One PyTorch expression for a direction's minimum and argmin, timed."""
    return cuda_ms(lambda: torch.cdist(a, b).pow(2).min(-1))


def phase_chamfer() -> tuple[dict, dict]:
    """K16, K17 and K18 against their plain versions at the recon tier's
    shape (B, N) x (B, N), at (B, N) x (B, 700) and on a cloud with
    duplicated points: distances within CHAMFER_REL of the largest distance
    or query norm, argmins
    equal on >= ARGMIN_AGREE and within ARGMIN_GAP in exact distance where
    not, gradients within TOL_REL of the largest, K18 twice bit for bit.
    Records the recon shape's two directions per kernel, with the time of
    ``torch.cdist(a, b).pow(2).min(-1)`` as K16's and K17's library call.
    Then one autograd call of ``chamfer_distance``, K17's and K18's carrier
    (the harness runs K16 only): returns (records, its launches)."""
    from hspose_tpu_torch.ops import chamfer as ch

    phase = "chamfer"
    rng = np.random.default_rng(SEED + 7)
    rec = {}
    for label, m, dup in (("recon", N, False), ("uneven", 700, False), ("duplicates", N, True)):
        a, b = chamfer_clouds(rng, m, dup)
        mains = label == "recon"
        args = {}
        for x, y, what in ((a, b, "a->b"), (b, a, "b->a")):
            d16 = ch.chamfer_min_cuda(x, y)
            d17, i17 = ch.chamfer_min_argmin_cuda(x, y)
            want_d, want_i = ch.chamfer_min_argmin(x, y)
            torch.cuda.synchronize()
            scale = max(want_d.abs().max().item(), (x * x).sum(-1).max().item())
            errs = [(d - want_d).abs().max().item() for d in (d16, d17)]
            exact = ((x.double()[:, :, None] - y.double()[:, None]) ** 2).sum(-1)
            agree = (i17 == want_i).double().mean().item()
            at = [exact.gather(2, i.long()[..., None]) for i in (i17, want_i)]
            gap = (at[0] - at[1]).abs().max().item()
            log(phase, f"{label} ({B}, {x.shape[1]}) -> ({B}, {y.shape[1]}) {what}: K16 max abs "
                       f"err {errs[0]:.3e}, K17 {errs[1]:.3e} (bound {CHAMFER_REL * scale:.3e}); "
                       f"argmin agreement {agree:.6f}, largest exact-distance gap {gap:.3e}")
            if max(errs) > CHAMFER_REL * scale or agree < ARGMIN_AGREE or gap > ARGMIN_GAP:
                raise AssertionError(f"chamfer {label} {what}: errors {errs}, agreement {agree}, "
                                     f"gap {gap}")
            args[what] = (d17, i17)
            if mains:
                macs = B * x.shape[1] * y.shape[1] * 3  # the inner product of each pair
                lib = library_min_ms(x, y)
                record(rec, "chamfer_min", errs[0], cuda_ms(lambda: ch.chamfer_min_cuda(x, y)),
                       cuda_ms(lambda: ch.chamfer_min(x, y)),
                       bound([x, y, d16], macs, torch.float32))
                record(rec, "chamfer_min_argmin", errs[1],
                       cuda_ms(lambda: ch.chamfer_min_argmin_cuda(x, y)),
                       cuda_ms(lambda: ch.chamfer_min_argmin(x, y)),
                       bound([x, y, d17, i17], macs, torch.float32))
                for name, fn, outs in (("chamfer_min", ch.chamfer_min_cuda, [d16]),
                                       ("chamfer_min_argmin", ch.chamfer_min_argmin_cuda,
                                        [d17, i17])):
                    launch_parts(phase, rec[name], f"{name} {label} {what}",
                                 lambda: fn(x, y), {"search": bound([x, y, *outs], macs,
                                                                    torch.float32)},
                                 CHAMFER_PARTS[name])
                for name in ("chamfer_min", "chamfer_min_argmin"):
                    rec[name]["library_ms"] = (rec[name]["library_ms"] or 0.0) + lib
        ia, ib = args["a->b"][1], args["b->a"][1]
        gda, gdb = normal(rng, B, N), normal(rng, B, m)
        for x, y, ix, iy, gx, gy, what in ((a, b, ia, ib, gda, gdb, "ga"),
                                           (b, a, ib, ia, gdb, gda, "gb")):
            got = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            again = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            want = ch.chamfer_grad(x, y, ix, iy, gx, gy)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"chamfer_grad {label} {what}: two launches differ")
            ms = cuda_ms(lambda: ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)) if mains else 0.0
            pms = cuda_ms(lambda: ch.chamfer_grad(x, y, ix, iy, gx, gy)) if mains else 0.0
            bnd = compare_cotangents(phase, rec if mains else {}, "chamfer_grad",
                                     f"{label} {what} (twice, same bits)", [(what, got, want)],
                                     ms, pms, [x, y, ix, iy, gx, gy], 0)
            if mains:  # one launch a call: launch_parts raises on an inverse_index_kernel
                launch_parts(phase, rec["chamfer_grad"], f"chamfer_grad {label} {what}",
                             lambda: ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy), {"grad": bnd},
                             CHAMFER_PARTS["chamfer_grad"])

    # K18 where the lists are long, (4, 5000) x (4, 300), and where all 3000
    # points of b share one nearest point of a (far off the cloud): that
    # tile's list takes two windows
    for label, n, m, far in (("long lists", 5000, 300, False), ("one nearest point", N, 3000, True)):
        a = normal(rng, 4, n, 3, scale=0.2)
        b = (normal(rng, 4, m, 3, scale=0.01) + 5.0) if far else normal(rng, 4, m, 3, scale=0.2)
        ia, ib = ch.chamfer_min_argmin_cuda(a, b)[1], ch.chamfer_min_argmin_cuda(b, a)[1]
        if far and not bool((ib == ib[:, :1]).all()):
            raise AssertionError("chamfer_grad one nearest point: the points of b do not share one")
        gda, gdb = normal(rng, 4, n), normal(rng, 4, m)
        for x, y, ix, iy, gx, gy, what in ((a, b, ia, ib, gda, gdb, "ga"),
                                           (b, a, ib, ia, gdb, gda, "gb")):
            got = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            same_bits("chamfer_grad", f"{label} {what}", (got,),
                      (ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy),))
            compare_cotangents(phase, {}, "chamfer_grad", f"(4, {n}) x (4, {m}) {label} {what} "
                               "(twice, same bits)",
                               [(what, got, ch.chamfer_grad(x, y, ix, iy, gx, gy))], None, 0.0,
                               [], 0)

    # the differentiable call: K17 twice, then K18 once per cloud
    a, b = chamfer_clouds(rng, N)
    counts = counters()
    reset_counts(counts)
    a.requires_grad_(True)
    b.requires_grad_(True)
    da, db = ch.chamfer_distance(a, b)
    gda, gdb = normal(rng, B, N), normal(rng, B, N)
    torch.autograd.backward((da, db), (gda, gdb))
    torch.cuda.synchronize()
    launches = read_counts(counts)
    check_counts(launches, {"chamfer_min_argmin": 2, "chamfer_grad": 2}, 1, "autograd call")
    with torch.no_grad():
        _, ia = ch.chamfer_min_argmin(a, b)
        _, ib = ch.chamfer_min_argmin(b, a)
        want = ch.chamfer_grad(a.detach(), b.detach(), ia, ib, gda, gdb)
    err = (a.grad - want).abs().max().item()
    log(phase, f"autograd chamfer_distance ({B}, {N}) x ({B}, {N}): launches "
               f"{ {k: v for k, v in launches.items() if v} }, ga against the plain VJP {err:.3e} "
               f"(bound {TOL_REL * want.abs().max().item():.3e})")
    if not err <= TOL_REL * want.abs().max().item():
        raise AssertionError(f"autograd chamfer_distance: ga error {err}")
    return rec, launches


def harness_records(rng, n_pts: int, batches: int) -> list:
    """In-memory eval records: ``batches`` * B crops of n_pts points, four
    detections per image, with categories, symmetry, mean shapes and gt."""
    from hspose_tpu_torch.geometry.symmetry import CAT_NAMES, mean_shape_mm, sym_info

    records = []
    for _ in range(batches * B // 4):
        cat = rng.integers(0, 6, 4)
        gt_RTs = np.tile(np.eye(4), (4, 1, 1))
        gt_RTs[:, :3, :3] = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
        gt_RTs[:, :3, 3] = rng.normal(scale=0.1, size=(4, 3)) + [0.0, 0.0, 0.7]
        pcl = (rng.normal(scale=0.05, size=(4, n_pts, 3)) + gt_RTs[:, None, :3, 3])
        data = {"cat_id_0base": cat.astype(np.int32),
                "sym_info": np.stack([sym_info(CAT_NAMES[c]) for c in cat]).astype(np.float32),
                "mean_shape": np.stack([mean_shape_mm(CAT_NAMES[c]) for c in cat]) / 1000.0,
                "pcl_in": pcl.astype(np.float32)}
        det = {"pred_class_ids": cat + 1, "pred_scores": rng.uniform(0.5, 1.0, 4)}
        gts = {"gt_class_ids": cat + 1, "gt_RTs": gt_RTs,
               "gt_scales": rng.uniform(0.05, 0.3, (4, 3)), "gt_handle_visibility": np.ones(4)}
        records.append((data, det, gts))
    return records


def harness_config(dtype: str = "float32", recon: bool = False, n_pts: int = N):
    from hspose_tpu_torch.config import DataConfig, EvalConfig, HSPoseConfig, ModelConfig

    return HSPoseConfig(data=DataConfig(num_points=n_pts), model=ModelConfig(compute_dtype=dtype),
                        eval=EvalConfig(eval_batch=B, recon=recon))


def run_harness(cfg, model, records, seed: int):
    """``batched_pose_inference`` with every counter set to 0 just before:
    (pred_results, crops/s, launches)."""
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference

    counts = counters()
    reset_counts(counts)
    preds, rate = batched_pose_inference(cfg, model, copy.deepcopy(records), seed)
    torch.cuda.synchronize()
    return preds, rate, read_counts(counts)


def phase_harness(smi: str, rates: dict) -> dict:
    """The eval harness on in-memory records, HARNESS_BATCHES batches of
    (B, N): fp32, bf16, and fp32 with ``eval.recon`` on a model with the
    train heads (the same backbone and pose-head weights).  Gates: exact
    launch counts per batch (with recon, K16 twice and no K17/K18); the fp32
    poses bit for bit those of ``eval_forward`` + ``generate_RT`` on the same
    crops and pool samples, and the recon run's poses those of the fp32 run;
    chamfer and EMD finite and positive; then ``compute_degree_cm_mAP``.
    Prints the harness's crops/s over HARNESS_RATE_BATCHES batches beside
    the forward alone's (``rates``) and the recon tier's chamfer and EMD ms
    per batch.  Returns the recon
    run's launches."""
    from hspose_tpu_torch.evaluation.evaluate import report_lines
    from hspose_tpu_torch.evaluation.metrics import compute_degree_cm_mAP
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.geometry.symmetry import SYNSET_NAMES
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward
    from hspose_tpu_torch.ops.chamfer import chamfer_distance
    from hspose_tpu_torch.ops.emd import emd_distance

    phase, seed = "harness", SEED + 8
    records = harness_records(np.random.default_rng(SEED + 9), N, HARNESS_BATCHES)
    rate_records = harness_records(np.random.default_rng(SEED + 12), N, HARNESS_RATE_BATCHES)
    model = build_seeded_model(DEVICE)
    preds = {}
    for tier, dtype, recon in (("fp32", "float32", False), ("bf16", "bfloat16", False),
                               ("fp32 recon", "float32", True)):
        cfg = harness_config(dtype, recon)
        if recon:
            m = build_train_model(DEVICE, cfg.model).eval()
            missing = m.load_state_dict(model.state_dict(), strict=False).missing_keys
            if any(".".join(k.split(".")[:2]) not in ("face_recon.conv1d_block",
                                                      "face_recon.recon_head",
                                                      "face_recon.face_head") for k in missing):
                raise AssertionError(f"the recon model lacks backbone weights: {missing}")
        else:
            m = model if dtype == "float32" else build_seeded_model(DEVICE, dtype)
        run_harness(cfg, m, records, seed)  # warm: the first call of each tier builds caches
        preds[tier], _, launches = run_harness(cfg, m, records, seed)
        per_batch = dict(SERVE_LAUNCHES[dtype], **({"chamfer_min": 2} if recon else {}))
        log(phase, f"{tier}: {HARNESS_BATCHES} batches of ({B}, {N}, 3), launches "
                   f"{ {k: v for k, v in launches.items() if v} }")
        check_counts(launches, per_batch, HARNESS_BATCHES, f"{tier} harness batch")
        _, rate, _ = run_harness(cfg, m, rate_records, seed)
        log(phase, f"{tier}: {rate} crops/s over {HARNESS_RATE_BATCHES} batches of ({B}, {N}, 3) "
                   f"(forward alone {rates[dtype]:.1f} crops/s) on {smi}")
        if recon:
            recon_launches = launches

    def flat(results, key):
        return np.concatenate([r[key] for r in results])

    # the fp32 harness against the forward alone, on the same crops and samples
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    crops = np.concatenate([d["pcl_in"] for d, _, _ in records])
    obj = np.concatenate([d["cat_id_0base"] for d, _, _ in records])
    sym = np.concatenate([d["sym_info"] for d, _, _ in records])
    mean = np.concatenate([d["mean_shape"] for d, _, _ in records]).astype(np.float32)
    RTs, scales = [], []
    for i in range(HARNESS_BATCHES):
        rows = slice(i * B, (i + 1) * B)
        pc = torch.from_numpy(crops[rows]).to(DEVICE)
        out = eval_forward(model, pc, torch.from_numpy(obj[rows]).to(DEVICE),
                           pool_samples=draw_pool_samples(N, gen, DEVICE))
        RTs.append(generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                               out.pred_T, torch.from_numpy(sym[rows]).to(DEVICE)).cpu())
        scales.append((out.pred_s + torch.from_numpy(mean[rows]).to(DEVICE)).cpu())
    same = {"fp32 RT": np.array_equal(flat(preds["fp32"], "pred_RTs"), torch.cat(RTs).double()),
            "fp32 scales": np.array_equal(flat(preds["fp32"], "pred_scales"),
                                          torch.cat(scales).double()),
            "recon RT": np.array_equal(flat(preds["fp32 recon"], "pred_RTs"),
                                       flat(preds["fp32"], "pred_RTs"))}
    dev = np.abs(flat(preds["bf16"], "pred_RTs") - flat(preds["fp32"], "pred_RTs")).max()
    cmf = flat(preds["fp32 recon"], "chamfer_dis_cass")
    emd = flat(preds["fp32 recon"], "emd_dis_cass")
    log(phase, f"bit for bit against eval_forward + generate_RT: {same}; bf16 against fp32 "
               f"poses max abs {dev:.3e}; chamfer {cmf.min():.4e} .. {cmf.max():.4e}, EMD "
               f"{emd.min():.4e} .. {emd.max():.4e}")
    if not all(same.values()):
        raise AssertionError(f"the harness's poses are not the forward's: {same}")
    if not (np.isfinite(cmf).all() and np.isfinite(emd).all() and (cmf > 0).all()
            and (emd > 0).all()):
        raise AssertionError("chamfer or EMD not finite and positive")

    grids = (list(range(0, 61)), [i / 2 for i in range(21)], [i / 100 for i in range(101)])
    iou_aps, pose_aps = compute_degree_cm_mAP(preds["fp32"], SYNSET_NAMES, None, *grids,
                                              iou_pose_thres=0.1, use_matches_for_pose=True,
                                              plot_figure=False)
    log(phase, "fp32 mean table (random weights): " + "; ".join(
        report_lines(iou_aps, pose_aps, grids[0] + [360], grids[1] + [100], grids[2])[1:]))

    # the recon tier's cost per batch, on the recon model's cloud for batch 0
    m = build_train_model(DEVICE, harness_config(recon=True).model).eval()
    pc = torch.from_numpy(crops[:B]).to(DEVICE)
    out = eval_forward(m, pc, torch.from_numpy(obj[:B]).to(DEVICE),
                       generator=torch.Generator(device=DEVICE).manual_seed(seed), with_heads=True)
    recon = out.recon.float()
    cfg = harness_config(recon=True)
    with torch.no_grad():
        cmf_ms = cuda_ms(lambda: chamfer_distance(recon, pc))
        emd_ms = cuda_ms(lambda: emd_distance(recon, pc, cfg.eval.emd_epsilon, cfg.eval.emd_iters),
                         iters=5, warmup=1)
    log(phase, f"recon tier per batch of ({B}, {N}): chamfer {cmf_ms:.4f} ms (K16 twice), "
               f"Sinkhorn EMD {emd_ms:.3f} ms ({cfg.eval.emd_iters} sweeps) on {smi}")
    return recon_launches


def phase_k5(smi: str) -> tuple[dict, dict]:
    """K5, the JAX package's streamed KNN above padded N = 2048, covered by
    the exact kernel: the three full-N searches of a forward (xyz k=20,
    features k=20, xyz k=4) at N = 2056 and 4096 against the plain version,
    and the feature search on bf16 points, which the wrapper widens to
    fp32; then one fp32 harness batch at ``data.num_points=2056`` with its
    exact launch counts.  Records the N = 2056 forward's three searches;
    returns (records, the batch's launches)."""
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices

    phase = "k5"
    rng = np.random.default_rng(SEED + 10)
    rec = {}
    for n in (N_LARGE, 4096):
        for d, k, dtype in ((3, 20, torch.float32), (128, 20, torch.float32), (3, 4, torch.float32),
                            (128, 20, torch.bfloat16)):
            pts = cloud(rng, n) if d == 3 else normal(rng, B, n, d).to(dtype)
            got = knn_indices_cuda(pts, k, packed=dtype == torch.bfloat16)
            want = knn_indices(pts.float(), k)
            torch.cuda.synchronize()
            agree = (got[..., :, None] == want[..., None, :]).any(-1).double().mean().item()
            p64 = pts.double()

            def sorted_d(idx):
                diff = gather_neighbors(p64, idx) - p64[:, :, None]
                return (diff * diff).sum(-1).sort(-1).values

            dg, dw = sorted_d(got), sorted_d(want)
            err = (dg - dw).abs().max().item()
            rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
            ms = cuda_ms(lambda: knn_indices_cuda(pts, k, packed=dtype == torch.bfloat16), iters=5)
            pms = cuda_ms(lambda: knn_indices(pts.float(), k), iters=3, warmup=1)
            log(phase, f"exact KNN N={n} D={d} {dtype} k={k}: agreement {agree:.6f}, max rel "
                       f"distance gap {rel:.3e}, {ms:.4f} ms (plain {pms:.4f} ms) on {smi}")
            if agree < KNN_AGREE or rel > KNN_TIE_REL:
                raise AssertionError(f"exact KNN N={n} D={d} k={k}: agreement {agree}, gap {rel}")
            if n == N_LARGE and dtype == torch.float32:
                record(rec, "knn_streamed", err, ms, pms,
                       bound([pts, got], B * n * n * d, torch.float32))

    cfg = harness_config(n_pts=N_LARGE)
    records = harness_records(np.random.default_rng(SEED + 11), N_LARGE, 1)
    model = build_seeded_model(DEVICE)
    run_harness(cfg, model, records, SEED)  # warm
    preds, _, launches = run_harness(cfg, model, records, SEED)
    log(phase, f"one fp32 harness batch of ({B}, {N_LARGE}, 3): launches "
               f"{ {k: v for k, v in launches.items() if v} }")
    check_counts(launches, {"knn": 6, "knn_streamed": 3, "hs_surface": 1, "hs_support": 4,
                            "orl_global": 5}, 1, f"N={N_LARGE} harness batch")
    RT = np.concatenate([r["pred_RTs"] for r in preds])
    if not np.isfinite(RT).all():
        raise AssertionError(f"N={N_LARGE}: poses not finite")
    return rec, launches


# K4's calls off the B=24, N=1028 forward, (B, N, C, K): the N = 2056 harness
# forward's five ORL branches (64-byte rows, the neighbour lists read through
# L1 at N = 2056), 16-byte rows with the lists staged (B=4, N=2056) and read
# through L1 (N=5000, K=8), and a K read at run time
ORL_SHAPES = [(B, N_LARGE, 128, 20), (B, N_LARGE, 128, 20), (B, N_LARGE // 4, 256, 20),
              (B, N_LARGE // 4, 256, 20), (B, N_LARGE // 16, 512, 8), (4, N_LARGE, 128, 20),
              (2, 5000, 64, 8), (3, 33, 256, 5)]
# K10's calls off the v4 step, (B, N, C, K): idx staged and one block of rows
# (N = 1028), idx read through L1 and the rows split over blocks (N = 2056,
# 20000), idx staged and the rows split (N = 5000, with a part-full channel
# slice), a C that is not a multiple of 4 (4-byte loads), and N*K odd (idx
# copied 4 bytes at a time)
K10_SHAPES = [(2, N, 128, 20), (2, N_LARGE, 64, 20), (2, 5000, 48, 5), (3, 257, 50, 20),
              (2, 20000, 32, 8), (3, 33, 36, 7)]
# K2's calls off the forward, (B, N, K, S, Co): S and K read at run time (the
# supports held eight at a time), and Co below 128 (queries side by side)
SURFACE_SHAPES = [(4, 300, 12, 10, 64), (3, 200, 20, 3, 96), (2, N, 20, 9, 128),
                  (2, 130, 7, 7, 40), (2, 100, 20, 7, 40)]


def phase_k2k4_shapes() -> None:
    """K2 and K4 at shapes off the B=24, N=1028 forward, so that each branch
    of their launches runs on the card (ORL_SHAPES, SURFACE_SHAPES, and one
    ORL call on an index tensor 4 bytes off 16-byte alignment), in fp32 and
    bf16: each serving call against its plain version within TOL_REL of
    the largest value, the forward with winners bit for bit the serving
    kernel's, its winners against the plain version's as in phase 8; K10
    at K10_SHAPES in both tiers against its plain version (phase 12's
    gates) and twice with the same bits; and features off 16-byte
    alignment must be refused."""
    from hspose_tpu_torch.ops import cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    phase = "k2k4-shapes"
    rng = np.random.default_rng(SEED + 12)

    def close(name, label, got, want):
        torch.cuda.synchronize()
        scale, err = want.abs().max().item(), (got - want).abs().max().item()
        log(phase, f"{name} {label}: max abs err {err:.3e} (bound {TOL_REL * scale:.3e})")
        if not (err <= TOL_REL * scale and got.dtype == torch.float32):
            raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}")

    def at_win(x, win):  # x (B, N, K, C) at each column's winner
        return x.gather(2, win.long()[:, :, None]).squeeze(2)

    def off16(t):  # a contiguous copy of t 4 bytes off 16-byte alignment
        buf = torch.empty(t.numel() * t.element_size() + 4, dtype=torch.uint8, device=t.device)
        out = buf[4:].view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    orl_cases = [(shape, False) for shape in ORL_SHAPES] + [((2, 300, 128, 20), True)]
    for (b, n, c, k), unaligned in orl_cases:
        idx = knn_indices_cuda(cloud_b(rng, b, n), k)
        if unaligned:
            idx = off16(idx)
        for fast in (False, True):
            feat = normal(rng, b, n, c).to(torch.bfloat16 if fast else torch.float32)
            label = (f"B={b} N={n} C={c} K={k} {feat.dtype}"
                     + (" idx off 16-byte alignment" if unaligned else ""))
            got = f.orl_global_fused(feat, idx)
            close("orl_global", label, got, f.orl_global_plain(feat, idx))
            (out_k, win_k), (_, win_p) = (f.orl_global_fused_fwd(feat, idx),
                                          f.orl_global_fused_fwd_plain(feat, idx))
            same_bits("orl_global_fused_fwd", label + " (against the serving kernel)",
                      (out_k,), (got,))
            rows = gather_neighbors(feat, idx).float()
            check_winners(phase, "orl_global_fused_fwd", label, win_k, win_p,
                          at_win(rows, win_k), at_win(rows, win_p))
            del rows

    for b, n, k, S, co in SURFACE_SHAPES:
        verts = cloud_b(rng, b, n)
        idx = knn_indices_cuda(verts, k)
        dirs = unit_dirs(rng, S * co)
        for exact in (True, False):
            label = f"B={b} N={n} K={k} S={S} Co={co} exact={exact}"
            args = (verts, idx, dirs, S, co)
            got = f.hs_surface_fused(*args, exact=exact)
            close("hs_surface", label, got, f.hs_surface_plain(*args, exact=exact))
            (out_k, win_k), (_, win_p) = (f.hs_surface_fused_fwd(*args, exact=exact),
                                          f.hs_surface_fused_fwd_plain(*args, exact=exact))
            same_bits("hs_surface_fused_fwd", label + " (against the serving kernel)",
                      (out_k,), (got,))
            if exact:
                theta = torch.relu(neighbor_directions_normalized(verts, idx) @ dirs)
            else:
                theta = f._theta_fast(f._rf_fast(verts, idx), f._bf16(dirs))
            check_winners(phase, "hs_surface_fused_fwd", label, win_k, win_p,
                          at_win(theta, win_k), at_win(theta, win_p))

    # K10 on neighbour lists that name rows twice and on random winners, so
    # that every branch of its launch plan runs
    for b, n, c, k in K10_SHAPES:
        idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32)).to(DEVICE)
        idx[:, :, k // 2] = idx[:, :, 0]
        win = torch.from_numpy(rng.integers(0, k, (b, n, c)).astype(np.int32)).to(DEVICE)
        gb = normal(rng, b, 1, c)
        for dtype in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} C={c} K={k} {dtype}"
            got = f.orl_global_fused_bwd(idx, win, gb, dtype)
            same_bits("orl_global_fused_bwd", label + " (twice)", (got,),
                      (f.orl_global_fused_bwd(idx, win, gb, dtype),))
            compare_cotangents(phase, {}, "orl_global_fused_bwd", label,
                               [("dfeat", got, f.orl_global_fused_bwd_plain(idx, win, gb, dtype))],
                               None, 0.0, [], 0)

    feat = off16(normal(rng, 2, 300, 128))
    try:
        f.orl_global_fused(feat, knn_indices_cuda(cloud_b(rng, 2, 300), 20))
    except RuntimeError as err:
        log(phase, f"orl_global on features off 16-byte alignment: refused ({err})")
    else:
        raise AssertionError("orl_global took features off 16-byte alignment")


# K13's and K14's calls off the step, (K, Cin, Co, S): K under each template
# width (8, 20, 32), Cin beyond one 128-channel block, S*Co in column tiles
# of 192, 256 and 256; at B=3, N=1001 the rows are a multiple of no tile
SUPPORT_BWD_SHAPES = [(5, 132, 128, 3), (31, 128, 512, 7), (20, 256, 256, 9)]
# K12's and K15's calls off the step, (K, S, Co): K and S read at run time
# (S = 9, 10: the supports held eight at a time), other widths, and at B=3,
# N=1001 a part-full last block and tile
SURFACE_TRAIN_SHAPES = [(5, 3, 64), (31, 9, 128), (12, 10, 96)]


def phase_k13k14_shapes() -> None:
    """K13 and K14 at shapes off the B=16 step (SUPPORT_BWD_SHAPES, B=3,
    N=1001), in fp32 and bf16, so that each branch of their launches runs on
    the card: K13 against its plain version at phase 8's gates (phase 10's in
    bf16), K14 bit for bit K13 on the forward's stored values, each launched
    twice with the same bits; and K12 and K15 at SURFACE_TRAIN_SHAPES, B=3,
    N=1001, against their plain versions with the same gates, each twice
    with the same bits."""
    from hspose_tpu_torch.ops import cuda_hs
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices, neighbor_directions_normalized

    phase = "k13k14-shapes"
    rng = np.random.default_rng(SEED + 13)
    b, n = 3, 1001
    for k, cin, co, S in SUPPORT_BWD_SHAPES:
        for op in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} K={k} Cin={cin} Co={co} S={S} {op}"
            feat = torch.relu(normal(rng, b, n, cin))
            idx = knn_indices(feat, k)
            src = {"feat": feat.to(op), "idx": idx}
            g = gather_neighbors(src["feat"], idx)
            rf = neighbor_directions_normalized(cloud_b(rng, b, n).to(op), idx)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w = normal(rng, cin, (S + 1) * co, scale=stdv)
            bias = normal(rng, (S + 1) * co, scale=stdv)
            dirs = unit_dirs(rng, S * co).to(op)
            fargs = (g, rf, w[:, co:], bias[co:], dirs, S, co)
            out, win, tw, pw = cuda_hs.hs_support_fwd(*fargs, **src)
            same_bits("hs_support_fwd", label, (out, win, tw, pw),
                      cuda_hs.hs_support_fwd(*fargs, **src))
            same_bits("hs_support_fwd_novals", label + " (against the stored launch)",
                      (out, win), cuda_hs.hs_support_fwd(*fargs, store=False, **src))
            out_p, win_p, tw_p, pw_p = cuda_hs.hs_support_fwd_plain(*fargs)
            check_winners(phase, "hs_support_fwd", label, win, win_p, tw * pw, tw_p * pw_p)
            agree = win == win_p
            compare_cotangents(phase, {}, "hs_support_fwd", label,
                               [("out", out, out_p), ("twin", tw * agree, tw_p * agree),
                                ("pwin", pw * agree, pw_p * agree)], None, 0.0, [], 0)
            gb = normal(rng, b, n, co)
            bargs = (g, rf, w[:, co:], dirs, win, tw, pw, gb, S, co)
            got = cuda_hs.hs_support_bwd(*bargs)
            same_bits("hs_support_bwd", label, got, cuda_hs.hs_support_bwd(*bargs))
            compare_cotangents(phase, {}, "hs_support_bwd", label,
                               list(zip(("dg", "drf", "dw", "db", "dd"), got,
                                        cuda_hs.hs_support_bwd_plain(*bargs))), None, 0.0, [], 0)
            rargs = (g, rf, w[:, co:], bias[co:], dirs, win, gb, S, co)
            k14 = cuda_hs.hs_support_bwd_recompute(*rargs)
            same_bits("hs_support_bwd_recompute", label, k14,
                      cuda_hs.hs_support_bwd_recompute(*rargs))
            same_bits("hs_support_bwd_recompute", label + " (against K13)", k14, got)
            log(phase, f"hs_support_bwd_recompute {label}: K13's bits, twice")
    for k, S, co in SURFACE_TRAIN_SHAPES:
        verts = cloud_b(rng, b, n)
        idx = knn_indices(verts, k)
        for op in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} K={k} S={S} Co={co} {op}"
            rf = neighbor_directions_normalized(verts.to(op), idx)
            dirs = unit_dirs(rng, S * co).to(op)
            out, win = cuda_hs.hs_surface_fwd(rf, dirs, S, co)
            same_bits("hs_surface_fwd", label, (out, win), cuda_hs.hs_surface_fwd(rf, dirs, S, co))
            out_p, win_p = cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co)
            theta = torch.relu(rf.double() @ dirs.double())
            at = [theta.gather(2, w.long()[:, :, None]).squeeze(2) for w in (win, win_p)]
            check_winners(phase, "hs_surface_fwd", label, win, win_p, *at)
            del theta, at
            compare_cotangents(phase, {}, "hs_surface_fwd", label, [("out", out, out_p)], None,
                               0.0, [], 0)
            gb = normal(rng, b, n, co)
            gb[:, ::7] = 0.0  # rows whose every column routes nothing
            args = (rf, dirs, win, gb, S, co)
            got = cuda_hs.hs_surface_bwd(*args)
            same_bits("hs_surface_bwd", label, got, cuda_hs.hs_surface_bwd(*args))
            compare_cotangents(phase, {}, "hs_surface_bwd", label,
                               list(zip(("drf", "dd"), got, cuda_hs.hs_surface_bwd_plain(*args))),
                               None, 0.0, [], 0)
            log(phase, f"hs_surface_fwd, hs_surface_bwd {label}: twice the same bits")


# kernel -> (source, the TPU kernel it replaces, the record and counter it
# shares, when another kernel of the line ports the same function)
SOURCES = {
    "knn": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:163", None),
    # K6, the lane-major layout of the same exact search (no caller passes tmaj=False)
    "knn_lane_major": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:64",
                       "knn"),
    "hs_surface": ("hspose_tpu_torch/csrc/hs_surface.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:299", None),
    "hs_support": ("hspose_tpu_torch/csrc/hs_support.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:219", None),
    "orl_global": ("hspose_tpu_torch/csrc/orl.cu", "hspose_tpu/ops/pallas_hs_fused.py:358",
                   None),
    # the bf16 tier: K1's packed-key branch, and the exact=False branches of
    # K2-K4, the same sources instantiated for bf16
    "knn_packed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:213", None),
    # K7, the lane-major layout of the same packed-key search
    "knn_packed_lane_major": ("hspose_tpu_torch/csrc/knn.cu",
                              "hspose_tpu/ops/pallas_knn.py:91", "knn_packed"),
    "hs_surface_bf16": ("hspose_tpu_torch/csrc/hs_surface.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:299", None),
    "hs_support_bf16": ("hspose_tpu_torch/csrc/hs_support.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:219", None),
    "orl_global_bf16": ("hspose_tpu_torch/csrc/orl.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:358", None),
    # training: K11, K12, K13, K15, fp32 (exact=True) and bf16 (exact=False)
    **{name + tag: (src, rep, None)
       for tag in ("", "_bf16")
       for name, src, rep in [
           ("hs_support_fwd", "hspose_tpu_torch/csrc/hs_support_train.cu",
            "hspose_tpu/ops/pallas_hs.py:151"),
           ("hs_surface_fwd", "hspose_tpu_torch/csrc/hs_surface_train.cu",
            "hspose_tpu/ops/pallas_hs.py:215"),
           ("hs_support_bwd", "hspose_tpu_torch/csrc/hs_support_train.cu",
            "hspose_tpu/ops/pallas_hs.py:336"),
           ("hs_surface_bwd", "hspose_tpu_torch/csrc/hs_surface_train.cu",
            "hspose_tpu/ops/pallas_hs.py:410")]},
    # bwd_store=False: K11 without winner values, K14 (fp32)
    "hs_support_fwd_novals": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                              "hspose_tpu/ops/pallas_hs.py:151", None),
    "hs_support_bwd_recompute": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                 "hspose_tpu/ops/pallas_hs.py:240", None),
    # the fused ops' VJPs (fp32): K2-K4 with want_win, K9, K8, K10
    **{name: (src, "hspose_tpu/ops/pallas_hs_fused.py:" + line, None)
       for name, src, line in [
           ("hs_surface_fused_fwd", "hspose_tpu_torch/csrc/hs_surface.cu", "299"),
           ("hs_surface_fused_bwd", "hspose_tpu_torch/csrc/hs_surface.cu", "493"),
           ("hs_support_fused_fwd", "hspose_tpu_torch/csrc/hs_support.cu", "219"),
           ("hs_support_fused_bwd", "hspose_tpu_torch/csrc/hs_support.cu", "420"),
           ("orl_global_fused_fwd", "hspose_tpu_torch/csrc/orl.cu", "358"),
           ("orl_global_fused_bwd", "hspose_tpu_torch/csrc/orl.cu", "544")]},
    # bf16 training under the flags (exact=False): K11 without winner values,
    # K14, and the fused ops' K2-K4 with want_win, K9, K8, K10
    "hs_support_fwd_novals_bf16": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                   "hspose_tpu/ops/pallas_hs.py:151", None),
    "hs_support_bwd_recompute_bf16": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                      "hspose_tpu/ops/pallas_hs.py:240", None),
    **{name + "_bf16": (src, "hspose_tpu/ops/pallas_hs_fused.py:" + line, None)
       for name, src, line in [
           ("hs_surface_fused_fwd", "hspose_tpu_torch/csrc/hs_surface.cu", "299"),
           ("hs_surface_fused_bwd", "hspose_tpu_torch/csrc/hs_surface.cu", "493"),
           ("hs_support_fused_fwd", "hspose_tpu_torch/csrc/hs_support.cu", "219"),
           ("hs_support_fused_bwd", "hspose_tpu_torch/csrc/hs_support.cu", "420"),
           ("orl_global_fused_fwd", "hspose_tpu_torch/csrc/orl.cu", "358"),
           ("orl_global_fused_bwd", "hspose_tpu_torch/csrc/orl.cu", "544")]},
    # the recon tier: K16, K17, K18
    "chamfer_min": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:85", None),
    "chamfer_min_argmin": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:167",
                           None),
    "chamfer_grad": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:216", None),
    # K5, the streamed search above padded N = 2048: the exact kernel
    "knn_streamed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:119", None),
}


def kernel_line(rec: dict, launches: dict) -> dict:
    """The ``kernels`` JSON object: every kernel of SOURCES with its
    launches on the main path and its measured numbers."""
    kernels = []
    for name, (src, rep, shares) in SOURCES.items():
        if not launches[shares or name] > 0:
            raise AssertionError(f"{name}: no launch in the main run of its path")
        r = {k: v for k, v in rec[shares or name].items() if not k.startswith("_")}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[shares or name], **r})
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    rec = phase_kernels()
    launches, fp32_results = phase_slice()
    fp32_rate = phase_throughput(smi)
    rec.update(phase_kernels("bfloat16"))
    bf16_launches, _ = phase_slice("bfloat16", fp32_results)
    launches.update({name: bf16_launches[name] for name in SERVE_LAUNCHES["bfloat16"]})
    bf16_rate = phase_throughput(smi, "bfloat16")
    log("throughput", f"bf16 / fp32 at B={B}: {bf16_rate:.1f} / {fp32_rate:.1f} crops/s "
                      f"= {bf16_rate / fp32_rate:.3f}")
    rates = {}
    for dtype in ("float32", "bfloat16"):
        rec.update(phase_train_kernels(dtype))
        train_launches, rates[dtype] = phase_train(smi, dtype)
        launches.update({name: train_launches[name] for name in TRAIN_LAUNCHES[dtype]})
    log("train", f"bf16 / fp32 at B={TRAIN_B}: {rates['bfloat16']:.3f} / {rates['float32']:.3f} "
                 f"steps/s = {rates['bfloat16'] / rates['float32']:.3f}")
    for dtype, tier, default in (("float32", "v4", "float32"), ("bfloat16", "bf16v4", "bfloat16")):
        v4_rec, carrier = phase_v4_kernels(dtype)
        rec.update(v4_rec)
        train_launches, rates[tier] = phase_train(smi, tier)
        launches.update({name: train_launches[name] for name in TRAIN_LAUNCHES[tier]})
        # K2 with winners and K9 run on no model path: their launches are the carrier's
        tag = "_bf16" if dtype == "bfloat16" else ""
        launches.update({name + tag: carrier[name + tag]
                         for name in ("hs_surface_fused_fwd", "hs_surface_fused_bwd")})
        log(tier + "-train", f"bwd_store=False train_v4_small=True / default {dtype} at "
                             f"B={TRAIN_B}: {rates[tier]:.3f} / {rates[default]:.3f} steps/s = "
                             f"{rates[tier] / rates[default]:.3f}")
    phase_train_flags()
    chamfer_rec, carrier = phase_chamfer()
    rec.update(chamfer_rec)
    # K17 and K18 run on no harness path: their launches are the autograd call's
    launches.update({name: carrier[name] for name in ("chamfer_min_argmin", "chamfer_grad")})
    launches["chamfer_min"] = phase_harness(smi, {"float32": fp32_rate,
                                                  "bfloat16": bf16_rate})["chamfer_min"]
    k5_rec, k5_launches = phase_k5(smi)
    rec.update(k5_rec)
    launches["knn_streamed"] = k5_launches["knn_streamed"]
    phase_k2k4_shapes()
    phase_k13k14_shapes()
    for dtype in ("float32", "bfloat16"):
        phase_slice(dtype, serve_k=SERVE_K_RELAXED)
    print(json.dumps(kernel_line(rec, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
