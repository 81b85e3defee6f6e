"""The fp32 tier's outputs and kernel times, for holding two trees of the
port to the same bits on one CUDA card.

    python hspose_tpu_torch/tools/fp32_bits.py --tree DIR --out FILE.pt
    python hspose_tpu_torch/tools/fp32_bits.py --compare A.pt B.pt [C.pt ...]

The first form imports ``hspose_tpu_torch`` from DIR (a checkout, such as a
``git archive`` of another commit) and saves, from seeded inputs:

* the output of every fp32 kernel at each shape of the B=24, N=1028 serving
  forward (KNN, surface, support, ORL) and of the B=16 train step (K12, K15,
  K11, K13; K11 without winner values and K14; the fused ops' forwards with
  winners and their backwards K9, K8, K10 at conv_0's and conv_2..conv_4's
  shapes), with each kernel's device time (CUDA events, mean of 20 launches
  after 3, enqueued behind a sleep kernel, summed over the calls of one
  pass; the ORL kernel, K13 and K14 also per layer);
* the bf16 tier's surface and ORL outputs at the B=24 forward's shapes and
  their forwards with winners at the B=16 step's, its K13 and K14 (with the
  K11 forwards that feed them) at the B=16 step's four HS layers, and its
  K3 with winners and K8 at conv_2..conv_4's, and its K12 (out, win) and
  K15 (drf, dd) and K9 (dverts, dd) at the B=16 step's conv_0, and its K10
  at conv_2..conv_4's ORL branches, with their times (the ORL kernel, K13, K14 and K10 per
  layer): their sums are fp32 (K8's rows fp64) in a fixed order, or integer
  counts (K10), so they keep their bits too;
* the chamfer kernels' outputs, K16 (dist), K17 (dist, argmin) and K18
  (the gradient of each cloud), at the recon tier's shape (24, 1028) x (24,
  1028), with their times per pass of both directions, and on a cloud whose
  points repeat the other's (exact zeros and ties);
* the fp32 serving forward's pose outputs at B=24, N=1028;
* the total loss of three fp32 train steps at B=16, N=1028;

and times what it does not hold to bits: the bf16 tier's KNN (packed keys)
and support kernels at the B=24 bf16 forward's shapes, and the serving
crops/s of both tiers at B=24 (as ``chip_smoke.py`` phase 5: best of 3
windows of 20 forwards after 3 warm-up).

K11 is called with each tree's own signature (from the source-row design
on, the kernel also takes the rows g gathers, feat and idx), on g =
feat[idx], so that every tree sees the same values.

The second form says, for every saved output, whether all the files hold
the same bits, and prints the kernel times and the crops/s side by side.
Run the trees in turns in one call (parent, change, change, parent) so that
run-to-run spread shows beside any difference.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


# clock cycles of the sleep kernel that holds the stream while _timed enqueues
# its calls (about 10 ms on an H100), as chip_smoke.py::cuda_ms
QUEUE_CYCLES = 20_000_000


def _timed(times: dict, name: str, fn, iters: int = 20, warmup: int = 3, part: str = ""):
    """``fn()``, with its mean device time added to times[name] and, when
    ``part`` is given, to times[name + " " + part] too.  The calls are
    enqueued behind a sleep kernel, so that a kernel shorter than its
    wrapper's host time is timed back to back on the device."""
    import torch

    out = fn()
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
    for key in (name, f"{name} {part}") if part else (name,):
        times[key] = times.get(key, 0.0) + start.elapsed_time(end) / iters
    return out


def _crops_per_s(serve, batch: int, iters: int = 20) -> tuple[float, list]:
    """Best of 3 windows of ``iters`` calls of ``serve`` (host clock around
    work that ends in a synchronize), after 3 warm-up calls."""
    import time

    import torch

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            serve()
        torch.cuda.synchronize()
        rates.append(batch * iters / (time.perf_counter() - t0))
    return max(rates), rates


def _k11(cuda_hs, g, feat, idx):
    """This tree's K11 on g = feat[idx], as ``fn(rf, w, b, d, S, co, store=...)``."""
    import inspect

    if "feat" in inspect.signature(cuda_hs.hs_support_fwd).parameters:
        return lambda *a, **kw: cuda_hs.hs_support_fwd(g, *a, feat=feat, idx=idx, **kw)
    return lambda *a, **kw: cuda_hs.hs_support_fwd(g, *a, **kw)


def collect(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import hspose_tpu_torch
    from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import build_model, draw_pool_samples, eval_forward
    from hspose_tpu_torch.ops import chamfer as ch, cuda_hs, cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    where = Path(hspose_tpu_torch.__file__).resolve()
    if Path(tree).resolve() not in where.parents:
        raise RuntimeError(f"imported {where}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, S, N = "cuda", 7, 1028
    rng = np.random.default_rng(0)
    out, times = {}, {}

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def unit(n):
        d = normal(3, n)
        return d / d.norm(dim=0, keepdim=True)

    with torch.no_grad():
        # serving kernels, B=24
        B = 24
        clouds = {n: normal(B, n, 3, scale=0.2) for n in (N, N // 4, N // 16)}
        for n, d, k in [(N, 3, 20), (N, 128, 20), (N, 3, 4), (N // 4, 3, 20), (N // 4, 128, 20),
                        (N // 4, 256, 20), (N // 4, 3, 4), (N // 16, 3, 8), (N // 16, 256, 8)]:
            pts = clouds[n] if d == 3 else normal(B, n, d)
            out[f"knn {n} {d} {k}"] = _timed(times, "knn", lambda: knn_indices_cuda(pts, k))
        idx = knn_indices_cuda(clouds[N], 20)
        dirs = unit(S * 128)
        out["hs_surface"] = _timed(times, "hs_surface",
                                   lambda: f.hs_surface_fused(clouds[N], idx, dirs, S, 128))
        for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                     (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            args = (normal(B, n, cin), clouds[n], knn_indices_cuda(clouds[n], k), w[:, co:],
                    b[co:], unit(S * co), S, co)
            out[f"hs_support conv_{layer}"] = _timed(times, "hs_support",
                                                     lambda: f.hs_support_fused(*args))
        for layer, c, n, k in [(0, 128, N, 20), (1, 128, N, 20), (2, 256, N // 4, 20),
                               (3, 256, N // 4, 20), (4, 512, N // 16, 8)]:
            feat, oidx = normal(B, n, c), knn_indices_cuda(clouds[n], k)
            out[f"orl_global conv_{layer}"] = _timed(times, "orl_global",
                                                     lambda: f.orl_global_fused(feat, oidx),
                                                     part=f"conv_{layer}")

        # training kernels, B=16, on the forwards' own residuals
        B = 16
        verts = normal(B, N, 3, scale=0.2)
        rf = neighbor_directions_normalized(verts, knn_indices_cuda(verts, 20))
        dirs = unit(S * 128)
        o, win = _timed(times, "hs_surface_fwd", lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, 128))
        gb = normal(B, N, 128)
        out["hs_surface_fwd"] = (o, win)
        out["hs_surface_bwd"] = _timed(times, "hs_surface_bwd",
                                       lambda: cuda_hs.hs_surface_bwd(rf, dirs, win, gb, S, 128))
        for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                     (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
            feat = torch.relu(normal(B, n, cin))
            kidx = knn_indices_cuda(feat, k)
            g = gather_neighbors(feat, kidx)
            rf = neighbor_directions_normalized(normal(B, n, 3, scale=0.2), kidx)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            d = unit(S * co)
            k11 = _k11(cuda_hs, g, feat, kidx)
            fwd = _timed(times, "hs_support_fwd", lambda: k11(rf, w[:, co:], b[co:], d, S, co),
                         part=f"conv_{layer}")
            gb = normal(B, n, co)
            bargs = (g, rf, w[:, co:], d, *fwd[1:], gb, S, co)
            out[f"hs_support_fwd conv_{layer}"] = fwd
            out[f"hs_support_bwd conv_{layer}"] = _timed(
                times, "hs_support_bwd", lambda: cuda_hs.hs_support_bwd(*bargs),
                part=f"conv_{layer}")
            # bwd_store=False: K11 without winner values, K14 on its winners
            novals = _timed(times, "hs_support_fwd_novals",
                            lambda: k11(rf, w[:, co:], b[co:], d, S, co, store=False),
                            part=f"conv_{layer}")
            out[f"hs_support_fwd_novals conv_{layer}"] = novals
            out[f"hs_support_bwd_recompute conv_{layer}"] = _timed(
                times, "hs_support_bwd_recompute", lambda: cuda_hs.hs_support_bwd_recompute(
                    g, rf, w[:, co:], b[co:], d, novals[1], gb, S, co), part=f"conv_{layer}")

        # train_v4_small: the fused ops' forwards with winners and backwards K9, K8, K10
        verts = normal(B, N, 3, scale=0.2)
        vidx, dirs, gb = knn_indices_cuda(verts, 20), unit(S * 128), normal(B, N, 128)
        o, win = _timed(times, "hs_surface_fused_fwd",
                        lambda: f.hs_surface_fused_fwd(verts, vidx, dirs, S, 128))
        out["hs_surface_fused_fwd"] = (o, win)
        out["hs_surface_fused_bwd"] = _timed(
            times, "hs_surface_fused_bwd",
            lambda: f.hs_surface_fused_bwd(verts, vidx, dirs, win, gb, S, 128))
        for layer, cin, co, n, k in [(2, 128, 256, N // 4, 20), (3, 256, 256, N // 4, 20),
                                     (4, 256, 512, N // 16, 8)]:
            feat, verts = torch.relu(normal(B, n, cin)), normal(B, n, 3, scale=0.2)
            kidx = knn_indices_cuda(feat, k)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            d, gb = unit(S * co), normal(B, n, co)
            fwd = _timed(times, "hs_support_fused_fwd", lambda: f.hs_support_fused_fwd(
                feat, verts, kidx, w[:, co:], b[co:], d, S, co))
            out[f"hs_support_fused_fwd conv_{layer}"] = fwd
            out[f"hs_support_fused_bwd conv_{layer}"] = _timed(
                times, "hs_support_fused_bwd", lambda: f.hs_support_fused_bwd(
                    feat, verts, kidx, w[:, co:], d, fwd[1], fwd[2], gb, S, co),
                part=f"conv_{layer}")
            ofeat, oidx, ogb = normal(B, n, co), knn_indices_cuda(verts, k), normal(B, 1, co)
            ofwd = _timed(times, "orl_global_fused_fwd",
                          lambda: f.orl_global_fused_fwd(ofeat, oidx), part=f"conv_{layer}")
            out[f"orl_global_fused_fwd conv_{layer}"] = ofwd
            out[f"orl_global_fused_bwd conv_{layer}"] = _timed(
                times, "orl_global_fused_bwd", lambda: f.orl_global_fused_bwd(oidx, ofwd[1], ogb))

        # the serving forward
        torch.manual_seed(0)
        model = build_model(ModelConfig(), device=dev)
        pc = normal(24, N, 3, scale=0.2)
        obj = torch.arange(24, device=dev) % 6
        samples = draw_pool_samples(N, torch.Generator(device=dev).manual_seed(0), dev)
        pose = eval_forward(model, pc, obj, pool_samples=samples)
        out.update({f"serve {k}": v for k, v in zip(pose._fields, pose)})

        # the bf16 tier's surface and ORL kernels: the B=24 forward's shapes, and
        # their forwards with winners at the B=16 step's
        bf16_times = {}
        for B in (24, 16):
            verts = normal(B, N, 3, scale=0.2)
            sargs = (verts, knn_indices_cuda(verts, 20, packed=True), unit(S * 128), S, 128)
            name = "hs_surface (bf16)" if B == 24 else "hs_surface_fused_fwd (bf16)"
            fn = f.hs_surface_fused if B == 24 else f.hs_surface_fused_fwd
            out[name] = _timed(bf16_times, name, lambda: fn(*sargs, exact=False))
            for layer, c, n, k in [(0, 128, N, 20), (1, 128, N, 20), (2, 256, N // 4, 20),
                                   (3, 256, N // 4, 20), (4, 512, N // 16, 8)][2 if B == 16 else 0:]:
                pts = normal(B, n, 3, scale=0.2)
                feat, oidx = normal(B, n, c).to(torch.bfloat16), knn_indices_cuda(pts, k, packed=True)
                name = "orl_global (bf16)" if B == 24 else "orl_global_fused_fwd (bf16)"
                fn = f.orl_global_fused if B == 24 else f.orl_global_fused_fwd
                out[f"{name} conv_{layer}"] = _timed(bf16_times, name, lambda: fn(feat, oidx),
                                                     part=f"conv_{layer}")

        # the bf16 tier's K13 and K14 (and the K11 forwards feeding them), B=16
        B = 16
        for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                     (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
            feat = torch.relu(normal(B, n, cin)).to(torch.bfloat16)
            kidx = knn_indices_cuda(feat, k, packed=True)
            g = gather_neighbors(feat, kidx)
            rf = neighbor_directions_normalized(normal(B, n, 3, scale=0.2).to(torch.bfloat16), kidx)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            d, gb = unit(S * co).to(torch.bfloat16), normal(B, n, co)
            k11 = _k11(cuda_hs, g, feat, kidx)
            fwd = k11(rf, w[:, co:], b[co:], d, S, co)
            novals = k11(rf, w[:, co:], b[co:], d, S, co, store=False)
            out[f"hs_support_fwd (bf16) conv_{layer}"] = fwd
            out[f"hs_support_bwd (bf16) conv_{layer}"] = _timed(
                bf16_times, "hs_support_bwd (bf16)",
                lambda: cuda_hs.hs_support_bwd(g, rf, w[:, co:], d, *fwd[1:], gb, S, co),
                part=f"conv_{layer}")
            out[f"hs_support_bwd_recompute (bf16) conv_{layer}"] = _timed(
                bf16_times, "hs_support_bwd_recompute (bf16)",
                lambda: cuda_hs.hs_support_bwd_recompute(g, rf, w[:, co:], b[co:], d, novals[1],
                                                         gb, S, co), part=f"conv_{layer}")

        # the bf16 tier's K3 with winners and K8, conv_2 .. conv_4 of the v4 step
        for layer, cin, co, n, k in [(2, 128, 256, N // 4, 20), (3, 256, 256, N // 4, 20),
                                     (4, 256, 512, N // 16, 8)]:
            feat = torch.relu(normal(B, n, cin)).to(torch.bfloat16)
            verts, kidx = normal(B, n, 3, scale=0.2), knn_indices_cuda(feat, k, packed=True)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            d, gb = unit(S * co), normal(B, n, co)
            fwd = f.hs_support_fused_fwd(feat, verts, kidx, w[:, co:], b[co:], d, S, co)
            out[f"hs_support_fused_fwd (bf16) conv_{layer}"] = fwd
            out[f"hs_support_fused_bwd (bf16) conv_{layer}"] = _timed(
                bf16_times, "hs_support_fused_bwd (bf16)", lambda: f.hs_support_fused_bwd(
                    feat, verts, kidx, w[:, co:], d, fwd[1], fwd[2], gb, S, co),
                part=f"conv_{layer}")

        # the bf16 tier's K12 and K15, B=16
        verts = normal(B, N, 3, scale=0.2)
        rf = neighbor_directions_normalized(verts.to(torch.bfloat16),
                                            knn_indices_cuda(verts, 20, packed=True))
        dirs, gb = unit(S * 128).to(torch.bfloat16), normal(B, N, 128)
        o, win = _timed(bf16_times, "hs_surface_fwd (bf16)",
                        lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, 128))
        out["hs_surface_fwd (bf16)"] = (o, win)
        out["hs_surface_bwd (bf16)"] = _timed(
            bf16_times, "hs_surface_bwd (bf16)",
            lambda: cuda_hs.hs_surface_bwd(rf, dirs, win, gb, S, 128))

        # the bf16 tier's K9 at the B=16 step's conv_0, on its K2 winners
        verts = normal(B, N, 3, scale=0.2)
        vidx, dirs, gb = knn_indices_cuda(verts, 20, packed=True), unit(S * 128), normal(B, N, 128)
        win = f.hs_surface_fused_fwd(verts, vidx, dirs, S, 128, exact=False)[1]
        out["hs_surface_fused_bwd (bf16)"] = _timed(
            bf16_times, "hs_surface_fused_bwd (bf16)",
            lambda: f.hs_surface_fused_bwd(verts, vidx, dirs, win, gb, S, 128, exact=False))

        # the bf16 tier's K10 at conv_2 .. conv_4 of the v4 step, on the bf16
        # forward's winners, B=16
        for layer, c, n, k in [(2, 256, N // 4, 20), (3, 256, N // 4, 20), (4, 512, N // 16, 8)]:
            ofeat = normal(B, n, c).to(torch.bfloat16)
            oidx = knn_indices_cuda(normal(B, n, 3, scale=0.2), k, packed=True)
            owin, ogb = f.orl_global_fused_fwd(ofeat, oidx)[1], normal(B, 1, c)
            out[f"orl_global_fused_bwd (bf16) conv_{layer}"] = _timed(
                bf16_times, "orl_global_fused_bwd (bf16)",
                lambda: f.orl_global_fused_bwd(oidx, owin, ogb, torch.bfloat16),
                part=f"conv_{layer}")

        # the chamfer kernels K16, K17 and K18 at the recon tier's shape,
        # (24, 1028) x (24, 1028), both directions (timed), and on a cloud whose
        # points repeat the other's (exact zeros and ties), as chip_smoke.py's
        # chamfer_clouds
        B = 24
        a = normal(B, N, 3, scale=0.2)
        for kind in ("recon", "duplicates"):
            if kind == "recon":
                cb = (normal(B, N, 3, scale=0.2) + 0.05).contiguous()
                tag, tt = "", times
            else:
                pick = torch.from_numpy(rng.integers(0, N // 2, (B, N))).to(dev)
                cb = torch.gather(a, 1, pick[..., None].expand(B, N, 3)).contiguous()
                tag, tt = " duplicates", {}
            arg = {}
            for x, y, way in ((a, cb, "a->b"), (cb, a, "b->a")):
                out[f"chamfer_min{tag} {way}"] = _timed(tt, "chamfer_min",
                                                        lambda: ch.chamfer_min_cuda(x, y))
                arg[way] = _timed(tt, "chamfer_min_argmin", lambda: ch.chamfer_min_argmin_cuda(x, y))
                out[f"chamfer_min_argmin{tag} {way}"] = arg[way]
            ia, ib = arg["a->b"][1], arg["b->a"][1]
            gda, gdb = normal(B, N), normal(B, N)
            out[f"chamfer_grad{tag} ga"] = _timed(
                tt, "chamfer_grad", lambda: ch.chamfer_grad_cuda(a, cb, ia, ib, gda, gdb))
            out[f"chamfer_grad{tag} gb"] = _timed(
                tt, "chamfer_grad", lambda: ch.chamfer_grad_cuda(cb, a, ib, ia, gdb, gda))

        # times only: the bf16 tier's KNN and support kernels, B=24
        B = 24
        for n, d, k in [(N, 3, 20), (N, 128, 20), (N, 3, 4), (N // 4, 3, 20), (N // 4, 128, 20),
                        (N // 4, 256, 20), (N // 4, 3, 4), (N // 16, 3, 8), (N // 16, 256, 8)]:
            pts = clouds[n] if d == 3 else normal(B, n, d).to(torch.bfloat16)
            _timed(bf16_times, "knn_packed (bf16)",
                   lambda: knn_indices_cuda(pts, k, packed=True))
        for cin, co, n, k in [(128, 128, N, 20), (128, 256, N // 4, 20), (256, 256, N // 4, 20),
                              (256, 512, N // 16, 8)]:
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w, b = normal(cin, (S + 1) * co, scale=stdv), normal((S + 1) * co, scale=stdv)
            args = (normal(B, n, cin).to(torch.bfloat16), clouds[n],
                    knn_indices_cuda(clouds[n], k, packed=True), w[:, co:], b[co:],
                    unit(S * co), S, co)
            _timed(bf16_times, "hs_support (bf16)", lambda: f.hs_support_fused(*args))
        times.update(bf16_times)

        # times only: serving crops/s at B=24 in both tiers
        rates = {}
        sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=dev).repeat(24, 1)
        for tier in ("float32", "bfloat16"):
            torch.manual_seed(0)
            m = build_model(ModelConfig(compute_dtype=tier), device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)

            def serve():
                o = eval_forward(m, pc, obj, generator=gen)
                return generate_RT(o.p_green_R, o.p_red_R, o.f_green_R, o.f_red_R, o.pred_T, sym)

            rates[f"serving crops/s {tier}"] = _crops_per_s(serve, 24)

    # three train steps
    torch.manual_seed(0)
    model = build_model(ModelConfig(), device=dev, train_heads=True)
    step = build_train_step(HSPoseConfig(), model, torch.Generator(device=dev).manual_seed(0))
    batch = to_device(synthetic_train_batch(16, N, seed=0), dev)
    out["train total_loss"] = torch.tensor([step(batch)["total_loss"] for _ in range(3)],
                                           dtype=torch.float64)
    flat = {}
    for k, v in out.items():
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            flat[f"{k}[{i}]"] = x.detach().cpu()
    return {"tree": tree, "outputs": flat, "times": times, "rates": rates,
            "card": torch.cuda.get_device_name(0)}


def compare(paths: list[str]) -> int:
    import torch

    runs = [torch.load(p) for p in paths]
    names = list(runs[0]["outputs"])
    differ = [k for k in names
              if not all(torch.equal(r["outputs"][k], runs[0]["outputs"][k]) for r in runs[1:])]
    print(f"{len(names) - len(differ)} of {len(names)} outputs hold the same bits in "
          f"{', '.join(paths)}")
    for k in differ:
        print(f"  differ: {k}, max abs "
              + ", ".join(f"{(r['outputs'][k].double() - runs[0]['outputs'][k].double()).abs().max().item():.3e}"
                          for r in runs[1:]))
    print("cards: " + " | ".join(r.get("card", "?") for r in runs))
    print("kernel ms per pass: " + " | ".join(Path(p).stem for p in paths))
    for name in runs[0]["times"]:
        print(f"  {name}: " + " | ".join(f"{r['times'].get(name, float('nan')):.4f}"
                                          for r in runs))
    for name in runs[0].get("rates", {}):
        print(f"  {name} (best of 3 windows): "
              + " | ".join(f"{r['rates'][name][0]:.1f} {[round(x, 1) for x in r['rates'][name][1]]}"
                           for r in runs if name in r.get("rates", {})))
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="checkout whose hspose_tpu_torch to run")
    ap.add_argument("--out", help="where to save the outputs and times (.pt)")
    ap.add_argument("--compare", nargs="+", help="saved files to compare")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    import torch

    if not torch.cuda.is_available():
        print("fp32_bits: no CUDA device", file=sys.stderr)
        return 2
    res = collect(args.tree)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(res, args.out)
    print(f"{args.tree}: {len(res['outputs'])} outputs saved to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
