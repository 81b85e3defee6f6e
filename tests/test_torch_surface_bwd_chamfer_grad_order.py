"""The orders of work of the chamfer gradient K18
(``hspose_tpu_torch/csrc/chamfer.cu::chamfer_grad_kernel``) and of the fused
surface backward K9 (``csrc/hs_surface.cu::fused_bwd_kernel``,
``hs::sum_tiles_kernel``) against those of the designs they replaced, on the CPU.

K18 no longer builds the inverse lists of ib.  A block owns a tile of GT
rows of a, reads ib (with b and gdb) in windows of GW points and compacts
the window's entries that fall in its tile, stably (per 32-entry slice a
ballot, a prefix over the slices' counts), into a shared-memory list; each
row's thread adds the list's terms that name its row, in list order, the
windows in order.
The numpy model below runs that compaction over random tile and window
sizes (windows smaller than the list: rounds), and each row's terms must
come in the inverse lists' order (increasing j), so that ga has the bits of
``chamfer_grad`` (index_add_ in increasing j), on clouds whose b points all
share one nearest point of a, with M != N, and with duplicated points.

K9 no longer writes the routed cotangent dz.  One block per 64 queries (the
chunk of dd's partial sums) routes 32-column chunks into shared memory and
sums drfn there by a lane per query in column order (K15's walk, with the
sum of the column two ahead loaded early and forwarded from registers);
dd's partial row is the chain over the block's queries in order, which its
four router warps continue one after another; the rows are summed in part
order in rounds; dverts adds each source row's drf entries in inverse-list
order onto -sum_k drf, finding them itself (a block per VR source rows
counts and ranks the batch's neighbour entries that name its rows, per
warp slice, as the inverse lists rank them), with no lists in memory.  The
model below runs both
schedules on tied inputs in both tiers and must give the replaced design's
bits (drfn, dd, and dverts, whose list-free kernel must read each source
row's entries in inverse-list order over its row blocks, windows and
slices), and agree with ``hs_surface_fused_bwd_plain`` (whose BLAS products
sum in their own order, and whose CPU square root can round the norm
differently from the card's exact one).  The
kernels' own arithmetic is held to the parent's bits on the card
(``hspose_tpu_torch/tools/fp32_bits.py``, ``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, chamfer as ch, cuda_hs_fused as f

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
CHAMFER_SRC = (_build.CSRC / "chamfer.cu").read_text()
SURFACE_SRC = (_build.CSRC / "hs_surface.cu").read_text()
FUSED_SRC = (_build.CSRC / "hs_fused_bwd.cuh").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


GT = _const(CHAMFER_SRC, "GT")  # rows of a per K18 block
GW = _const(CHAMFER_SRC, "GW")  # points of b per K18 window
GTHREADS = _const(CHAMFER_SRC, "GTHREADS")  # threads per K18 block
RED_QC = _const(FUSED_SRC, "RED_QC")  # queries per dd partial row (K9's block)
BCC = _const(SURFACE_SRC, "BCC")  # columns per K9 chunk
SUM_ROWS = _const((_build.CSRC / "hs_common.cuh").read_text(), "SUM_ROWS")  # hs::sum_tiles_kernel
VR = _const(SURFACE_SRC, "VR")  # source rows per block of dverts_rows_kernel
VS = _const(SURFACE_SRC, "VS")  # its slices (warps) of a window
VW_MAX = int(re.search(r"constexpr int VW_MAX = (\d+) \* (\d+);", SURFACE_SRC).group(1)) * 1024


@pytest.fixture
def rng():
    return np.random.default_rng(14)


def bf16(x: np.ndarray) -> np.ndarray:
    """The fp32 values ``x`` rounds to in bf16 (to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def fma(a, b, c):
    """fmaf on float32 arrays: the exact product and sum, rounded once (the
    float64 product of two float32 values is exact, and a float64 sum of it
    and a float32 value rounds to the same float32 as the exact sum here,
    the operands' exponents lying close)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


# --------------------------------------------------------------------------- #
# K18
# --------------------------------------------------------------------------- #

def inverse_list_order(ib: np.ndarray, N: int) -> list[list[int]]:
    """The replaced design: per row i of a, the j with ib_j == i in increasing j."""
    order = np.argsort(ib, kind="stable")
    lists = [[] for _ in range(N)]
    for j in order:
        lists[ib[j]].append(int(j))
    return lists


def tile_compaction_order(ib: np.ndarray, N: int, gt: int, gw: int) -> list[list[int]]:
    """The new kernel, one batch: per tile of gt rows, per window of gw
    points, the window's entries that fall in the tile written at their
    slice's start (an exclusive prefix over the 32-entry slices' counts, in
    j order) plus their rank in the slice's ballot; each row's thread then
    walks the list in order and takes the entries that name its row."""
    M = ib.shape[0]
    lists = [[] for _ in range(N)]
    for i0 in range(0, N, gt):
        for j0 in range(0, M, gw):
            js = np.arange(j0, min(j0 + gw, M))
            keep = (ib[js] >= i0) & (ib[js] < i0 + gt)
            slices = [keep[s:s + 32] for s in range(0, len(js), 32)]
            counts = [int(s.sum()) for s in slices]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            listed = np.full(sum(counts), -1)
            for s, (sl, st) in enumerate(zip(slices, starts)):
                for lane in np.flatnonzero(sl):
                    rank = int(sl[:lane].sum())  # popc(ballot & lanes below)
                    listed[st + rank] = js[32 * s + lane]
            assert (listed >= 0).all() and len(listed) <= gw  # a window never overflows
            for e in listed:  # the walk: every row's thread reads every entry in order
                lists[ib[e]].append(int(e))
    return lists


def grad_in_order(a, b, ia, ib, gda, gdb, lists) -> np.ndarray:
    """ga of one batch by the kernel's expressions, each row's terms in the
    order of ``lists``: __fmul_rn(2 * __fsub_rn(a, b), g) for the direct term,
    then __fadd_rn(acc, -__fmul_rn(2 * __fsub_rn(b_j, a_i), g_j)) per entry."""
    two = F32(2)
    ga = (two * (a - b[ia])).astype(F32) * gda[:, None]
    for i, js in enumerate(lists):
        for j in js:
            ga[i] = ga[i] + -((two * (b[j] - a[i])).astype(F32) * gdb[j])
    return ga.astype(F32)


def chamfer_case(rng, kind: str, B=2, N=150, M=130):
    """Clouds a (B, N, 3), b (B, M, 3) and their argmins: ``apart``; ``collapse``,
    every point of b nearest to one point of a; ``duplicates``, b made of
    points of a, each twice or more (exact zeros, ties)."""
    a = rng.normal(scale=0.2, size=(B, N, 3)).astype(F32)
    if kind == "apart":
        b = rng.normal(scale=0.2, size=(B, M, 3)).astype(F32) + F32(0.05)
    elif kind == "collapse":  # b far out along one direction: all nearest to one point of a
        b = (rng.normal(scale=0.01, size=(B, M, 3)) + [5.0, 5.0, 5.0]).astype(F32)
    else:
        b = np.take_along_axis(a, rng.integers(0, N // 2, size=(B, M, 1)), axis=1)
    at, bt = torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b))
    ia = ch.chamfer_min_argmin(at, bt)[1]
    ib = ch.chamfer_min_argmin(bt, at)[1]
    gda = torch.from_numpy(rng.normal(size=(B, N)).astype(F32))
    gdb = torch.from_numpy(rng.normal(size=(B, M)).astype(F32))
    return at, bt, ia, ib, gda, gdb


@pytest.mark.parametrize("kind,N,M", [("apart", 150, 130), ("apart", 70, 300),
                                      ("collapse", 150, 130), ("collapse", 40, 700),
                                      ("duplicates", 150, 130), ("duplicates", 130, 260)])
def test_k18_tile_compaction_keeps_the_list_order(rng, kind, N, M):
    """Over the kernel's tile and window and random smaller ones (windows of
    fewer points than the tile's list: several rounds), each row's terms
    come in increasing j, and ga has chamfer_grad's bits, for both clouds."""
    a, b, ia, ib, gda, gdb = chamfer_case(rng, kind, N=N, M=M)
    if kind == "collapse":
        assert (ib == ib[:, :1]).all()  # every point of b shares one nearest point
    for x, y, ix, iy, gx, gy in ((a, b, ia, ib, gda, gdb), (b, a, ib, ia, gdb, gda)):
        want = ch.chamfer_grad(x, y, ix, iy, gx, gy).numpy()
        n = x.shape[1]
        for bi in range(x.shape[0]):
            ibb = iy[bi].numpy()
            lists = inverse_list_order(ibb, n)
            sizes = [(GT, GW), (int(rng.integers(1, n + 1)), 32 * int(rng.integers(1, 4))),
                     (int(rng.integers(1, 40)), 32)]
            for gt, gw in sizes:
                assert tile_compaction_order(ibb, n, gt, gw) == lists, (gt, gw)
            got = grad_in_order(x[bi].numpy(), y[bi].numpy(), ix[bi].numpy(), ibb,
                                gx[bi].numpy(), gy[bi].numpy(), lists)
            assert np.array_equal(got.view(np.uint32), want[bi].view(np.uint32))


def test_k18_launch_plan():
    """At the recon shape (24, 1028) the tiles fill the 132 SMs, a window
    holds a whole cloud of 1028 points (one round), a window's slices are
    whole warps' reads, the list fits the kernel's static shared memory, and
    the entry point takes no scratch."""
    assert 24 * -(-1028 // GT) >= 132
    assert GW >= 1028 and GW % GTHREADS == 0 and GTHREADS % 32 == 0 and GT <= GTHREADS
    assert 16 * GW + 4 * (GW + _const(CHAMFER_SRC, "GU")) + 4 * (GW // 32 + 1) <= 48 * 1024
    m = re.search(r'extern "C" int hs_chamfer_grad\(([^)]*)\)', CHAMFER_SRC)
    params = [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params == ["a", "b", "ia", "ib", "gda", "gdb", "ga", "B", "N", "M", "stream"]
    assert "inverse_index" not in CHAMFER_SRC and "N * sizeof(int)" not in CHAMFER_SRC


# --------------------------------------------------------------------------- #
# K9
# --------------------------------------------------------------------------- #

def stage_rf(verts, idx, fast):
    """hs::stage_rf: rf = v[idx] - v, its norm and the unit rows (B, N, K, 3).
    FAST: xyz rounded to bf16, norm sqrt((x^2 + y^2) + z^2) and rf * (1 /
    max(norm, 1e-12)) each rounded, the unit rows rounded to bf16; fp32: the
    norm as nvcc contracts x*x + y*y + z*z, rf / max(norm, 1e-12)."""
    v = bf16(verts) if fast else verts
    rf = (v[np.arange(v.shape[0])[:, None, None], idx] - v[:, :, None, :]).astype(F32)
    x, y, z = rf[..., 0], rf[..., 1], rf[..., 2]
    if fast:
        sq = ((x * x + y * y) + z * z).astype(F32)
        norm = np.sqrt(sq).astype(F32)
        rfn = bf16(rf * (F32(1) / np.maximum(norm, F32(1e-12)))[..., None])
    else:
        norm = np.sqrt(fma(z, z, fma(x, x, y * y))).astype(F32)
        rfn = (rf / np.maximum(norm, F32(1e-12))[..., None]).astype(F32)
    return rf, norm, rfn


def route(rfn, dirs, win, gb, S, fast):
    """u (B, N, S*Co): at each column's winner, theta = fma(r2, d2, fma(r0,
    d0, r1 d1)) as the kernels form it, u = [theta > 0] gb/S; FAST: gb times
    1/S rounded to fp32, then to bf16, and the directions rounded to bf16."""
    SC, co = dirs.shape[1], gb.shape[-1]
    d = bf16(dirs) if fast else dirs
    g = (gb * (F32(1) / F32(S))).astype(F32) if fast else (gb / F32(S)).astype(F32)
    if fast:
        g = bf16(g)
    r = np.take_along_axis(rfn, win[..., None].astype(np.int64), 2)  # (B, N, SC, 3)
    th = fma(r[..., 2], d[2], fma(r[..., 0], d[0], (r[..., 1] * d[1]).astype(F32)))
    return np.where(th > 0, g[..., np.arange(SC) % co], F32(0)).astype(F32), d, r


def drfn_parent(u, win, d, K, fast):
    """rf_grad_kernel: per (query, k, dim) the columns k wins with u != 0, in
    column order, fp32 fmaf from 0 or (FAST) fp64 sums of the exact products,
    rounded to fp32 once."""
    B, N, SC = win.shape
    acc = np.zeros((B, N, K, 3), np.float64 if fast else F32)
    bi, ni = np.meshgrid(np.arange(B), np.arange(N), indexing="ij")
    for c in range(SC):
        k, uc = win[..., c], u[..., c]
        live = (uc != 0)[..., None]
        old = acc[bi, ni, k]
        if fast:
            new = old + uc[..., None].astype(np.float64) * d[:, c]
        else:
            new = fma(uc[..., None], d[:, c], old)
        acc[bi, ni, k] = np.where(live, new, old)
    return acc.astype(F32)


def drfn_walk(u, win, d, K, fast):
    """fused_bwd_kernel's walk: chunks of BCC columns (the last padded with u
    = 0 at the last column's winner), every column added (u = 0 included); at
    each column the sum of the column two ahead is loaded before this
    column's is stored and replaced by the value in registers when the next
    column's winner is that of this column or of the one before."""
    B, N, SC = win.shape
    mem = np.zeros((B, N, K, 3), np.float64 if fast else F32)
    bi, ni = np.meshgrid(np.arange(B), np.arange(N), indexing="ij")

    def add(uc, dc, acc):
        return acc + uc[..., None].astype(np.float64) * dc if fast else fma(uc[..., None], dc, acc)

    for c0 in range(0, SC, BCC):
        cols = [min(c, SC - 1) for c in range(c0, c0 + BCC)]
        us = [u[..., c] if c < SC else np.zeros((B, N), F32) for c in range(c0, c0 + BCC)]
        ks = [win[..., c] for c in cols]
        k0, k1, kprev = ks[0], ks[1], np.full((B, N), -1)
        a = mem[bi, ni, k0]
        p1, aprev = mem[bi, ni, k1], a
        for e in range(BCC):
            k2 = ks[e + 2] if e + 2 < BCC else k0
            p2 = mem[bi, ni, k2] if e + 2 < BCC else a
            anew = add(us[e], d[:, cols[e]], a)
            mem[bi, ni, k0] = anew
            a = np.where((k1 == k0)[..., None], anew,
                         np.where((k1 == kprev)[..., None], aprev, p1))
            kprev, aprev, k0, k1, p1 = k0, anew, k1, k2, p2
    return mem.astype(F32)


def dd_parts(u, r, fast):
    """Per (batch, RED_QC-query chunk), batch-major: each column's
    fma(rfn[q, win][d], u, acc) from 0.f over the chunk's queries in order
    (FAST: exact products, so the same as a product then a sum)."""
    B, N, SC = u.shape
    parts = []
    for b in range(B):
        for q0 in range(0, N, RED_QC):
            acc = np.zeros((3, SC), F32)
            for q in range(q0, min(q0 + RED_QC, N)):
                acc = fma(r[b, q].T, u[b, q], acc)
            parts.append(acc)
    return np.stack(parts)


def sum_in_order(parts, rounds: int | None = None):
    """From 0.f, the rows added in order; ``rounds`` stages them that many
    at a time (hs::sum_tiles_kernel), the running sum carried across rounds."""
    s = np.zeros(parts.shape[1:], F32)
    step = rounds or len(parts)
    for p0 in range(0, len(parts), step):
        for p in parts[p0:p0 + step]:
            s = (s + p).astype(F32)
    return s


def rf_chain(rf, norm, a, fast):
    """The cotangent of rf from drfn a: FAST the fp32 steps of
    _rf_grad_fast; fp32 rf_grad_kernel's chain as written out in
    fused_bwd_kernel (rf_chain): s and the norm the y product first, then
    fused multiply-adds of x and z; g = fma(a, inv, -(r * h))."""
    inv = (F32(1) / np.maximum(norm, F32(1e-12))).astype(F32)[..., None]
    x, y, z = rf[..., 0], rf[..., 1], rf[..., 2]
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    if fast:
        s = ((a0 * x + a1 * y) + a2 * z).astype(F32)
    else:
        s = fma(a2, z, fma(a0, x, a1 * y))
    h = np.where(norm >= F32(1e-12), ((s * inv[..., 0]) * inv[..., 0]) * inv[..., 0], F32(0))
    h = h.astype(F32)[..., None]
    if fast:
        return ((a * inv).astype(F32) - (rf * h).astype(F32)).astype(F32)
    return fma(a, inv, -(rf * h).astype(F32))


def rows_order(idx: np.ndarray, N: int, vr: int, vw: int, vs: int) -> list[list[int]]:
    """dverts_rows_kernel, one batch: per block of vr source rows, per window
    of at most vw of the N*K entries, the vs slices' counts of each row,
    each row's run and its slices' starts (a scan), then each slice's
    entries placed 32 at a time in order (rank = the lanes below with the
    same row); each row's thread reads its run in order."""
    flat = idx.reshape(-1)
    E = flat.shape[0]
    runs = [[] for _ in range(N)]
    for r0 in range(0, N, vr):
        for w0 in range(0, E, vw):
            wn = min(vw, E - w0)
            per = -(-wn // vs)
            bounds = [(w0 + min(wn, w * per), w0 + min(wn, w * per + per)) for w in range(vs)]
            cnt = np.zeros((vs, vr), np.int64)
            for w, (lo, hi) in enumerate(bounds):
                rows = flat[lo:hi] - r0
                np.add.at(cnt[w], rows[(rows >= 0) & (rows < vr)], 1)
            tot = cnt.sum(0)
            start = np.concatenate([[0], np.cumsum(tot)[:-1]])
            nxt = start + np.concatenate([np.zeros((1, vr), np.int64), np.cumsum(cnt, 0)[:-1]])
            ent = np.full(int(tot.sum()), -1)
            for w, (lo, hi) in enumerate(bounds):
                for e0 in range(lo, hi, 32):
                    es = np.arange(e0, min(e0 + 32, hi))
                    rows = flat[es] - r0
                    hit = (rows >= 0) & (rows < vr)
                    for lane in np.flatnonzero(hit):
                        rank = int((rows[:lane][hit[:lane]] == rows[lane]).sum())
                        ent[nxt[w, rows[lane]] + rank] = es[lane]
                    for r in np.unique(rows[hit]):
                        nxt[w, r] += int((rows[hit] == r).sum())
            assert (ent >= 0).all() and len(ent) <= vw  # a window's list fits
            for t in range(min(vr, N - r0)):
                runs[r0 + t] += [int(e) for e in ent[start[t]:start[t] + tot[t]]]
    return runs


def dverts_in_order(drf, idx, runs, fast):
    """Per source row, its entries' drf (FAST: rounded to bf16) added from
    0.f in the order of ``runs``, plus dvq = 0 - drf[q, 0] - drf[q, 1] ... in
    k order (the fused kernel's)."""
    B, N, K, _ = drf.shape
    ops = (bf16(drf) if fast else drf).reshape(B, N * K, 3)
    s = np.zeros((B, N, 3), F32)
    for b in range(B):
        for r in range(N):
            for e in runs[b][r]:
                s[b, r] = s[b, r] + ops[b, e]
    dvq = np.zeros((B, N, 3), F32)
    for k in range(K):
        dvq = (dvq - drf[:, :, k]).astype(F32)
    return (s + dvq).astype(F32)


def surface_case(rng, N, K, S, co, B=2):
    """verts with a duplicated point (query 1 equals query 0, and each is
    the other's neighbour: |rf| = 0), neighbour lists by distance, winners
    from the plain forward (query 2's rows made equal: every column ties
    across k and the first k wins), and gb with zeros of either sign."""
    verts = rng.normal(scale=0.2, size=(B, N, 3)).astype(F32)
    verts[:, 1] = verts[:, 0]
    d2 = ((verts[:, :, None] - verts[:, None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., 1:K + 1].astype(np.int32)
    idx[:, 0, 0], idx[:, 1, 0] = 1, 0
    idx[:, 2] = idx[:, 2, :1]  # all of query 2's neighbours the same point
    dirs = rng.normal(size=(3, S * co)).astype(F32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    gb = (rng.integers(-4, 5, size=(B, N, co)) / 4.0
          + rng.normal(scale=0.1, size=(B, N, co))).astype(F32)
    gb[:, ::3, :5] = 0.0
    gb[:, 1::4, 5:7] = -0.0
    return verts, idx, dirs, gb


@pytest.mark.parametrize("N,K,S,co", [(130, 20, 7, 64), (130, 5, 3, 16), (70, 20, 3, 16),
                                      (100, 5, 7, 64)])
@pytest.mark.parametrize("fast", [False, True])
def test_k9_fused_order_keeps_the_bits(rng, N, K, S, co, fast):
    verts, idx, dirs, gb = surface_case(rng, N, K, S, co)
    vt, it, dt, gt = (torch.from_numpy(x) for x in (verts, idx, dirs, gb))
    win = f.hs_surface_fused_fwd_plain(vt, it, dt, S, co, exact=not fast)[1].numpy()
    assert (win[:, 2] == 0).all()  # tied rows: the first k wins every column
    rf, norm, rfn = stage_rf(verts, idx, fast)
    assert (norm[:, :2, 0] < 1e-12).all()  # the duplicated point
    u, d, r = route(rfn, dirs, win, gb, S, fast)
    assert (u == 0).any() and (u != 0).any()
    want = drfn_parent(u, win, d, K, fast)
    got = drfn_walk(u, win, d, K, fast)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    parts = dd_parts(u, r, fast)
    assert len(parts) == 2 * -(-N // RED_QC)
    dd = sum_in_order(parts, SUM_ROWS)
    assert np.array_equal(dd.view(np.uint32), sum_in_order(parts).view(np.uint32))
    assert np.array_equal(sum_in_order(parts, 3).view(np.uint32), dd.view(np.uint32))
    drf = rf_chain(rf, norm, got, fast)
    assert not drf[:, :2, 0].any()  # a duplicated point passes nothing
    lists = [inverse_list_order(idx[b].reshape(-1), N) for b in range(idx.shape[0])]
    for vr, vw, vs in ((VR, min(N * K, VW_MAX), VS), (37, 96, 3), (N, 64, 2)):  # and rounds
        assert [rows_order(idx[b], N, vr, vw, vs) for b in range(idx.shape[0])] == lists
    dverts = dverts_in_order(drf, idx, lists, fast)
    pv, pd = (x.numpy() for x in f.hs_surface_fused_bwd_plain(vt, it, dt, torch.from_numpy(win),
                                                              gt, S, co, exact=not fast))
    # the plain version sums dd by a BLAS product, and on the CPU its
    # torch.sqrt may round the norm one ulp off (the card's is exact), which
    # can move a bf16 rounding of drf: within a bf16 ulp of the largest
    tol = 2.0 ** -8 if fast else 1e-5
    np.testing.assert_allclose(dverts, pv, rtol=0, atol=tol * np.abs(pv).max())
    np.testing.assert_allclose(dd, pd, rtol=0, atol=tol * np.abs(pd).max())


@pytest.mark.parametrize("fast", [False, True])
def test_k9_launch_plan(fast):
    """A block is one dd partial row of 64 queries, its four router warps
    16 queries each, and a chunk a warp's 32 lanes; the entry point takes no
    dz and no inverse-list scratch; the fused block's shared memory
    (csrc/hs_surface.cu::fused_bwd_smem) fits at K = 32 in both tiers with gb
    / S staged at the most channels that stage it, and dverts' window list
    with its counts."""
    assert RED_QC == 64 and BCC == 32
    assert _const(SURFACE_SRC, "ROUTE_WARPS") == 4
    assert "constexpr int A_ROWS = BQ / ROUTE_WARPS;" in SURFACE_SRC
    m = re.search(r'extern "C" int hs_surface_fused_bwd\(([^)]*)\)', SURFACE_SRC)
    params = [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert "dz" not in params and "rowptr" not in params and "ent" not in params
    K, BQ, BCP = 32, RED_QC, BCC + 1
    sg_max = int(re.search(r"constexpr int SG_MAX = (\d+) \* 1024;", SURFACE_SRC).group(1)) * 1024
    smem = ((8 if fast else 4) * 3 * K * BQ + 16 * 2 * BCC
            + 4 * (6 * BQ * K + 2 * BQ * BCP + 3 * 3 * BCC) + 4 * BQ * K
            + (0 if fast else sg_max) + 2 * BQ * BCP)
    assert smem <= 227 * 1024
    assert 4 * (VS * VR + VW_MAX) <= 227 * 1024
