"""The orders of work of K10 (``hspose_tpu_torch/csrc/orl.cu::orl_bwd_kernel``)
and of the chamfer search K16/K17 (``csrc/chamfer.cu::chamfer_min_kernel``)
against those of the kernels they replaced, on the CPU.

K10 now counts, per (point, channel), the source row its winner names, with
integer atomics in shared memory, a block per (32-channel slice, range of
source rows, batch), in whatever order the adds land; the kernel before it
walked each row's inverse neighbour list in order.  An integer count does
not depend on the order, and both kernels store it with the same
expression, so dfeat keeps its bits: the numpy models below add the pairs
in shuffled orders, over the kernel's slices and row ranges (its launch
plan, read from the source), and must give the bits of the list walk and of
``orl_global_fused_bwd_plain`` in fp32 and bf16.

The chamfer search now splits each cloud's sources over the warps of a
block, keeps per part the first minimum of a strict '<' walk in increasing
index, and merges the parts by the lexicographic minimum of (distance,
index); K16 merges the distance alone by fminf.  The models split the
sources at random (contiguous parts and arbitrary subsets), merge the parts
in random orders, and must give ``torch.min``'s value and first index on the
plain distance matrix, on clouds with duplicated points (exact zeros and
ties).  The kernels' own arithmetic is held to the parent's bits on the card
(``hspose_tpu_torch/tools/fp32_bits.py``, ``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, chamfer as ch, cuda_hs_fused as f
from hspose_tpu_torch.ops.knn import pairwise_sq_dist

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
ORL_SRC = (_build.CSRC / "orl.cu").read_text()
CHAMFER_SRC = (_build.CSRC / "chamfer.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


BWD_CS = _const(ORL_SRC, "BWD_CS")  # channels per K10 block
SMEM_MAX = _const(ORL_SRC, "SMEM_MAX")  # bytes of shared memory a block may use
CW = _const(CHAMFER_SRC, "CW")  # source parts (warps) per chamfer block
QMAX = _const(CHAMFER_SRC, "QMAX")  # queries per lane, at most
G = _const(CHAMFER_SRC, "G")  # points per step of the chamfer walk
CH = _const(CHAMFER_SRC, "CH")  # points a warp stages at a time


@pytest.fixture
def rng():
    return np.random.default_rng(13)


# --------------------------------------------------------------------------- #
# K10
# --------------------------------------------------------------------------- #

def k10_plan(N: int, K: int) -> tuple[bool, int]:
    """(idx staged in shared memory, source rows per block): csrc/orl.cu::
    launch_bwd_v."""
    idx_bytes = 4 * ((N * K + 3) // 4 * 4)
    row = 4 * BWD_CS
    if idx_bytes + N * row <= SMEM_MAX:
        return True, N
    if idx_bytes <= SMEM_MAX // 2:
        return True, (SMEM_MAX - idx_bytes) // row
    return False, SMEM_MAX // row


def bf16(x: np.ndarray) -> np.ndarray:
    """The fp32 values ``x`` rounds to in bf16 (to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def store(cnt: np.ndarray, gb: np.ndarray, N: int, fast: bool) -> np.ndarray:
    """Both kernels' store expression on integer counts (B, N, C) and gb (B, 1, C):
    fp32 (float)cnt * (gb / N); bf16 (float)cnt * bf16(gb * (1/N)), rounded to bf16."""
    if fast:
        return bf16(cnt.astype(F32) * bf16(gb * (F32(1) / F32(N))))
    return cnt.astype(F32) * (gb / F32(N))


def counts_list_walk(idx: np.ndarray, win: np.ndarray) -> np.ndarray:
    """The replaced kernel: each source row r walks its inverse list, the
    (q, k) entries with idx[q, k] == r in increasing q*K + k, and counts, per
    channel, the entries whose k won the channel at q."""
    B, N, K = idx.shape
    C = win.shape[2]
    cnt = np.zeros((B, N, C), np.int64)
    for b in range(B):
        flat = idx[b].reshape(-1)
        order = np.argsort(flat, kind="stable")  # the counting sort's lists
        for e in order:
            q, k = divmod(int(e), K)
            cnt[b, flat[e]] += win[b, q] == k
    return cnt


def counts_scatter(rng, idx: np.ndarray, win: np.ndarray, R: int, cs: int) -> np.ndarray:
    """The new kernel: per block (slice of cs channels, R source rows, batch),
    every (point, channel) pair of the slice adds one to the count of the row
    r = idx[q, win[q, c]] if r lies in the block's range, the pairs taken in a
    shuffled order (the atomics' order is any)."""
    B, N, K = idx.shape
    C = win.shape[2]
    cnt = np.zeros((B, N, C), np.int64)
    for b in range(B):
        rows = np.take_along_axis(idx[b], win[b], axis=1)  # (N, C): r per pair
        for c0 in range(0, C, cs):
            cw = min(cs, C - c0)
            q, c = np.divmod(rng.permutation(N * cw), cw)  # the slice's pairs, shuffled
            for r0 in range(0, N, R):
                block = np.zeros((min(R, N - r0), cw), np.int64)
                r = rows[q, c0 + c] - r0
                keep = (r >= 0) & (r < block.shape[0])
                np.add.at(block, (r[keep], c[keep]), 1)  # unbuffered, in the shuffled order
                cnt[b, r0:r0 + block.shape[0], c0:c0 + cw] = block
    return cnt


def tied_case(rng, B, N, C, K):
    """Neighbour lists that name one source row twice (a duplicated point's
    twin) and repeat whole rows, winners from features on a coarse grid (many
    maxima tie across k: the first k wins), and a cotangent with both signs
    (zero counts store a signed zero)."""
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    idx[:, :, K // 2] = idx[:, :, 0]
    idx[:, 1::7] = idx[:, 0:1]
    feat = torch.from_numpy((rng.integers(-2, 3, size=(B, N, C)) / 4.0).astype(F32))
    _, win = f.orl_global_fused_fwd_plain(feat, torch.from_numpy(idx))
    gb = rng.normal(size=(B, 1, C)).astype(F32)
    return idx, win.numpy(), gb


# the v4 step's three ORL calls (C, N, K) at B = 2, a C that is not a multiple
# of 4, and an N whose counts do not fit one block
K10_SHAPES = [(256, 257, 20), (512, 64, 8), (50, 257, 20), (36, 2056, 5)]


@pytest.mark.parametrize("C,N,K", K10_SHAPES)
@pytest.mark.parametrize("fast", [False, True])
def test_k10_counts_in_any_order_keep_the_bits(rng, C, N, K, fast):
    B = 2
    idx, win, gb = tied_case(rng, B, N, C, K)
    want = counts_list_walk(idx, win)
    _, R = k10_plan(N, K)
    dtype = torch.bfloat16 if fast else torch.float32
    plain = f.orl_global_fused_bwd_plain(torch.from_numpy(idx), torch.from_numpy(win),
                                         torch.from_numpy(gb), dtype).float().numpy()
    ref = store(want, gb, N, fast)
    assert np.array_equal(ref.view(np.uint32), plain.view(np.uint32))
    for rows, cs in ((R, BWD_CS), (max(1, N // 3), BWD_CS), (N, 8)):
        got = counts_scatter(rng, idx, win, rows, cs)
        assert np.array_equal(got, want), (rows, cs)
        assert np.array_equal(store(got, gb, N, fast).view(np.uint32), ref.view(np.uint32))
    assert want.sum() == B * N * C  # every (point, channel) pair counted once
    assert (want[:, :, :] > 1).any() and (want == 0).any()


@pytest.mark.parametrize("N,K,staged,split", [(257, 20, True, False), (64, 8, True, False),
                                               (1028, 20, True, False), (5000, 5, True, True),
                                               (2056, 20, False, True)])
def test_k10_launch_plan(N, K, staged, split):
    """Where the plan stages idx and splits the rows: the shapes of the v4 step
    fit one block per slice; larger N split (chip_smoke.py runs each branch)."""
    sidx, R = k10_plan(N, K)
    assert (sidx, R < N) == (staged, split)
    assert 4 * ((N * K + 3) // 4 * 4 * sidx + R * BWD_CS) <= SMEM_MAX
    assert BWD_CS % 32 == 0  # a count row spans the 32 banks


def test_k10_wrapper_passes_no_scratch():
    """The C entry point takes no inverse-list scratch any more."""
    m = re.search(r'extern "C" int hs_orl_bwd\(([^)]*)\)', ORL_SRC)
    params = [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params == ["idx", "win", "gb", "dfeat", "B", "N", "K", "C", "fast", "stream"]


# --------------------------------------------------------------------------- #
# K16 / K17
# --------------------------------------------------------------------------- #

def walk(d: np.ndarray, js: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One part: a strict '<' walk over the sources js (increasing) from
    (+inf, 0), per query; d (Q, M) fp32."""
    best = np.full(d.shape[0], np.inf, F32)
    arg = np.zeros(d.shape[0], np.int64)
    for j in js:
        upd = d[:, j] < best
        best = np.where(upd, d[:, j], best)
        arg = np.where(upd, j, arg)
    return best, arg


def merge(parts, rng) -> tuple[np.ndarray, np.ndarray]:
    """The lexicographic minimum of (distance, index) over the parts, taken in
    a random order."""
    order = rng.permutation(len(parts))
    best, arg = parts[order[0]]
    for p in order[1:]:
        od, oj = parts[p]
        take = (od < best) | ((od == best) & (oj < arg))
        best, arg = np.where(take, od, best), np.where(take, oj, arg)
    return best, arg


def clouds(rng, kind: str, B=2, N=150, M=130):
    a = rng.normal(scale=0.2, size=(B, N, 3)).astype(F32)
    if kind == "apart":
        b = rng.normal(scale=0.2, size=(B, M, 3)).astype(F32) + F32(0.05)
    elif kind == "duplicates":  # b holds points of a, each twice or more: exact zeros, ties
        b = np.take_along_axis(a, rng.integers(0, N // 2, size=(B, M, 1)), axis=1)
    else:  # "grid": coordinates on a coarse grid, so that many distances tie
        a = (rng.integers(-3, 4, size=(B, N, 3)) / 8.0).astype(F32)
        b = (rng.integers(-3, 4, size=(B, M, 3)) / 8.0).astype(F32)
    return torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b))


def kernel_parts(M: int) -> list[tuple[int, int]]:
    """csrc/chamfer.cu::part_start: CW contiguous parts of whole steps of G,
    their step counts differing by one at most."""
    steps = -(-M // G)
    return [(min(M, G * (w * steps // CW)), min(M, G * ((w + 1) * steps // CW)))
            for w in range(CW)]


def partitions(rng, M: int):
    """The kernel's split (kernel_parts), random contiguous cuts, and
    arbitrary subsets (each walked in increasing j)."""
    yield "kernel", [np.arange(lo, hi) for lo, hi in kernel_parts(M)]
    cuts = np.sort(rng.choice(np.arange(1, M), size=5, replace=False))
    yield "cuts", np.split(np.arange(M), cuts)
    label = rng.integers(0, 7, size=M)
    yield "subsets", [np.flatnonzero(label == p) for p in range(7)]
    yield "singletons", [np.array([j]) for j in range(M)]


@pytest.mark.parametrize("kind", ["apart", "duplicates", "grid"])
def test_chamfer_split_and_merge_is_the_first_minimum(rng, kind):
    a, b = clouds(rng, kind)
    for x, y in ((a, b), (b, a)):
        d = pairwise_sq_dist(x, y)
        want_d, want_i = d.min(-1)
        d = d.numpy()
        for bi in range(d.shape[0]):
            for name, parts in partitions(rng, d.shape[2]):
                got_d, got_i = merge([walk(d[bi], js) for js in parts], rng)
                assert np.array_equal(got_d.view(np.uint32), want_d[bi].numpy().view(np.uint32)), name
                assert np.array_equal(got_i, want_i[bi].numpy()), name
                # K16: the distance alone, merged by fminf in any order
                mins = [walk(d[bi], js)[0] for js in parts]
                fm = mins[0]
                for m in mins[1:]:
                    fm = np.fmin(fm, m)
                assert np.array_equal(fm.view(np.uint32), want_d[bi].numpy().view(np.uint32)), name
    if kind == "duplicates":
        assert (pairwise_sq_dist(b, a).min(-1).values <= 0).any()  # exact zeros


def walk_steps(d: np.ndarray, lo: int, hi: int, ch: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's walk of one part [lo, hi): chunks of ch points, steps of
    G (a chunk's last point repeated to fill its last step), each step's
    minimum by fminf, taken by a strict '<', and per query the first index
    of the step in which the minimum last fell (-1 if it never did)."""
    best = np.full(d.shape[0], np.inf, F32)
    step = np.full(d.shape[0], -1, np.int64)
    for c0 in range(lo, hi, ch):
        c1 = min(hi, c0 + ch)
        for j in range(c0, c1, G):
            m = d[:, j]
            for g in range(1, G):
                m = np.fmin(m, d[:, min(j + g, c1 - 1)])
            take = m < best
            best, step = np.where(take, m, best), np.where(take, j, step)
    return best, step


def kernel_argmin(d: np.ndarray, bounds, ch: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """The parts walked as the kernel walks them, merged in a random order by
    the least (distance, step), then the first point of the winning step
    (clamped to its part) at the merged distance, scanned as the kernel
    scans it."""
    parts = [walk_steps(d, lo, hi, ch) for lo, hi in bounds]
    best, step = merge(parts, rng)
    owner = np.zeros(d.shape[0], np.int64)
    for w, (lo, hi) in enumerate(bounds):
        owner = np.where((step >= lo) & (step < hi), w, owner)
    arg = np.zeros(d.shape[0], np.int64)
    for q in np.flatnonzero(step >= 0):
        hi = bounds[owner[q]][1]
        for g in range(G - 1, -1, -1):
            j = min(step[q] + g, hi - 1)
            if d[q, j] == best[q]:
                arg[q] = j
    return best, arg


@pytest.mark.parametrize("kind", ["apart", "duplicates", "grid"])
@pytest.mark.parametrize("M,ch", [(130, CH), (203, 16)])
def test_chamfer_kernel_walk_is_the_first_minimum(rng, kind, M, ch):
    """The kernel's walk in steps of G and its merge by (distance, step),
    over its own split of the sources into CW parts and over random
    contiguous cuts, one chunk a part or several (ch), give torch.min's
    value and first index."""
    assert M % G and kernel_parts(M)[-1][1] == M  # a part-full last step; every source in a part
    a, b = clouds(rng, kind, M=M)
    for x, y in ((a, b), (b, a)):
        dm = pairwise_sq_dist(x, y)
        want_d, want_i = (v.numpy() for v in dm.min(-1))
        dm = dm.numpy()
        n = dm.shape[2]
        cuts = [0, *np.sort(rng.choice(np.arange(1, n), size=4, replace=False)), n]
        for bounds in (kernel_parts(n), list(zip(cuts[:-1], cuts[1:]))):
            for bi in range(dm.shape[0]):
                got_d, got_i = kernel_argmin(dm[bi], bounds, ch, rng)
                assert np.array_equal(got_d.view(np.uint32), want_d[bi].view(np.uint32))
                assert np.array_equal(got_i, want_i[bi])


@pytest.mark.parametrize("kind", ["apart", "duplicates", "grid"])
def test_chamfer_plain_versions_are_the_first_minimum(kind, rng):
    """The plain versions the card's gates use give torch.min's value and
    first index of the same distance matrix."""
    a, b = clouds(rng, kind)
    d, i = ch.chamfer_min_argmin(a, b)
    want_d, want_i = pairwise_sq_dist(a, b).min(-1)
    assert torch.equal(d, want_d) and torch.equal(i.long(), want_i)
    assert torch.equal(ch.chamfer_min(a, b), want_d)
    assert i.dtype == torch.int32


def chamfer_queries(B: int, N: int, sms: int) -> int:
    """csrc/chamfer.cu::chamfer_queries."""
    best, best_cost = 2, None
    for q in range(2, QMAX + 1):
        blocks = B * -(-N // (32 * q))
        cost = -(-blocks // sms) * q
        if best_cost is None or cost <= best_cost:
            best, best_cost = q, cost
    return best


@pytest.mark.parametrize("B,N,q", [(24, 1028, 3), (24, 700, 2), (1, 100, 2), (33, 1024, 4)])
def test_chamfer_launch_plan(B, N, q):
    """Queries per lane on a 132-SM card: at the recon shape, 264 blocks of
    96 queries, two on each SM; every query has a lane."""
    assert chamfer_queries(B, N, 132) == q
    assert -(-N // (32 * q)) * 32 * q >= N
    assert "for (int q = 2; q <= QMAX; ++q)" in CHAMFER_SRC
