"""The order of work of the training path's HS surface kernels, K12 (the
forward with winners) and K15 (its backward), in
``hspose_tpu_torch/csrc/hs_surface_train.cu`` and ``hs_surface.cuh``,
against the kernels they replaced, on the CPU.

K12 now runs the reduction body it shares with the serving kernel K2: a
thread holds a channel's directions of up to eight supports (all seven at
the model's K = 20, S = 7) and updates their running maxima per neighbour,
keeping theta's raw max from k = 0 by a strict > and its k, with relu and
the winner rule applied after (a max <= 0 gives k = 0); the kernel before it
ran the neighbours once per support, on relu(theta) by a strict > from
relu(theta_0), and K2 from -FLT_MAX.  K15's drf is now summed by a lane per
query over chunks of CC columns in column order, the sums in shared memory
with the sum of the column two ahead loaded before this column's is stored
and forwarded from registers when a winner repeats, where the kernel before
it walked every column for every (query, k) row; its dd keeps the tile
partials (16 queries added in order) and adds them in tile order from 0.f,
now staged in rounds of rows.  The tests model both schedules in float32
numpy on tied inputs (coarse grids, so that many products and sums tie; all
of a query's columns won by one k; zero cotangents of either sign; a partial
last 16-query tile), for K = 8, 20 and 31, S = 3, 7 and 10 and both tiers,
and require the same bits in both and agreement with the plain versions
(``hspose_tpu_torch/ops/cuda_hs.py::hs_surface_fwd_plain``,
``hs_surface_bwd_plain``).  The kernels' own arithmetic is held to these
models on the card (``chip_smoke.py``, ``hspose_tpu_torch/tools/fp32_bits.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, cuda_hs

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
SRC = (_build.CSRC / "hs_surface_train.cu").read_text()
TQ, QB, CC = (int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
              for n in ("TQ", "QB", "CC"))
# the staged partial sum K15 shares with K9 (hs::sum_tiles_kernel)
SUM_ROWS = int(re.search(r"constexpr int SUM_ROWS = (\d+);",
                         (_build.CSRC / "hs_common.cuh").read_text()).group(1))
CHUNK = 32  # columns per chunk of the replaced backward


def fma(a, b, c):
    """fmaf on float32 arrays (the product exact in float64, one sum, then
    rounded to float32)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def theta(r, d):
    """r0 d0 + r1 d1 + r2 d2 as nvcc contracts the kernels' one expression:
    fma(r2, d2, fma(r1, d1, r0 * d0))."""
    return fma(r[..., 2], d[2], fma(r[..., 1], d[1], (r[..., 0] * d[0]).astype(F32)))


def inputs(rng, K, S, fast, B=2, N=3 * TQ + 4, co=40):
    """rf (B, N, K, 3) and dirs (3, S*Co) on coarse grids, some entries off
    them; query 0's rows all equal (every theta ties across k), query 1's
    zero (theta = 0 everywhere), query 2's row K - 1 the only nonzero one; the
    bf16 tier's operands hold bf16 values.  The last 16-query tile is part
    full (N = 52)."""
    rf = (rng.integers(-3, 4, size=(B, N, K, 3)) / 4.0).astype(F32)
    rf[:, 4::3, :, 0] += rng.normal(scale=0.2, size=rf[:, 4::3, :, 0].shape).astype(F32)
    rf[:, 0] = rf[:, 0, :1]
    rf[:, 1] = 0.0
    rf[:, 2, :-1] = 0.0
    dirs = (rng.integers(-2, 3, size=(3, S * co)) / 2.0).astype(F32)
    dirs[:, ::5] += rng.normal(scale=0.3, size=dirs[:, ::5].shape).astype(F32)
    if fast:
        rf, dirs = bf16(rf), bf16(dirs)
    return rf, dirs, co


# --------------------------------------------------------------------------- #
# K12
# --------------------------------------------------------------------------- #

def k12_parent(rf, dirs, S):
    """The replaced kernel: per (query, channel) the supports in order, each
    the max over k of relu(theta) from relu(theta_0) by a strict >, added in
    increasing s from 0.f, then / S."""
    B, N, K, _ = rf.shape
    co = dirs.shape[1] // S
    total, wins = np.zeros((B, N, co), F32), np.zeros((B, N, S * co), np.int32)
    for s in range(S):
        d = dirs[:, s * co:(s + 1) * co]
        m, kb = np.maximum(theta(rf[:, :, 0, None, :], d), F32(0)), np.zeros((B, N, co), np.int32)
        for j in range(1, K):
            v = np.maximum(theta(rf[:, :, j, None, :], d), F32(0))
            take = v > m
            m, kb = np.where(take, v, m), np.where(take, j, kb)
        wins[..., s * co:(s + 1) * co] = kb
        total = (total + m).astype(F32)
    return (total / F32(S)).astype(F32), wins


def k2_parent_rule(rf, dirs, S):
    """K2's winner rule before the shared body: a strict > from -FLT_MAX over
    relu(theta) in increasing k."""
    B, N, K, _ = rf.shape
    co = dirs.shape[1] // S
    total, wins = np.zeros((B, N, co), F32), np.zeros((B, N, S * co), np.int32)
    for s in range(S):
        d = dirs[:, s * co:(s + 1) * co]
        m, kb = np.full((B, N, co), -np.finfo(F32).max, F32), np.zeros((B, N, co), np.int32)
        for j in range(K):
            v = np.maximum(theta(rf[:, :, j, None, :], d), F32(0))
            take = v > m
            m, kb = np.where(take, v, m), np.where(take, j, kb)
        wins[..., s * co:(s + 1) * co] = kb
        total = (total + m).astype(F32)
    return (total / F32(S)).astype(F32), wins


def k12_shared_body(rf, dirs, S, sg):
    """hs_surface.cuh with winners: the supports in groups of sg held
    directions; per neighbour every held support's raw theta max, from
    k = 0 by a strict >, and its k; then per support the winner (k where the
    max is > 0, else 0) and relu of the max, added in increasing s."""
    B, N, K, _ = rf.shape
    co = dirs.shape[1] // S
    total, wins = np.zeros((B, N, co), F32), np.zeros((B, N, S * co), np.int32)
    for g0 in range(0, S, sg):
        group = range(g0, min(g0 + sg, S))
        d = {s: dirs[:, s * co:(s + 1) * co] for s in group}
        m = {s: theta(rf[:, :, 0, None, :], d[s]) for s in group}
        kb = {s: np.zeros((B, N, co), np.int32) for s in group}
        for j in range(1, K):
            r = rf[:, :, j, None, :]
            for s in group:
                v = theta(r, d[s])
                take = v > m[s]
                m[s], kb[s] = np.where(take, v, m[s]), np.where(take, j, kb[s])
        for s in group:
            wins[..., s * co:(s + 1) * co] = np.where(m[s] > 0, kb[s], 0)
            total = (total + np.maximum(m[s], F32(0))).astype(F32)
    return (total / F32(S)).astype(F32), wins


def held_supports(K, S):
    """The supports a thread holds: S where the launch unrolls (K = 20, S = 7),
    else eight at a time."""
    return S if (K, S) == (20, 7) else 8


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("S", [3, 7, 10])
@pytest.mark.parametrize("fast", [False, True])
def test_forward_schedule_keeps_the_bits(rng, K, S, fast):
    """The shared body gives the replaced K12's out bits and first-k
    winners, and so does K2's earlier rule; the plain version's winners are
    the same in the bf16 tier (the same theta bits) and tie within rounding
    in fp32, and its out agrees."""
    rf, dirs, co = inputs(rng, K, S, fast)
    want, want_win = k12_parent(rf, dirs, S)
    got, got_win = k12_shared_body(rf, dirs, S, held_supports(K, S))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_win, want_win)
    k2, k2_win = k2_parent_rule(rf, dirs, S)
    np.testing.assert_array_equal(k2, want)
    np.testing.assert_array_equal(k2_win, want_win)
    assert (got_win[:, 0] == 0).all() and (got_win[:, 1] == 0).all()  # ties and zeros: k = 0
    dt = torch.bfloat16 if fast else torch.float32
    out, win = cuda_hs.hs_surface_fwd_plain(torch.from_numpy(rf).to(dt),
                                            torch.from_numpy(dirs).to(dt), S, co)
    if fast:  # the plain version's theta is the same bits: exact products, x, y, z order
        np.testing.assert_array_equal(win.numpy(), got_win)
    else:  # rf @ d rounds elsewhere: where the winners differ, they tie to rounding
        th = np.einsum("bnkx,xc->bnkc", rf.astype(np.float64), dirs.astype(np.float64))
        at = lambda w: np.take_along_axis(np.maximum(th, 0), w[:, :, None].astype(np.int64), 2)  # noqa: E731
        np.testing.assert_allclose(at(win.numpy()), at(got_win), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), got, rtol=0, atol=1e-5 * np.abs(got).max())


# --------------------------------------------------------------------------- #
# K15
# --------------------------------------------------------------------------- #

def bwd_inputs(rng, K, S, fast, co=40):
    """The forward's inputs, winners from the shared body with query 3's
    columns all won by K - 1 and query 5's by 0, and gb (B, N, Co) on a
    coarse grid with zeros of either sign."""
    rf, dirs, co = inputs(rng, K, S, fast, co=co)
    _, win = k12_shared_body(rf, dirs, S, held_supports(K, S))
    win[:, 3], win[:, 5] = K - 1, 0
    gb = (rng.integers(-4, 5, size=rf.shape[:2] + (co,)) / 4.0
          + rng.normal(scale=0.1, size=rf.shape[:2] + (co,))).astype(F32)
    gb[:, ::3, :7] = 0.0
    gb[:, 1::4, 7:9] = -0.0
    return rf, dirs, win, gb, co


def gated(rf, dirs, win, gb, S, fast):
    """u (B, N, S*Co): gb/S where theta at the winner (the forward's
    expression) is > 0, else 0; the bf16 tier forms gb * (1/S) in fp32 and
    rounds it to bf16."""
    SC, co = dirs.shape[1], gb.shape[-1]
    g = (gb * (F32(1) / F32(S))).astype(F32) if fast else (gb / F32(S)).astype(F32)
    if fast:
        g = bf16(g)
    r = np.take_along_axis(rf, win[..., None].astype(np.int64), 2)  # (B, N, SC, 3)
    th = theta(r, dirs)
    return np.where(th > 0, g[..., np.arange(SC) % co], F32(0)).astype(F32)


def drf_parent(u, win, dirs, K):
    """The replaced walk: per (query, k) every column of every 32-column
    chunk in order, fmaf(u, d, acc) where the column's winner is k (u = 0
    columns included)."""
    B, N, SC = win.shape
    out = np.zeros((B, N, K, 3), F32)
    bi, ni = np.meshgrid(np.arange(B), np.arange(N), indexing="ij")
    for c0 in range(0, SC, CHUNK):
        for c in range(c0, min(c0 + CHUNK, SC)):
            k = win[..., c]
            out[bi, ni, k] = fmaf3(u[..., c], dirs[:, c], out[bi, ni, k])
    return out


def fmaf3(u, d, acc):
    return fma(u[..., None], d, acc)


def drf_forwarded(u, win, dirs, K):
    """The redesigned walk: a lane per query keeps its sums in (shared)
    memory, chunk by chunk of CC columns (the last padded with u = 0 at the
    last column's winner); at each column it loads the sum of the column two
    ahead before storing this column's, so that when the next column's
    winner is that of this column or of the one before, its loaded sum is
    stale and the value in registers is taken instead."""
    B, N, SC = win.shape
    mem = np.zeros((B, N, K, 3), F32)
    bi, ni = np.meshgrid(np.arange(B), np.arange(N), indexing="ij")
    for c0 in range(0, SC, CC):
        cols = [min(c, SC - 1) for c in range(c0, c0 + CC)]
        us = [u[..., c] if c < SC else np.zeros(win.shape[:2], F32) for c in range(c0, c0 + CC)]
        ks = [win[..., c] for c in cols]
        k0, k1, kprev = ks[0], ks[1], np.full(win.shape[:2], -1)
        a = mem[bi, ni, k0]
        p1, aprev = mem[bi, ni, k1], a
        for e in range(CC):
            k2 = ks[e + 2] if e + 2 < CC else k0
            p2 = mem[bi, ni, k2] if e + 2 < CC else a
            anew = fmaf3(us[e], dirs[:, cols[e]], a)
            mem[bi, ni, k0] = anew
            a = np.where((k1 == k0)[..., None], anew,
                         np.where((k1 == kprev)[..., None], aprev, p1))
            kprev, aprev, k0, k1, p1 = k0, anew, k1, k2, p2
    return mem


def dd_tiles(u, win, rf):
    """Per (batch, 16-query tile), batch-major: each column's
    fmaf(u, rf[q, win], acc) from 0.f over the tile's queries in order, u = 0
    included -> (tiles, 3, S*Co)."""
    B, N, SC = win.shape
    r = np.take_along_axis(rf, win[..., None].astype(np.int64), 2)  # (B, N, SC, 3)
    parts = []
    for b in range(B):
        for q0 in range(0, N, TQ):
            acc = np.zeros((SC, 3), F32)
            for q in range(q0, min(q0 + TQ, N)):
                acc = fma(u[b, q, :, None], r[b, q], acc)
            parts.append(acc.T)
    return np.stack(parts)


def sum_parent(parts):
    """hs::sum_partials: from 0.f, the rows added in order."""
    s = np.zeros(parts.shape[1:], F32)
    for p in parts:
        s = (s + p).astype(F32)
    return s


def sum_rounds(parts):
    """sum_tiles_kernel: the rows staged SUM_ROWS at a time, one running sum
    per column carried across the rounds, the rows of a round in order."""
    s = np.zeros(parts.shape[1:], F32)
    for p0 in range(0, len(parts), SUM_ROWS):
        for p in parts[p0:p0 + SUM_ROWS]:
            s = (s + p).astype(F32)
    return s


def check_backward(rf, dirs, win, gb, S, co, fast):
    K = rf.shape[2]
    u = gated(rf, dirs, win, gb, S, fast)
    assert (u == 0).any() and (u != 0).any()
    want, got = drf_parent(u, win, dirs, K), drf_forwarded(u, win, dirs, K)
    np.testing.assert_array_equal(got, want)
    assert not got[:, 3, :K - 1].any() and not got[:, 5, 1:].any()  # empty rows give 0
    parts = dd_tiles(u, win, rf)
    assert len(parts) == rf.shape[0] * -(-rf.shape[1] // TQ)
    dd = sum_rounds(parts)
    np.testing.assert_array_equal(dd, sum_parent(parts))
    dt = torch.bfloat16 if fast else torch.float32
    drf_p, dd_p = cuda_hs.hs_surface_bwd_plain(
        torch.from_numpy(rf).to(dt), torch.from_numpy(dirs).to(dt),
        torch.from_numpy(win), torch.from_numpy(gb), S, co)
    if fast:
        got, dd = bf16(got), bf16(dd)
    for a, p in ((got, drf_p), (dd, dd_p)):
        p = p.float().numpy()
        np.testing.assert_allclose(a, p, rtol=2.0 ** -7 if fast else 1e-5,
                                   atol=1e-5 * np.abs(p).max())


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("S", [3, 7, 10])
@pytest.mark.parametrize("fast", [False, True])
def test_backward_schedule_keeps_the_bits(rng, K, S, fast):
    """The lane-per-query walk with its forwarded sums gives the replaced
    walk's drf bits (fp32 sums in both tiers, then one rounding to bf16 in
    the bf16 tier), and dd's tile partials summed in rounds give the replaced
    partial sum's bits; both agree with the plain version."""
    rf, dirs, win, gb, co = bwd_inputs(rng, K, S, fast)
    check_backward(rf, dirs, win, gb, S, co, fast)


@pytest.mark.parametrize("co", [24, 96])
def test_backward_other_widths(rng, co):
    """Fewer output channels than a chunk's 32 columns (a chunk spans
    supports) and more (S*Co not a multiple of the chunk): the same bits."""
    rf, dirs, win, gb, co = bwd_inputs(rng, 20, 7, False, co=co)
    check_backward(rf, dirs, win, gb, 7, co, False)


def test_tiles_match_the_source():
    """dd's partial-sum unit is the replaced kernel's 16-query tile, a block
    holds whole tiles, and a block's queries and a chunk's columns are a
    warp's 32 lanes."""
    assert TQ == 16 and QB == 32 and QB % TQ == 0 and CC == 32
