"""The order of work of the ORL kernel (``hspose_tpu_torch/csrc/orl.cu``) and
the HS surface kernel (``csrc/hs_surface.cu``) against that of the kernels
they replaced, on the CPU.

Both kernels must keep the fp32 bits of the kernels before them.  The ORL
kernel now holds a slice of Cs channels of one cloud in shared memory and
runs (32-point tile, 16-byte vector) items side by side, where the kernel
before it ran one block per tile and a second launch over the tiles; the
surface kernel now updates the S maxima of a channel per neighbour, where
the kernel before it ran the neighbours once per support.  The tests model
both schedules in float32 numpy, on clouds with tied values and duplicated
neighbours, and require the same bits and the same first-k winners (a
strict > from -FLT_MAX in increasing k).  The kernels' own arithmetic is
held to these models on the card (``chip_smoke.py``,
``hspose_tpu_torch/tools/fp32_bits.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, cuda_hs_fused as f

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
NEG = np.finfo(np.float32).max * F32(-1)  # -FLT_MAX
TQ = 32  # points per tile of the ORL sums (csrc/orl.cu)


def tied_features(rng, B, N, C, fast):
    """Features on a coarse grid, so that many maxima tie across k, and
    off it at every other entry, so that the sums round; bf16 values (as
    fp32) in the bf16 tier."""
    x = rng.integers(-4, 5, size=(B, N, C)) / 8.0
    x[..., ::2] += rng.normal(scale=0.3, size=(B, N, (C + 1) // 2))
    x = torch.from_numpy(x.astype(F32))
    return (x.to(torch.bfloat16).float() if fast else x).numpy()


def tied_index(rng, B, N, K):
    """Neighbour lists with duplicated entries (a duplicated point's twin
    appears twice) and repeated rows."""
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    idx[:, :, K // 2] = idx[:, :, 0]
    idx[:, 1::7] = idx[:, 0:1]
    return idx


def update(m, kb, x, j, win):
    """One step of the max over k: fmaxf, or with winners a strict >."""
    if win:
        upd = x > m
        return np.where(upd, x, m), np.where(upd, j, kb)
    return np.fmax(m, x), kb


# --------------------------------------------------------------------------- #
# ORL
# --------------------------------------------------------------------------- #

def orl_parent(feat, idx, win):
    """The replaced kernel: one block per (tile, batch), a thread per channel
    adds its maxima in point order from 0.f into partial[b, tile, c]; a
    second launch adds the tiles in order from 0.f and divides by N."""
    B, N, C = feat.shape
    K = idx.shape[2]
    bi = np.arange(B)[:, None]
    partial, wins = [], np.zeros((B, N, C), np.int32)
    for q0 in range(0, N, TQ):
        s = np.zeros((B, C), F32)
        for q in range(q0, min(q0 + TQ, N)):
            m, kb = np.full((B, C), NEG, F32), np.zeros((B, C), np.int32)
            for j in range(K):
                m, kb = update(m, kb, feat[bi, idx[:, q, j][:, None], np.arange(C)], j, win)
            wins[:, q] = kb
            s = s + m
        partial.append(s)
    total = np.zeros((B, C), F32)
    for s in partial:
        total = total + s
    return total / F32(N), wins


def orl_kernel(feat, idx, cs, elem, win):
    """The redesigned kernel: one block per (slice of cs channels, batch)
    stages feat[b, :, c0:c0+cs] as rows of 16-byte vectors; its threads are
    (tile, vector) items, run here side by side as the block runs them: each
    walks its tile's points in order, takes the max over k of its vector's
    channels from the staged rows and adds it to its sum from 0.f; the tile
    sums go to shared memory, and one thread per channel adds them in tile
    order from 0.f and divides by N."""
    B, N, C = feat.shape
    K = idx.shape[2]
    vec = 16 // elem
    Q, tiles = cs // vec, -(-N // TQ)
    items = np.arange(tiles * Q)
    tile, v = items // Q, items % Q
    bi = np.arange(B)[:, None]
    out, wins = np.empty((B, C), F32), np.zeros((B, N, C), np.int32)
    for c0 in range(0, C, cs):
        srow = np.ascontiguousarray(feat[:, :, c0:c0 + cs]).reshape(B, N, Q, vec)
        s = np.zeros((B, items.size, vec), F32)
        for t in range(TQ):
            q = tile * TQ + t
            live = q < N
            qc = np.minimum(q, N - 1)
            m = np.full((B, items.size, vec), NEG, F32)
            kb = np.zeros((B, items.size, vec), np.int32)
            for j in range(K):
                m, kb = update(m, kb, srow[bi, idx[:, qc, j], v], j, win)
            s = np.where(live[None, :, None], s + m, s)
            cols = c0 + v[live, None] * vec + np.arange(vec)
            wins[:, q[live, None], cols] = kb[:, live]
        tsum = np.empty((B, tiles, cs), F32)
        tsum[:, tile[:, None], v[:, None] * vec + np.arange(vec)] = s
        total = np.zeros((B, cs), F32)
        for tl in range(tiles):
            total = total + tsum[:, tl]
        out[:, c0:c0 + cs] = total / F32(N)
    return out, wins


def widths(C, elem):
    """Every slice width the kernel takes for C channels: 16 to 128 bytes."""
    return [row // elem for row in (128, 64, 32, 16) if C % (row // elem) == 0]


# conv_0/1, conv_2/3, conv_4 at N = 1028; conv_0/1 at the harness's N = 2056;
# a K the kernel reads at run time and a part tile
ORL_SHAPES = [(1028, 128, 20), (257, 256, 20), (64, 512, 8), (2056, 128, 20), (33, 256, 5)]


@pytest.mark.parametrize("N,C,K", ORL_SHAPES)
@pytest.mark.parametrize("fast", [False, True])
def test_orl_kernel_schedule_keeps_the_bits(rng, N, C, K, fast):
    """Under every slice width, the redesigned schedule gives the replaced
    kernel's bits and first-k winners, on tied features and duplicated
    neighbours; the maxima are those of the plain version."""
    B = 2
    feat, idx = tied_features(rng, B, N, C, fast), tied_index(rng, B, N, K)
    want, want_win = orl_parent(feat, idx, win=True)
    serve, _ = orl_parent(feat, idx, win=False)
    np.testing.assert_array_equal(serve, want)
    elem = 2 if fast else 4
    for cs in widths(C, elem):
        got, got_win = orl_kernel(feat, idx, cs, elem, win=True)
        np.testing.assert_array_equal(got, want, err_msg=f"cs={cs}")
        np.testing.assert_array_equal(got_win, want_win, err_msg=f"cs={cs}")
        np.testing.assert_array_equal(orl_kernel(feat, idx, cs, elem, win=False)[0], want)
    ft, it = torch.from_numpy(feat), torch.from_numpy(idx)
    plain, plain_win = f.orl_global_fused_fwd_plain(ft, it)
    np.testing.assert_array_equal(plain_win.numpy(), want_win)
    np.testing.assert_allclose(plain[:, 0].numpy(), want, rtol=1e-6, atol=1e-7)


def test_orl_tile_matches_the_source():
    """The kernel's first sum runs over the replaced kernel's 32-point
    tiles, the unit the models here use."""
    src = (_build.CSRC / "orl.cu").read_text()
    assert int(re.search(r"constexpr int TQ = (\d+);", src).group(1)) == TQ


def test_orl_wrapper_refuses_what_the_kernel_cannot_hold(monkeypatch):
    """On the CPU the plain version runs at any N; where the kernel refuses
    a shape on the card, the error names its limits and the shape."""
    feat = torch.ones((1, 16000, 8))
    idx = torch.zeros((1, 16000, 2), dtype=torch.int32)
    assert f.orl_global_fused(feat, idx).shape == (1, 1, 8)

    def refused(name, *args):
        raise RuntimeError(f"{name}: CUDA error 1")

    monkeypatch.setattr(f._build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(f._build, "launch", refused)
    with pytest.raises(RuntimeError, match=r"hs_orl: CUDA error 1; .*227 KB.*\(1, 16000, 8\)"):
        f.orl_global_fused(feat, idx)
    with pytest.raises(RuntimeError, match=r"hs_orl_win: CUDA error 1; .*14087"):
        f.orl_global_fused_fwd(feat, idx)


# --------------------------------------------------------------------------- #
# HS surface
# --------------------------------------------------------------------------- #

def theta(r, d):
    """r0 d0 + r1 d1 + r2 d2 as one chain of fused multiply-adds (each fma
    formed in float64 from fp32 operands, then rounded): the same function
    in both schedules."""
    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(F32)
    return fma(r[..., 2], d[2], fma(r[..., 1], d[1], r[..., 0] * d[0]))


def surface_parent(rf, dirs, S, win):
    """The replaced kernel: per (query, channel) the supports in order, each
    running the max over k (from 0.f, or with winners from -FLT_MAX on
    relu(theta) by strict >), added in increasing s, then / S."""
    B, N, K, _ = rf.shape
    co = dirs.shape[1] // S
    total = np.zeros((B, N, co), F32)
    wins = np.zeros((B, N, S * co), np.int32)
    for s in range(S):
        d = dirs[:, s * co:(s + 1) * co]
        m = np.full((B, N, co), NEG if win else F32(0), F32)
        kb = np.zeros((B, N, co), np.int32)
        for j in range(K):
            th = theta(rf[:, :, j, None, :], d)
            m, kb = update(m, kb, np.fmax(th, F32(0)) if win else th, j, win)
        wins[..., s * co:(s + 1) * co] = kb
        total = total + m
    return total / F32(S), wins


def surface_kernel(rf, dirs, S, sg, win):
    """The redesigned kernel: a thread holds the directions of sg supports
    at a time (sg = S when they all fit), reads each neighbour's rf row once
    and updates the running max of every support it holds; the maxima are
    added in increasing s after each group, then / S."""
    B, N, K, _ = rf.shape
    co = dirs.shape[1] // S
    total = np.zeros((B, N, co), F32)
    wins = np.zeros((B, N, S * co), np.int32)
    for g0 in range(0, S, sg):
        group = range(g0, min(g0 + sg, S))
        d = {s: dirs[:, s * co:(s + 1) * co] for s in group}
        m = {s: np.full((B, N, co), NEG if win else F32(0), F32) for s in group}
        kb = {s: np.zeros((B, N, co), np.int32) for s in group}
        for j in range(K):
            r = rf[:, :, j, None, :]
            for s in group:
                th = theta(r, d[s])
                m[s], kb[s] = update(m[s], kb[s], np.fmax(th, F32(0)) if win else th, j, win)
        for s in group:
            total = total + m[s]
            wins[..., s * co:(s + 1) * co] = kb[s]
    return total / F32(S), wins


def tied_rf(rng, B, N, K):
    """Unit directions of a cloud with duplicated points (rf = 0 exactly, so
    every theta of that neighbour is 0 and ties with relu's zeros) and
    coordinates on a coarse grid."""
    pts = torch.from_numpy((rng.integers(-3, 4, size=(B, N, 3)) / 4.0).astype(F32))
    pts[:, N // 2:N // 2 + 8] = pts[:, 0:8]
    idx = torch.from_numpy(tied_index(rng, B, N, K))
    return f.neighbor_directions_normalized(pts, idx).numpy()


@pytest.mark.parametrize("K", [20, 12, 7])
@pytest.mark.parametrize("S,sg", [(7, 7), (10, 8), (3, 8)])
@pytest.mark.parametrize("win", [False, True])
def test_surface_kernel_schedule_keeps_the_bits(rng, S, sg, win, K):
    """Neighbours outermost with S running maxima (in groups of sg held
    supports) give the replaced kernel's bits and first-k winners; the
    serving and winner-recording outputs are the same bits."""
    B, N, co = 2, 96, 8
    rf = tied_rf(rng, B, N, K)
    dirs = (rng.integers(-2, 3, size=(3, S * co)) / 2.0).astype(F32)
    want, want_win = surface_parent(rf, dirs, S, win)
    got, got_win = surface_kernel(rf, dirs, S, sg, win)
    np.testing.assert_array_equal(got, want)
    if win:
        np.testing.assert_array_equal(got_win, want_win)
        np.testing.assert_array_equal(got, surface_kernel(rf, dirs, S, sg, False)[0])
    plain = sum(np.maximum(np.einsum("bnkx,xc->bnkc", rf, dirs[:, s * co:(s + 1) * co]), 0)
                .max(2) for s in range(S)) / S
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
