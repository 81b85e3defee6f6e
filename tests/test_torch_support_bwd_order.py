"""The order of work of the training support backward (K13 and K14,
``hspose_tpu_torch/csrc/hs_support_train.cu``) against that of the kernels
it replaced, on the CPU.

The redesigned kernels must keep the fp32 bits of the kernels before them.
Their rows kernel walks each query's columns in chunks of 32 and, per
chunk, the winners k in order, where the kernel before it bucketed all of a
query's columns by winner first (a stable counting sort) and walked each
bucket; their reduction stages 4 queries at a time where the kernel before
it staged 16; the recompute reads two bf16 channels a word where the kernel
before it read one.  The tests model both schedules
in float32 numpy, for every sum the kernels form (dg, drf, dW, db, dd and
K14's projection P), on tied inputs: all of a query's columns on one k,
empty buckets, winners at k = K - 1, K = 8, 20 and 31, Cin not a multiple
of the 128-channel block and a row count that is a multiple of no tile,
and require the same bits in both, and agreement with the plain versions
(``hspose_tpu_torch/ops/cuda_hs.py``).  The kernels' own arithmetic is held
to these models on the card (``chip_smoke.py``,
``hspose_tpu_torch/tools/fp32_bits.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, cuda_hs

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
SRC = (_build.CSRC / "hs_support_train.cu").read_text()


def const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


ROWS_CC, RED_QC, RED_QS, RC_CH = (const(n) for n in ("ROWS_CC", "RED_QC", "RED_QS", "RC_CH"))
PARENT_QS, PARENT_CH = 16, 16  # the replaced kernels' stages (queries, channels)


def fma(a, b, c):
    """fmaf on float32 arrays (the product exact in float64, one sum, then
    rounded to float32): the same function in every schedule."""
    return (a.astype(np.float64) * b + c).astype(F32)


def bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def tied_inputs(rng, K, fast, rows=262, S=5, co=8, cin=132):
    """Backward inputs on coarse grids, so that many products and sums tie,
    with: query 0's columns all won by k = K - 1, query 1's all by k = 0,
    every third query's winners at K - 1 or 0 only (empty buckets between),
    theta exactly 0 at a fifth of the columns (du gated off).  fp32, or
    bf16 values (as fp32) for g, rf and dirs in the bf16 tier."""
    sc = S * co
    win = rng.integers(0, K, size=(rows, sc)).astype(np.int32)
    win[0], win[1] = K - 1, 0
    win[2::3] = np.where(rng.random((len(win[2::3]), sc)) < 0.5, K - 1, 0)
    g = (rng.integers(-4, 5, size=(rows, K, cin)) / 8.0).astype(F32)
    g[..., ::2] += rng.normal(scale=0.3, size=(rows, K, (cin + 1) // 2)).astype(F32)
    rf = rng.normal(size=(rows, K, 3)).astype(F32)
    rf /= np.linalg.norm(rf, axis=-1, keepdims=True)
    dirs = rng.normal(size=(3, sc)).astype(F32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    if fast:
        g, rf, dirs = bf16(g), bf16(rf), bf16(dirs)
    w = (rng.integers(-3, 4, size=(cin, sc)) / 16.0 + rng.normal(scale=0.05, size=(cin, sc))).astype(F32)
    b = rng.normal(scale=0.1, size=sc).astype(F32)
    twin = np.abs(rng.integers(0, 5, size=(rows, sc)) / 4.0 + rng.normal(scale=0.1, size=(rows, sc))).astype(F32)
    twin[rng.random((rows, sc)) < 0.2] = 0.0
    pwin = (rng.integers(-4, 5, size=(rows, sc)) / 4.0 + rng.normal(scale=0.1, size=(rows, sc))).astype(F32)
    gb = (rng.integers(-4, 5, size=(rows, co)) / 4.0 + rng.normal(scale=0.2, size=(rows, co))).astype(F32)
    return dict(g=g, rf=rf, dirs=dirs, w=w, b=b, win=win, twin=twin, pwin=pwin, gb=gb, S=S, co=co)


def operands(x, fast):
    """The per-(query, column) factors: (v, u, vdb) = gb/S * twin, the
    gated gb/S * pwin (both rounded to bf16 as product operands in the bf16
    tier) and the unrounded gb/S * twin that db sums; and W as dg's operand."""
    S, co = x["S"], x["co"]
    gb = np.tile(x["gb"], (1, S))  # gb[q, c % Co]
    gs = (gb * F32(1.0 / S)).astype(F32) if fast else (gb / F32(S)).astype(F32)
    v = (gs * x["twin"]).astype(F32)
    u = np.where(x["twin"] > 0, gs * x["pwin"], F32(0)).astype(F32)
    if fast:
        return bf16(v), bf16(u), v, bf16(x["w"])
    return v, u, v, x["w"]


# --------------------------------------------------------------------------- #
# rows: dg, drf
# --------------------------------------------------------------------------- #

def rows_parent(x, fast):
    """The replaced rows kernel: a query's columns sorted stably by winner,
    then each bucket's columns in order into its k's sums from 0.f."""
    v, u, _, w = operands(x, fast)
    win, dirs = x["win"], x["dirs"]
    rows, sc = win.shape
    K, cin = x["g"].shape[1:]
    order = np.argsort(win, axis=1, kind="stable")
    r = np.arange(rows)
    dg = np.zeros((rows, K, cin), F32)
    drf = np.zeros((rows, K, 3), F32)
    for p in range(sc):
        c = order[:, p]
        k = win[r, c]
        dg[r, k] = fma(v[r, c][:, None], w[:, c].T, dg[r, k])
        drf[r, k] = fma(u[r, c][:, None], dirs[:, c].T, drf[r, k])
    return dg, drf


def rows_kernel(x, fast):
    """The redesigned rows kernel: chunks of ROWS_CC columns in order; per
    chunk, for k = 0 .. K-1, the chunk's columns that k wins (the ballot's
    bits, in lane order) into k's sums, carried from chunk to chunk (drf's
    lanes walk the same columns after dg, in the same order)."""
    v, u, _, w = operands(x, fast)
    win, dirs = x["win"], x["dirs"]
    rows, sc = win.shape
    K, cin = x["g"].shape[1:]
    dg = np.zeros((rows, K, cin), F32)
    drf = np.zeros((rows, K, 3), F32)
    for c0 in range(0, sc, ROWS_CC):
        for k in range(K):
            for c in range(c0, min(c0 + ROWS_CC, sc)):
                sel = win[:, c] == k
                if sel.any():
                    dg[sel, k] = fma(v[sel, c][:, None], w[None, :, c], dg[sel, k])
                    drf[sel, k] = fma(u[sel, c][:, None], dirs[None, :, c], drf[sel, k])
    return dg, drf


# --------------------------------------------------------------------------- #
# reduction: dW, db, dd
# --------------------------------------------------------------------------- #

def reduce_schedule(x, fast, qs):
    """dW, db, dd as the reduction kernels form them: per chunk of RED_QC
    queries, stages of qs queries in order, each query's winning g row and
    rf row into the column's sums from 0.f; then the chunks' partial sums
    added in chunk order from 0.f (hs::sum_partials)."""
    v, u, vdb, _ = operands(x, fast)
    g, rf, win = x["g"], x["rf"], x["win"]
    rows, sc = win.shape
    partials = []
    for qa in range(0, rows, RED_QC):
        qb = min(rows, qa + RED_QC)
        dw = np.zeros((g.shape[2], sc), F32)
        db = np.zeros(sc, F32)
        dd = np.zeros((3, sc), F32)
        for q0 in range(qa, qb, qs):
            for q in range(q0, min(q0 + qs, qb)):
                dw = fma(v[q][None, :], g[q, win[q]].T, dw)
                db = (db + vdb[q]).astype(F32)
                dd = fma(u[q][None, :], rf[q, win[q], :].T, dd)
        partials.append(np.concatenate([dw, db[None], dd]))
    total = np.zeros_like(partials[0])
    for p in partials:
        total = (total + p).astype(F32)
    return total[:-4], total[-4], total[-3:]


# --------------------------------------------------------------------------- #
# K14's recompute: P and theta at the winners
# --------------------------------------------------------------------------- #

def theta(r, d):
    """relu(r0 d0 + r1 d1 + r2 d2) as nvcc contracts the forward's
    expression: fma(r2, d2, fma(r1, d1, r0 * d0))."""
    return np.maximum(fma(r[..., 2], d[2], fma(r[..., 1], d[1], (r[..., 0] * d[0]).astype(F32))), 0)


def recompute_schedule(x, fast, ch, per_word):
    """P = fmaf(g[q, win, i], W[i, c], acc) from 0.f over channel stages of
    ch (per_word channels read per word, in order), then + b; theta at the
    winner."""
    g, w, win = x["g"], (bf16(x["w"]) if fast else x["w"]), x["win"]
    rows, sc = win.shape
    cin = g.shape[2]
    gw = g[np.arange(rows)[:, None], win]  # (rows, SC, Cin): each column's winning row
    acc = np.zeros((rows, sc), F32)
    for i0 in range(0, cin, ch):
        for word in range(i0, min(i0 + ch, cin), per_word):
            for i in range(word, word + per_word):
                acc = fma(gw[..., i], w[i][None, :], acc)
    p = (acc + x["b"][None, :]).astype(F32)
    th = theta(x["rf"][np.arange(rows)[:, None], win], x["dirs"][:, None, :])
    return th, p


def to_torch(x, fast):
    """The plain versions' arguments: (B=2, N, ...) tensors in the tier's dtypes."""
    dt = torch.bfloat16 if fast else torch.float32
    rows = x["win"].shape[0]

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).reshape(2, rows // 2, *a.shape[1:]).to(dtype)

    return (t(x["g"], dt), t(x["rf"], dt), torch.from_numpy(x["w"]), torch.from_numpy(x["b"]),
            torch.from_numpy(x["dirs"]).to(dt), t(x["win"], torch.int32), t(x["twin"]),
            t(x["pwin"]), t(x["gb"]))


def assert_close(got, want, fast_out, what):
    """got (the model's fp32 sums) against the plain version's output: within
    1e-5 of the largest value, more one bf16 ulp where the output is bf16
    (the plain version sums in another order before its one rounding)."""
    want = want.float().numpy().reshape(got.shape)
    slack = 1e-5 * np.abs(want).max()
    if fast_out:
        got = bf16(got)
        slack = slack + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= slack), what


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("fast", [False, True])
def test_rows_schedule_keeps_the_bits(rng, K, fast):
    """Chunks of 32 columns walked winner by winner give the bucket-sorted
    schedule's dg and drf bits, on tied inputs; both agree with the plain
    version."""
    x = tied_inputs(rng, K, fast)
    want_dg, want_drf = rows_parent(x, fast)
    got_dg, got_drf = rows_kernel(x, fast)
    np.testing.assert_array_equal(got_dg, want_dg)
    np.testing.assert_array_equal(got_drf, want_drf)
    assert not got_dg[0, :K - 1].any() and not got_dg[1, 1:].any()  # empty buckets give 0
    args = to_torch(x, fast)
    dg, drf, *_ = cuda_hs.hs_support_bwd_plain(*args[:3], args[4], *args[5:], x["S"], x["co"])
    assert_close(got_dg, dg, fast, "dg")
    assert_close(got_drf, drf, fast, "drf")


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("fast", [False, True])
def test_reduction_schedule_keeps_the_bits(rng, K, fast):
    """Stages of RED_QS queries within each RED_QC-query chunk give the
    16-query stages' dW, db and dd bits; both agree with the plain version."""
    x = tied_inputs(rng, K, fast)
    want = reduce_schedule(x, fast, PARENT_QS)
    got = reduce_schedule(x, fast, RED_QS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    args = to_torch(x, fast)
    _, _, dw, db, dd = cuda_hs.hs_support_bwd_plain(*args[:3], args[4], *args[5:], x["S"], x["co"])
    assert_close(got[0], dw, False, "dW")
    assert_close(got[1], db, False, "db")
    assert_close(got[2], dd, fast, "dd")


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("fast", [False, True])
def test_recompute_schedule_keeps_the_bits(rng, K, fast):
    """Channel stages of RC_CH, two bf16 channels a word in the bf16 tier,
    give the replaced kernel's P and theta bits (16-channel stages, one
    channel a read); both match the forward's plain values at the winners."""
    x = tied_inputs(rng, K, fast)
    want_th, want_p = recompute_schedule(x, fast, PARENT_CH, 1)
    got_th, got_p = recompute_schedule(x, fast, RC_CH, 2 if fast else 1)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_th, want_th)
    g, rf, w, b, dirs, win, *_ = to_torch(x, fast)
    at = win.long()[:, :, None]
    proj = (g.float() @ cuda_hs._operand(w, fast) + b).gather(2, at).squeeze(2)
    th = cuda_hs._theta(rf, dirs).gather(2, at).squeeze(2)
    assert_close(got_p, proj, False, "P")
    assert_close(got_th, th, False, "theta")


def test_order_constants_match_the_source():
    """The association that fixes dW, db and dd is the 128-query chunk, and
    the rows kernel's chunk is a warp's 32 lanes."""
    assert RED_QC == 128 and ROWS_CC == 32
    assert const("ROWS_CS") % 4 == 0 and RC_CH % 4 == 0
