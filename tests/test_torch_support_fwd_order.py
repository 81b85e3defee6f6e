"""The order of work of K11's redesigned forward and of K8's redesigned
walks (``hspose_tpu_torch/csrc/hs_support_train.cu``, ``hs_project.cuh``,
``hs_fused_bwd.cuh``, ``hs_support.cu``) against the kernels they replaced,
on the CPU.

K11 now projects each source row once (the GEMM tile of ``hs_project.cuh``,
which pads the input channels to its 16-deep k tiles with zeros) and gathers
the projections by the neighbour index, where the kernel before it projected
every gathered row; the reduction keeps the expression of theta, the winner
rule ``k == 0 || v > m`` and the order of the supports.  K8's drfn sums
(``rf_grad_kernel``) and the bf16 tier's dg rows (``dg_rows_kernel``) now
walk each query's columns in chunks of 32, k by k from a mask, leaving out
the columns whose operand is 0, where the kernels before them walked all
columns serially (drfn) or bucketed them by winner first (dg).  The tests model both schedules in float32 numpy (fp64
for the bf16 tier's sums) on tied inputs (coarse grids, so that many
products and sums tie; repeated and duplicate neighbour indices; all of a
query's columns on one k; a partial last chunk), for K = 8, 20 and 31 and
Cin = 132, and require the same bits in both and agreement with the plain
versions (``hspose_tpu_torch/ops/cuda_hs.py``, ``ops/cuda_hs_fused.py``).
The kernels' own arithmetic is held to these models on the card
(``chip_smoke.py``, ``hspose_tpu_torch/tools/fp32_bits.py``).
"""

import re

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import _build, cuda_hs

torch.set_num_threads(2)  # the suite runs several workers on one host

F32 = np.float32
TILE = (_build.CSRC / "hs_project.cuh").read_text()
PK, PK64 = (int(re.search(rf"{n} = (\d+);", TILE).group(1)) for n in ("PK", "PK64"))
CHUNK = 32  # columns per ballot: a warp's lanes


def fma(a, b, c):
    """fmaf on float32 arrays (the product exact in float64, one sum, then
    rounded to float32)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def theta(r, d):
    """relu(r0 d0 + r1 d1 + r2 d2) as nvcc contracts the kernels' expression
    (the same in both schedules): fma(r2, d2, fma(r1, d1, r0 * d0))."""
    return np.maximum(fma(r[..., 2], d[2], fma(r[..., 1], d[1], (r[..., 0] * d[0]).astype(F32))), 0)


# --------------------------------------------------------------------------- #
# K11: project the source rows, then gather
# --------------------------------------------------------------------------- #

def fwd_inputs(rng, K, fast, B=2, N=131, S=5, co=8, cin=132):
    """Forward inputs on coarse grids: query 0's neighbours all one source
    row, query 1's two rows repeated, a feature row of zeros (all its
    products tie at 0), theta exactly 0 at some (query, k)."""
    feat = (rng.integers(-4, 5, size=(B, N, cin)) / 8.0).astype(F32)
    feat[..., ::3] += rng.normal(scale=0.3, size=(B, N, (cin + 2) // 3)).astype(F32)
    feat[:, 5] = 0.0
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    idx[:, 0] = 7
    idx[:, 1] = np.where(np.arange(K) % 2 == 0, 5, 9)
    idx[:, 2, : K // 2] = idx[:, 2, K // 2: 2 * (K // 2)]  # duplicates
    rf = rng.normal(size=(B, N, K, 3)).astype(F32)
    rf /= np.linalg.norm(rf, axis=-1, keepdims=True)
    rf[:, 3, ::2] = 0.0  # a duplicated point: rf = 0, theta = 0
    dirs = rng.normal(size=(3, S * co)).astype(F32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    if fast:
        feat, rf, dirs = bf16(feat), bf16(rf), bf16(dirs)
    w = (rng.integers(-3, 4, size=(cin, S * co)) / 16.0
         + rng.normal(scale=0.05, size=(cin, S * co))).astype(F32)
    b = rng.normal(scale=0.1, size=S * co).astype(F32)
    return dict(feat=feat, idx=idx, rf=rf, dirs=dirs, w=w, b=b, S=S, co=co)


def project(rows, w, b, pad_to):
    """P = fmaf(row[i], W[i, c], acc) from 0.f over i in order, the channels
    padded with zeros to a multiple of pad_to (the tile's k depth), then + b."""
    cin = rows.shape[-1]
    padded = -(-cin // pad_to) * pad_to
    rows = np.concatenate([rows, np.zeros(rows.shape[:-1] + (padded - cin,), F32)], -1)
    w = np.concatenate([w, np.zeros((padded - cin, w.shape[1]), F32)])
    acc = np.zeros(rows.shape[:-1] + (w.shape[1],), F32)
    for i in range(padded):
        acc = fma(rows[..., i, None], w[i], acc)
    return (acc + b).astype(F32)


def reduce(P, x):
    """out, win, twin, pwin from P (B, N, K, S*Co) at each (query, k): theta
    by the kernels' expression, the first maximal k by k == 0 || v > m, the
    supports' maxima added in order from 0.f, then / S."""
    S, co, K = x["S"], x["co"], P.shape[2]
    th = theta(x["rf"][..., None, :], x["dirs"])
    v = (th * P).astype(F32)
    m, win = v[:, :, 0], np.zeros(v[:, :, 0].shape, np.int32)
    tw, pw = th[:, :, 0], P[:, :, 0]
    for k in range(1, K):
        take = v[:, :, k] > m
        m, win = np.where(take, v[:, :, k], m), np.where(take, k, win)
        tw, pw = np.where(take, th[:, :, k], tw), np.where(take, P[:, :, k], pw)
    total = np.zeros(m.shape[:2] + (co,), F32)
    for s in range(S):
        total = (total + m[..., s * co:(s + 1) * co]).astype(F32)
    return (total / F32(S)).astype(F32), win, tw, pw, v


def gather(feat, idx):
    return feat[np.arange(feat.shape[0])[:, None, None], idx]


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("fast", [False, True])
def test_forward_schedule_keeps_the_bits(rng, K, fast):
    """Projecting the source rows once (padded to either tile's depth),
    then gathering, gives the replaced kernel's out, win, twin and pwin bits
    (every gathered row projected, unpadded); both agree with the plain
    version on g = feat[idx]."""
    x = fwd_inputs(rng, K, fast)
    w = bf16(x["w"]) if fast else x["w"]  # the bf16 tier's W operand
    g = gather(x["feat"], x["idx"])
    want = reduce(project(g, w, x["b"], 1), x)
    got = reduce(gather(project(x["feat"], w, x["b"], PK), x["idx"]), x)
    for a, b_, what in zip(got, want, ("out", "win", "twin", "pwin", "theta * P")):
        np.testing.assert_array_equal(a, b_, err_msg=what)
    deep = gather(project(x["feat"], w, x["b"], PK64), x["idx"])  # the 64 x 64 tile's depth
    np.testing.assert_array_equal(reduce(deep, x)[0], want[0])
    dt = torch.bfloat16 if fast else torch.float32
    out, win, tw, pw = cuda_hs.hs_support_fwd_plain(
        torch.from_numpy(g).to(dt), torch.from_numpy(x["rf"]).to(dt), torch.from_numpy(x["w"]),
        torch.from_numpy(x["b"]), torch.from_numpy(x["dirs"]).to(dt), x["S"], x["co"])
    np.testing.assert_allclose(got[0], out.numpy(), rtol=0, atol=1e-5 * np.abs(got[0]).max())
    same = got[1] == win.numpy()  # elsewhere the two winners are near-ties
    v = got[4]
    at = lambda w_: np.take_along_axis(v, w_[:, :, None], 2)[:, :, 0]  # noqa: E731
    np.testing.assert_allclose(at(got[1]), at(win.numpy()), rtol=0, atol=1e-5 * np.abs(v).max())
    for a, b_ in ((got[2], tw), (got[3], pw)):
        np.testing.assert_allclose(a[same], b_.numpy()[same], rtol=0, atol=1e-5 * np.abs(a).max())


def test_forward_tile_depth_matches_the_source():
    """The model pads to the tiles' k depths, which the GEMM keeps in shared
    memory 16 (128 x 128 tile) and 32 (64 x 64 tile) rows deep."""
    assert (PK, PK64) == (16, 32)


# --------------------------------------------------------------------------- #
# K8: drfn (rf_grad_kernel) and the bf16 dg rows (dg_rows_kernel)
# --------------------------------------------------------------------------- #

def walk_inputs(rng, K, rows=262, sc=40, cin=132):
    """Per (query, column): the winner (query 0's all at K - 1, query 1's all
    at 0, every third query's at 0 or K - 1 only), dz and dproj on coarse
    grids, zero (either sign) at a fifth of the columns; dirs (3, S*Co);
    W (Cin, S*Co)."""
    win = rng.integers(0, K, size=(rows, sc)).astype(np.int32)
    win[0], win[1] = K - 1, 0
    win[2::3] = np.where(rng.random((len(win[2::3]), sc)) < 0.5, K - 1, 0)
    val = (rng.integers(-4, 5, size=(rows, sc)) / 4.0
           + rng.normal(scale=0.1, size=(rows, sc))).astype(F32)
    val[rng.random((rows, sc)) < 0.2] = 0.0
    val[rng.random((rows, sc)) < 0.05] = -0.0
    dirs = rng.normal(size=(3, sc)).astype(F32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    w = (rng.integers(-3, 4, size=(cin, sc)) / 16.0
         + rng.normal(scale=0.05, size=(cin, sc))).astype(F32)
    return win, val, dirs, w


def walk_serial(win, val, mat, K, fast):
    """out[q, k, :] = the sum of val[q, c] * mat[:, c] over the columns c that
    k wins, in increasing c (a stable bucket sort walks them so too): fp32
    fused multiply-adds, or (fast) fp64 sums of the bf16 operands' exact
    products."""
    rows, sc = win.shape
    out = np.zeros((rows, K, mat.shape[0]), np.float64 if fast else F32)
    r = np.arange(rows)
    for c in range(sc):
        k = win[:, c]
        if fast:
            out[r, k] += bf16(val[:, c]).astype(np.float64)[:, None] * bf16(mat[:, c])[None]
        else:
            out[r, k] = fma(val[:, c][:, None], mat[:, c][None], out[r, k])
    return out


def walk_chunked(win, val, mat, K, fast):
    """The redesigned walk: chunks of 32 columns in order; per chunk and k,
    the mask's columns in lane (column) order into k's sums, leaving out
    the columns whose operand is 0 (a sum from +0 is never -0, so adding
    +-0 changes nothing)."""
    rows, sc = win.shape
    out = np.zeros((rows, K, mat.shape[0]), np.float64 if fast else F32)
    op = bf16(val) if fast else val
    for c0 in range(0, sc, CHUNK):
        for k in range(K):
            for c in range(c0, min(c0 + CHUNK, sc)):
                sel = (win[:, c] == k) & (op[:, c] != 0)
                if not sel.any():
                    continue
                if fast:
                    out[sel, k] += (bf16(val[sel, c]).astype(np.float64)[:, None]
                                    * bf16(mat[:, c])[None])
                else:
                    out[sel, k] = fma(val[sel, c][:, None], mat[:, c][None], out[sel, k])
    return out


def onehot(win, val, K):
    """(rows, K, S*Co) with val at each column's winner, 0 elsewhere."""
    x = np.zeros(win.shape[:1] + (K,) + win.shape[1:], F32)
    np.put_along_axis(x, win[:, None], val[:, None], 1)
    return x


@pytest.mark.parametrize("K", [8, 20, 31])
@pytest.mark.parametrize("fast", [False, True])
def test_rf_grad_walk_keeps_the_bits(rng, K, fast):
    """drfn by chunks of 32 columns, k by k from ballots, gives the serial
    column walk's bits (fp32, and the bf16 tier's fp64 sums); both agree
    with the plain versions' product dz d^T."""
    win, dz, dirs, _ = walk_inputs(rng, K)
    want = walk_serial(win, dz, dirs, K, fast)
    got = walk_chunked(win, dz, dirs, K, fast)
    np.testing.assert_array_equal(got, want)
    assert not got[0, :K - 1].any() and not got[1, 1:].any()  # empty buckets give 0
    dzk = torch.from_numpy(onehot(win, bf16(dz) if fast else dz, K))
    d = torch.from_numpy(bf16(dirs) if fast else dirs)
    if fast:  # ops/cuda_hs_fused.py::_fused_bwd_fast: fp64 product, rounded to fp32 once
        plain = (dzk.double() @ d.double().t()).float().numpy()
        np.testing.assert_array_equal(got.astype(F32), plain)
    else:  # hs_surface_fused_bwd_plain / hs_support_fused_bwd_plain: dz @ d^T
        plain = (dzk @ d.t()).numpy()
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("K", [8, 20, 31])
def test_dg_rows_walk_keeps_the_bits(rng, K):
    """The bf16 tier's dg rows by chunks of 32 columns give the bucketed
    walk's fp64 sums, and so after the roundings (to fp32, then bf16) the
    same rows; both equal the plain version's row
    (``_support_fused_bwd_fast``: bf16(float(bf16(dproj) bf16(W)^T)) in
    fp64)."""
    win, dproj, _, w = walk_inputs(rng, K)
    want = bf16(walk_serial(win, dproj, w, K, True).astype(F32))
    got = bf16(walk_chunked(win, dproj, w, K, True).astype(F32))
    np.testing.assert_array_equal(got, want)
    dp = torch.from_numpy(bf16(onehot(win, dproj, K)))
    plain = (dp.double() @ torch.from_numpy(bf16(w)).double().t()).float()
    np.testing.assert_array_equal(got, plain.to(torch.bfloat16).float().numpy())
