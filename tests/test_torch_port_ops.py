"""The PyTorch port's neighbour ops and the plain versions of its CUDA kernels
against the JAX package, on the CPU, at narrow widths.

The JAX Pallas kernels run in interpret mode (``exact=True`` for the HS
kernels, whose bf16-split operands carry ~1e-5 relative error,
pallas_hs_fused.py:19-27: tolerance 1e-4 of the largest value); the XLA
formulas are compared at 1e-5 of the largest value (fp32 summation order).
The port's kernel wrappers run their plain versions here because the tensors
lie on the CPU.  All inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hspose_tpu.ops import knn as jknn
from hspose_tpu.ops.pallas_hs import hs_support_reduce as j_support_reduce
from hspose_tpu.ops.pallas_hs import hs_surface_reduce as j_surface_reduce
from hspose_tpu.ops.pallas_hs_fused import hs_support_fused as j_support
from hspose_tpu.ops.pallas_hs_fused import hs_surface_fused as j_surface
from hspose_tpu.ops.pallas_hs_fused import orl_global_fused as j_orl
from hspose_tpu.ops.pallas_knn import knn_indices_pallas
from hspose_tpu_torch.ops import _build, cuda_hs, cuda_hs_fused, knn
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda

torch.set_num_threads(2)  # the suite runs several workers on one host


def t(x):
    return torch.from_numpy(np.array(x))


def assert_near_ties(got, want, pts, tol):
    """Index rows agree; where a row's sets differ, the float64 distances of
    the swapped neighbours agree within ``tol`` (tests/test_pallas_knn.py)."""
    d = ((pts[:, :, None].astype(np.float64) - pts[:, None].astype(np.float64)) ** 2).sum(-1)
    assert got.shape == want.shape
    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            gs, ws = set(got[b, i].tolist()), set(want[b, i].tolist())
            for g, w in zip(sorted(gs - ws), sorted(ws - gs)):
                assert abs(d[b, i, g] - d[b, i, w]) < tol, (b, i)


@pytest.mark.parametrize("D,tol", [(3, 1e-4), (16, 1e-3), (128, 1e-3)])
def test_knn_matches_pallas(rng, D, tol):
    pts = rng.normal(size=(2, 200, D)).astype(np.float32)
    want = np.asarray(knn_indices_pallas(jnp.asarray(pts), 10, tq=64, interpret=True))
    got = knn.knn_indices(t(pts), 10)
    assert got.dtype == torch.int32
    assert_near_ties(got.numpy(), want, pts, tol)


def test_knn_duplicates_and_ties_exact(rng):
    """Grid points make every distance exact in fp32 on both sides, with many
    exact ties and duplicated points: tie-break to the lowest index and the
    column-0 drop (not a self drop) must match exactly."""
    pts = (rng.integers(-4, 5, size=(2, 150, 3)) / 4.0).astype(np.float32)
    pts[:, 100:110] = pts[:, 10:20]  # duplicates with a higher index
    pts[:, 5] = pts[:, 40]  # a duplicate with a lower index than its twin
    want = np.asarray(knn_indices_pallas(jnp.asarray(pts), 8, tq=64, interpret=True))
    np.testing.assert_array_equal(knn.knn_indices(t(pts), 8).numpy(), want)
    np.testing.assert_array_equal(knn_indices_cuda(t(pts), 8).numpy(), want)
    # column 0 of point 40's k+1 list is its lower-index twin 5, so the drop
    # removes the twin and point 40 lists itself
    assert 40 in want[0, 40].tolist()


def test_knn_matches_xla(rng):
    pts = rng.normal(size=(2, 120, 32)).astype(np.float32)
    want = np.asarray(jknn.knn_indices(jnp.asarray(pts), 12))
    assert_near_ties(knn.knn_indices(t(pts), 12).numpy(), want, pts, 1e-3)


def test_pairwise_and_nearest_index(rng):
    a = rng.normal(scale=0.2, size=(2, 90, 3)).astype(np.float32)
    b = rng.normal(scale=0.2, size=(2, 40, 3)).astype(np.float32)
    want = np.asarray(jknn.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b)))
    got = knn.pairwise_sq_dist(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        knn.nearest_index(t(a), t(b)).numpy(),
        np.asarray(jknn.nearest_index(jnp.asarray(a), jnp.asarray(b))))


def test_gather_and_directions(rng):
    verts = rng.normal(scale=0.2, size=(2, 60, 3)).astype(np.float32)
    verts[:, 7] = verts[:, 3]  # a duplicated point
    idx = rng.integers(0, 60, (2, 60, 9)).astype(np.int32)
    idx[:, 3, 0] = 7
    feat = rng.normal(size=(2, 60, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        knn.gather_neighbors(t(feat), t(idx)).numpy(),
        np.asarray(jknn.gather_neighbors(jnp.asarray(feat), jnp.asarray(idx))))
    want = np.asarray(jknn.neighbor_directions_normalized(jnp.asarray(verts),
                                                          jnp.asarray(idx)))
    got = knn.neighbor_directions_normalized(t(verts), t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[:, 3, 0] == 0.0)  # rf of a duplicated point is exactly 0


def _unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def test_surface_matches_pallas_and_xla(rng):
    B, N, K, s, co = 2, 200, 8, 3, 32
    verts = rng.normal(scale=0.2, size=(B, N, 3)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    d = _unit_dirs(rng, s * co)
    got = cuda_hs_fused.hs_surface_fused(t(verts), t(idx), t(d), s, co).numpy()
    want = np.asarray(j_surface(jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(d),
                                s, co, tq=64, exact=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    rf = jknn.neighbor_directions_normalized(jnp.asarray(verts), jnp.asarray(idx))
    theta = jax.nn.relu(jnp.einsum("bnkd,ds->bnks", rf, jnp.asarray(d)))
    xla = np.asarray(jnp.mean(jnp.max(theta.reshape(B, N, K, s, co), axis=2), axis=2))
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5 * np.abs(xla).max())


def test_support_matches_pallas_and_xla(rng):
    B, N, K, cin, s, co = 2, 200, 10, 32, 3, 64
    feat = rng.normal(size=(B, N, cin)).astype(np.float32)
    verts = rng.normal(scale=0.2, size=(B, N, 3)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    w = (rng.normal(size=(cin, s * co)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(s * co,)) * 0.1).astype(np.float32)
    d = _unit_dirs(rng, s * co)
    got = cuda_hs_fused.hs_support_fused(t(feat), t(verts), t(idx), t(w), t(b), t(d),
                                         s, co).numpy()
    jargs = [jnp.asarray(a) for a in (feat, verts, idx, w, b, d)]
    want = np.asarray(j_support(*jargs, s, co, tq=64, exact=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the XLA formula, gather first (hspose_tpu/models/layers.py:301-317)
    rf = jknn.neighbor_directions_normalized(jargs[1], jargs[2])
    g = jknn.gather_neighbors(jargs[0], jargs[2])
    theta = jax.nn.relu(jnp.einsum("bnkd,ds->bnks", rf, jargs[5]))
    proj = jnp.einsum("bnki,is->bnks", g, jargs[3], precision="highest") + jargs[4]
    prod = (theta * proj).reshape(B, N, K, s, co)
    xla = np.asarray(jnp.mean(jnp.max(prod, axis=2), axis=2))
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5 * np.abs(xla).max())


def test_orl_matches_pallas_and_xla(rng):
    B, N, K, C = 2, 200, 10, 64
    feat = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    got = cuda_hs_fused.orl_global_fused(t(feat), t(idx)).numpy()
    assert got.shape == (B, 1, C)
    want = np.asarray(j_orl(jnp.asarray(feat), jnp.asarray(idx), tq=64, exact=True,
                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    xla = np.asarray(jnp.mean(jnp.max(jknn.gather_neighbors(
        jnp.asarray(feat), jnp.asarray(idx)), axis=2), axis=1, keepdims=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5 * np.abs(xla).max())


def test_support_weight_column_slice(rng):
    """The layer passes W[:, Co:] of the (Cin, (S+1)Co) matrix, a strided view."""
    B, N, K, cin, s, co = 1, 50, 6, 16, 2, 8
    feat = t(rng.normal(size=(B, N, cin)).astype(np.float32))
    verts = t(rng.normal(size=(B, N, 3)).astype(np.float32))
    idx = t(rng.integers(0, N, (B, N, K)).astype(np.int32))
    w_full = t(rng.normal(size=(cin, (s + 1) * co)).astype(np.float32))
    b = t(rng.normal(size=(s * co,)).astype(np.float32))
    d = t(_unit_dirs(rng, s * co))
    a = cuda_hs_fused.hs_support_fused(feat, verts, idx, w_full[:, co:], b, d, s, co)
    c = cuda_hs_fused.hs_support_fused(feat, verts, idx, w_full[:, co:].contiguous(),
                                       b, d, s, co)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    pts = t(rng.normal(size=(1, 40, 3)).astype(np.float32))
    idx = knn_indices_cuda(pts, 5)
    feat = t(rng.normal(size=(1, 40, 8)).astype(np.float32))
    before = (knn_indices_cuda.launches, cuda_hs_fused.orl_global_fused.launches,
              cuda_hs_fused.hs_surface_fused.launches,
              cuda_hs_fused.hs_support_fused.launches)
    torch.testing.assert_close(idx, knn.knn_indices(pts, 5))
    torch.testing.assert_close(cuda_hs_fused.orl_global_fused(feat, idx),
                               cuda_hs_fused.orl_global_plain(feat, idx))
    after = (knn_indices_cuda.launches, cuda_hs_fused.orl_global_fused.launches,
             cuda_hs_fused.hs_surface_fused.launches,
             cuda_hs_fused.hs_support_fused.launches)
    assert before == after


def test_wrappers_refuse_other_devices_and_bad_inputs():
    meta = torch.empty((1, 40, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        knn_indices_cuda(meta, 5)
    with pytest.raises(ValueError):
        _build.on_cpu(torch.zeros(2), meta)
    with pytest.raises(TypeError):
        _build.check(torch.zeros((2, 3), dtype=torch.float64), "x", torch.float32, (2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        _build.check(torch.zeros((3, 2)).t(), "x", torch.float32, (2, 3))
    with pytest.raises(ValueError, match="shape"):
        _build.check(torch.zeros((2, 4)), "x", torch.float32, (2, 3))


def test_build_is_lazy_and_named_by_source_hash():
    """Importing builds nothing; the library name follows the sources."""
    assert _build._lib is None
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libhspose_kernels-") and path.suffix == ".so"
    assert {p.name for p in _build._sources()} >= {
        "knn.cu", "hs_surface.cu", "hs_support.cu", "orl.cu", "hs_surface_train.cu",
        "hs_support_train.cu"}


# --------------------------------------------------------------------------- #
# training kernels: the plain versions of K11-K13 and K15 through their
# autograd Functions, against hspose_tpu/ops/pallas_hs.py in interpret mode
# (exact=True, bwd_store=True) and jax.grad; atol 2e-4 as
# tests/test_pallas_hs.py:118-146 (bf16x3 splits inside the Pallas kernels)
# --------------------------------------------------------------------------- #

def _unit_rows(rng, shape):
    rf = rng.normal(size=shape).astype(np.float32)
    return rf / np.linalg.norm(rf, axis=-1, keepdims=True)


def _support_inputs(rng, B, N, K, cin, s, co, dup: bool):
    g = rng.normal(size=(B, N, K, cin)).astype(np.float32)
    rf = _unit_rows(rng, (B, N, K, 3))
    if dup:  # duplicated points: rf = 0, theta = 0 for every support, ties at 0
        rf[:, ::3, : K // 2] = 0.0
        g[:, ::5, 1] = g[:, ::5, 0]
    w = rng.normal(scale=0.2, size=(cin, s * co)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(s * co,)).astype(np.float32)
    d = rng.normal(size=(3, s * co)).astype(np.float32)
    cot = rng.normal(size=(B, N, co)).astype(np.float32)
    return g, rf, w, b, d, cot


def _torch_grads(fn, args, cot):
    ts = [t(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    (out * t(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in ts]


@pytest.mark.parametrize("dup", [False, True])
def test_support_reduce_function_matches_pallas(rng, dup):
    B, N, K, cin, s, co = 2, 60, 6, 32, 3, 16
    g, rf, w, b, d, cot = _support_inputs(rng, B, N, K, cin, s, co, dup)

    def loss(g, rf, w, b, d):
        out = j_support_reduce(g, rf, w, b, d, s, co, tq=32, interpret=True,
                               bwd_store=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (g, rf, w, b, d)))
    got, grads = _torch_grads(lambda *a: cuda_hs.hs_support_reduce(*a, s, co),
                              (g, rf, w, b, d), cot)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)
    for name, gt, gj in zip(["dg", "drf", "dw", "db", "dd"], grads, jgrads):
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=0, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("dup", [False, True])
def test_surface_reduce_function_matches_pallas(rng, dup):
    B, N, K, s, co = 2, 50, 5, 4, 8
    rf = _unit_rows(rng, (B, N, K, 3))
    if dup:
        rf[:, ::3, :3] = 0.0
        rf[:, 1::4] = 0.0  # every neighbour a duplicate: all thetas tie at 0
    d = rng.normal(size=(3, s * co)).astype(np.float32)
    cot = rng.normal(size=(B, N, co)).astype(np.float32)

    def loss(r, d):
        out = j_surface_reduce(r, d, s, co, tq=32, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rf), jnp.asarray(d))
    got, grads = _torch_grads(lambda *a: cuda_hs.hs_surface_reduce(*a, s, co), (rf, d), cot)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)
    for name, gt, gj in zip(["drf", "dd"], grads, jgrads):
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=0, atol=2e-4, err_msg=name)


def test_training_kernels_route_ties_to_the_first_k(rng):
    """Equal products at several k: the plain forward records the first and
    the backward sends the whole cotangent there (torch.amax would split it)."""
    B, N, K, cin, s, co = 1, 4, 5, 4, 1, 4
    g = np.ones((B, N, K, cin), np.float32)
    rf = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (B, N, K, 1))
    w = np.ones((cin, s * co), np.float32)
    b = np.zeros(s * co, np.float32)
    d = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, s * co))
    out, win, twin, pwin = cuda_hs.hs_support_fwd_plain(*(t(a) for a in (g, rf, w, b, d)),
                                                        s, co)
    assert win.dtype == torch.int32 and int(win.abs().max()) == 0
    np.testing.assert_allclose(out.numpy(), 4.0)
    gb = torch.ones((B, N, co))
    dg, drf, dw, db, dd = cuda_hs.hs_support_bwd_plain(
        *(t(a) for a in (g, rf, w, d)), win, twin, pwin, gb, s, co)
    assert float(dg[:, :, 1:].abs().max()) == 0.0 and float(dg[:, :, 0].min()) > 0
    _, swin = cuda_hs.hs_surface_fwd_plain(t(rf), t(d), s, co)
    assert int(swin.abs().max()) == 0


def test_training_wrappers_count_no_launch_on_cpu(rng):
    B, N, K, cin, s, co = 1, 20, 4, 8, 2, 4
    g, rf, w, b, d, cot = _support_inputs(rng, B, N, K, cin, s, co, False)
    wrappers = (cuda_hs.hs_surface_fwd, cuda_hs.hs_surface_bwd, cuda_hs.hs_support_fwd,
                cuda_hs.hs_support_bwd)
    before = [f.launches for f in wrappers]
    _torch_grads(lambda *a: cuda_hs.hs_support_reduce(*a, s, co), (g, rf, w, b, d), cot)
    _torch_grads(lambda *a: cuda_hs.hs_surface_reduce(*a, s, co), (rf, d), cot)
    assert [f.launches for f in wrappers] == before


def test_surface_function_returns_no_rf_grad_unless_asked(rng):
    rf = t(_unit_rows(rng, (1, 10, 4, 3)))
    d = t(rng.normal(size=(3, 8)).astype(np.float32)).requires_grad_(True)
    cuda_hs.hs_surface_reduce(rf, d, 2, 4).sum().backward()
    assert rf.grad is None and d.grad is not None


@pytest.mark.parametrize("name", ["hs_surface_fused", "hs_support_fused", "orl_global_fused"])
def test_serving_wrappers_refuse_inputs_that_require_grad(rng, name):
    """The serving kernels have no backward: with grad on, an input that
    requires grad raises on either device instead of returning a result cut
    from the graph; under no_grad the same call runs."""
    N, K, cin, s, co = 30, 4, 8, 2, 4
    verts = t(rng.normal(size=(1, N, 3)).astype(np.float32))
    idx = knn.knn_indices(verts, K)
    feat = t(rng.normal(size=(1, N, cin)).astype(np.float32))
    w = t(rng.normal(size=(cin, s * co)).astype(np.float32))
    b = t(np.zeros(s * co, np.float32))
    d = t(_unit_dirs(rng, s * co))
    fn = getattr(cuda_hs_fused, name)
    args, leaf = {"hs_surface_fused": ((verts, idx, d, s, co), d),
                  "hs_support_fused": ((feat, verts, idx, w, b, d, s, co), feat),
                  "orl_global_fused": ((feat, idx), feat)}[name]
    leaf.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        assert torch.isfinite(fn(*args)).all()
