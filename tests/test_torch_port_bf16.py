"""The PyTorch port's bf16 serving tier against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode with ``fast=True`` (KNN) and
``exact=False`` (HS reductions); the port's wrappers run their plain
versions because the tensors lie on the CPU.  All inputs come from a numpy
seed.  Tolerances, each with its reason:

* packed-key KNN: fp32 xyz distances are the same sums on both sides, so
  indices are equal; bf16 features sum their exact products in another
  order, so a distance on a truncation boundary may land in the next key:
  >= 99.9% of the indices agree, and a swapped neighbour's distance is
  within 2^-10 relative of the one it replaced;
* HS reductions (bf16 operands, fp32 accumulation): the plain versions make
  the TPU kernels' roundings, so what is left is fp32 summation order:
  1e-5 of the largest value;
* the whole bf16 forward: the JAX layers on the CPU take the XLA path, which
  forms rf from fp32 xyz and rounds the support projection to bf16 where the
  kernels keep fp32, and features differ by bf16 ulps between the two
  frameworks, which moves a few feature-space neighbours.  The heads end in
  bf16, whose ulp is 2^-8 relative.  Measured largest differences on any
  pose output: 3.9e-3 (N=128) and 2.0e-3 (N=257) against the JAX bf16
  forward, 5.5e-3 and 3.0e-3 against the port's fp32 forward, where the JAX
  bf16 forward itself is 2.9e-3 and 4.3e-3 from the port's fp32 one:
  ``FORWARD_ATOL`` = 1e-2, about 2.5 bf16 ulps of a unit-axis component.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.face_recon as jface_recon
import hspose_tpu.models.layers as jlayers
from hspose_tpu.config import default_config
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.models.hspose import eval_forward as j_eval_forward
from hspose_tpu.ops.pallas_hs_fused import hs_support_fused as j_support
from hspose_tpu.ops.pallas_hs_fused import hs_surface_fused as j_surface
from hspose_tpu.ops.pallas_hs_fused import orl_global_fused as j_orl
from hspose_tpu.ops.pallas_knn import knn_indices_pallas
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models.hspose import build_model, draw_train, eval_forward
from hspose_tpu_torch.ops import cuda_hs, cuda_hs_fused, knn
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
from hspose_tpu_torch.utils.convert import load_jax_params
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host

KNN_AGREE = 0.999
KNN_SWAP_REL = 2.0 ** -10
HS_REL = 1e-5
FORWARD_ATOL = 1e-2


def t(x):
    return torch.from_numpy(np.array(x))


def bf16_values(x):
    """numpy fp32 array of the values x takes in bf16."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def check_knn(got, want, pts, exact_sums):
    """Equal indices where both sides sum the same products in the same order;
    else agreement and near-tie swaps (see the module docstring)."""
    assert got.shape == want.shape and got.dtype == np.int32
    if exact_sums:
        np.testing.assert_array_equal(got, want)
        return
    agree = (got[..., :, None] == want[..., None, :]).any(-1).mean()
    assert agree >= KNN_AGREE, agree
    p = pts.astype(np.float64)
    d = ((p[:, :, None] - p[:, None]) ** 2).sum(-1)
    for b, i in zip(*np.nonzero((got != want).any(-1))):
        gs, ws = set(got[b, i].tolist()), set(want[b, i].tolist())
        for g, w in zip(sorted(gs - ws, key=lambda j: d[b, i, j]),
                        sorted(ws - gs, key=lambda j: d[b, i, j])):
            assert abs(d[b, i, g] - d[b, i, w]) <= KNN_SWAP_REL * d[b, i, w], (b, i)


@pytest.mark.parametrize("N,D,k", [(128, 3, 20), (257, 3, 8), (128, 3, 4),
                                   (128, 128, 20), (257, 256, 8), (257, 128, 4)])
def test_packed_knn_matches_k1_fast_and_k7(rng, N, D, k):
    """Kernel A's plain version against K1's packed-key branch (tmaj, the
    "thresh" extraction the bf16 tier runs) and K7 (lane-major): xyz in
    fp32, features in bf16, as the forward gives them."""
    if D == 3:
        pts = rng.normal(scale=0.2, size=(2, N, D)).astype(np.float32)
        jpts, tpts = jnp.asarray(pts), t(pts)
    else:
        pts = bf16_values(np.maximum(rng.normal(size=(2, N, D)), 0).astype(np.float32))
        jpts, tpts = jnp.asarray(pts).astype(jnp.bfloat16), t(pts).to(torch.bfloat16)
    k1 = np.asarray(knn_indices_pallas(jpts, k, fast=True, interpret=True))
    k7 = np.asarray(knn_indices_pallas(jpts, k, fast=True, tmaj=False, interpret=True))
    np.testing.assert_array_equal(k1, k7)  # one function, two TPU layouts
    got = knn.knn_indices_packed(tpts, k).numpy()
    check_knn(got, k1, pts, exact_sums=D == 3)
    np.testing.assert_array_equal(knn_indices_cuda(tpts, k, packed=True).numpy(), got)


@pytest.mark.parametrize("D", [3, 128])
def test_packed_knn_duplicates_and_ties(rng, D):
    """Grid values make every distance exact on both sides, with duplicated
    points and many equal keys before the index bits: ties go to the lowest
    index, column 0 (not the query itself) is dropped, and the result is
    equal to both TPU kernels'."""
    pts = (rng.integers(-4, 5, size=(2, 150, D)) / 4.0).astype(np.float32)
    pts[:, 100:110] = pts[:, 10:20]  # duplicates with a higher index
    pts[:, 5] = pts[:, 40]  # a duplicate with a lower index than its twin
    dt = (jnp.float32, torch.float32) if D == 3 else (jnp.bfloat16, torch.bfloat16)
    jpts = jnp.asarray(pts).astype(dt[0])
    want = np.asarray(knn_indices_pallas(jpts, 8, fast=True, interpret=True))
    k7 = np.asarray(knn_indices_pallas(jpts, 8, fast=True, tmaj=False, interpret=True))
    got = knn.knn_indices_packed(t(pts).to(dt[1]), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, k7)
    assert 40 in want[0, 40].tolist()  # point 40's column 0 is its twin 5


@pytest.mark.parametrize("cloud,D", [("random", 3), ("random", 128), ("grid", 3)])
def test_exact_knn_matches_k6(rng, cloud, D):
    """K6, the lane-major layout of the exact search (``tmaj=False``), is the
    function that ``knn.knn_indices`` and the ``knn`` kernel compute: equal
    indices on the grid with duplicates, where every distance is exact and
    ties go to the lowest index; near-ties elsewhere."""
    if cloud == "grid":
        pts = (rng.integers(-4, 5, size=(2, 150, D)) / 4.0).astype(np.float32)
        pts[:, 100:110] = pts[:, 10:20]
        pts[:, 5] = pts[:, 40]
    else:
        pts = rng.normal(scale=0.2, size=(2, 200, D)).astype(np.float32)
    k6 = np.asarray(knn_indices_pallas(jnp.asarray(pts), 8, tmaj=False, interpret=True))
    got = knn.knn_indices(t(pts), 8).numpy()
    check_knn(got, k6, pts, exact_sums=cloud == "grid")
    np.testing.assert_array_equal(knn_indices_cuda(t(pts), 8).numpy(), got)


def test_packed_knn_above_2048_runs_the_exact_search(rng):
    """Above N = 2048 the index does not fit the key: the JAX package runs
    the exact search there (pallas_knn.py:347-348), and so does the wrapper."""
    pts = t(rng.normal(size=(1, 2100, 3)).astype(np.float32))
    got = knn_indices_cuda(pts, 6, packed=True)
    torch.testing.assert_close(got, knn.knn_indices(pts, 6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="2048"):
        knn.knn_indices_packed(pts, 6)


def _unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def _verts_with_duplicate(rng, B, N):
    verts = rng.normal(scale=0.2, size=(B, N, 3)).astype(np.float32)
    verts[:, 7] = verts[:, 3]  # a duplicated point: its rf must be exactly 0
    return verts


def test_surface_bf16_matches_pallas(rng):
    B, N, K, s, co = 2, 257, 20, 7, 32
    verts = _verts_with_duplicate(rng, B, N)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, 3, 0] = 7
    d = _unit_dirs(rng, s * co)
    want = np.asarray(j_surface(jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(d), s,
                                co, tq=64, exact=False, interpret=True))
    got = cuda_hs_fused.hs_surface_fused(t(verts), t(idx), t(d), s, co, exact=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HS_REL * np.abs(want).max())
    rf = cuda_hs_fused._rf_fast(t(verts), t(idx))
    assert torch.all(rf[:, 3, 0] == 0)


@pytest.mark.parametrize("N,K,cin,co", [(257, 20, 64, 32), (128, 8, 128, 16)])
def test_support_bf16_matches_pallas(rng, N, K, cin, co):
    B, s = 2, 7
    feat = bf16_values(np.maximum(rng.normal(size=(B, N, cin)), 0).astype(np.float32))
    verts = _verts_with_duplicate(rng, B, N)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, 3, 0] = 7
    stdv = 1.0 / (co * (s + 1)) ** 0.5
    w = rng.uniform(-stdv, stdv, (cin, (s + 1) * co)).astype(np.float32)
    b = rng.uniform(-stdv, stdv, ((s + 1) * co,)).astype(np.float32)
    d = _unit_dirs(rng, s * co)
    want = np.asarray(j_support(jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(verts),
                                jnp.asarray(idx), jnp.asarray(w[:, co:]), jnp.asarray(b[co:]),
                                jnp.asarray(d), s, co, tq=64, exact=False, interpret=True))
    # the weights as the layer passes them: a column slice of the layer's matrix
    got = cuda_hs_fused.hs_support_fused(t(feat).to(torch.bfloat16), t(verts), t(idx),
                                         t(w)[:, co:], t(b)[co:], t(d), s, co)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=HS_REL * np.abs(want).max())


@pytest.mark.parametrize("N,K,C", [(257, 20, 128), (64, 8, 512)])
def test_orl_bf16_matches_pallas(rng, N, K, C):
    feat = bf16_values(rng.normal(size=(2, N, C)).astype(np.float32))
    idx = rng.integers(0, N, (2, N, K)).astype(np.int32)
    want = np.asarray(j_orl(jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(idx),
                            tq=64, exact=False, interpret=True))
    got = cuda_hs_fused.orl_global_fused(t(feat).to(torch.bfloat16), t(idx))
    assert got.dtype == torch.float32 and got.shape == (2, 1, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=HS_REL * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    """(JAX bf16 model, params, batch_stats, port bf16 model, port fp32
    model) with shared weights and randomised BatchNorm statistics."""
    rng = np.random.default_rng(7)
    cfg = default_config()
    jmodel = j_build_model(cfg.replace(model=dataclasses.replace(cfg.model,
                                                                 compute_dtype="bfloat16")))
    pts = rng.normal(scale=0.2, size=(2, 128, 3)).astype(np.float32)
    variables = jmodel.init({"params": jax.random.key(0), "pool": jax.random.key(1),
                             "dropout": jax.random.key(2)},
                            jnp.asarray(pts), jnp.asarray([1, 5], jnp.int32), False)
    params = jax.device_get(variables["params"])
    flat = flax.traverse_util.flatten_dict(jax.device_get(variables["batch_stats"]))
    stats = flax.traverse_util.unflatten_dict({
        k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
            else rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        for k, v in flat.items()})
    ported = []
    for dtype in ("bfloat16", "float32"):
        model = build_model(ModelConfig(compute_dtype=dtype), device="cpu")
        load_jax_params(model, params, stats)
        ported.append(model)
    return (jmodel, params, stats, *ported)


def with_serve_k(models, serve_k: int):
    """The fixture's models, or all three rebuilt with ``serve_k`` (the
    relaxed-KNN serving tier, hspose_tpu/models/face_recon.py:91-93) on the
    same weights."""
    if serve_k == 0:
        return models
    _, params, stats, *_ = models
    cfg = default_config()
    jmodel = j_build_model(cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", serve_k=serve_k)))
    ported = []
    for dtype in ("bfloat16", "float32"):
        model = build_model(ModelConfig(compute_dtype=dtype, serve_k=serve_k), device="cpu")
        load_jax_params(model, params, stats)
        ported.append(model)
    return (jmodel, params, stats, *ported)


@pytest.mark.parametrize("N,serve_k", [
    pytest.param(128, 0, id="128"), pytest.param(257, 0, id="257"),
    pytest.param(128, 16, id="128-serve_k16"), pytest.param(257, 16, id="257-serve_k16")])
def test_bf16_eval_forward_matches_jax_and_fp32(models, monkeypatch, N, serve_k):
    """The whole bf16 serving forward against the JAX package's bf16
    forward, both on packed-key KNN (the JAX CPU path would take the exact
    XLA search, so the test points its ``knn_indices_fast`` at the Pallas
    fast kernel in interpret mode), and against the port's fp32 forward;
    also with ``serve_k=16``."""
    jmodel, params, stats, model, model32 = with_serve_k(models, serve_k)
    rng = np.random.default_rng(N)
    pts = (rng.normal(scale=0.2, size=(2, N, 3)) + [0.1, -0.05, 0.6]).astype(np.float32)
    obj = np.array([1, 5], np.int32)
    perms = {N: rng.permutation(N), N // 4: rng.permutation(N // 4)}
    monkeypatch.setattr(jlayers.jax.random, "permutation",
                        lambda key, n, **kw: jnp.asarray(perms[n]))
    monkeypatch.setattr(jface_recon, "knn_indices_fast",
                        lambda p, kk, fast=False, source=None:
                        knn_indices_pallas(p, kk, fast=True, interpret=True))
    want = j_eval_forward(jmodel, params, stats, jax.random.key(3), jnp.asarray(pts),
                          jnp.asarray(obj))
    samples = [t(perms[N][:N // 4]), t(perms[N // 4][:N // 16])]
    got = eval_forward(model, t(pts), t(obj), pool_samples=samples)
    ref32 = eval_forward(model32, t(pts), t(obj), pool_samples=samples)
    for name in got._fields:
        g = getattr(got, name)
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), getattr(ref32, name).numpy(), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=name)


def test_bf16_forward_on_cpu_counts_no_launch_and_refuses_training(models, rng):
    """On CPU tensors the bf16 serving forward and a bf16 train step take
    the plain versions and count no launch; a model built without the train
    heads refuses train mode."""
    *_, model, _ = models
    pts = t(rng.normal(scale=0.2, size=(2, 128, 3)).astype(np.float32))
    counts = [(knn_indices_cuda, "launches"), (knn_indices_cuda, "packed_launches")] + [
        (w, a) for w in (cuda_hs_fused.hs_surface_fused, cuda_hs_fused.hs_support_fused,
                         cuda_hs_fused.orl_global_fused, cuda_hs.hs_surface_fwd,
                         cuda_hs.hs_surface_bwd, cuda_hs.hs_support_fwd, cuda_hs.hs_support_bwd)
        for a in ("launches", "bf16_launches")]
    before = [getattr(w, a) for w, a in counts]
    out = eval_forward(model, pts, t([0, 3]), generator=torch.Generator().manual_seed(4))
    assert all(v.dtype == torch.float32 for v in out)
    draws = draw_train(torch.Generator().manual_seed(0), 2, 128)
    model.train()
    try:
        with pytest.raises(RuntimeError, match="train heads"):
            model(pts, t([0, 3]), draws.pool_samples, draws.dropout_keep)
    finally:
        model.eval()
    cfg = HSPoseConfig(model=ModelConfig(compute_dtype="bfloat16"))
    trainer = build_model(cfg.model, device="cpu", train_heads=True)
    step = build_train_step(cfg, trainer, torch.Generator().manual_seed(1))
    metrics = step(to_device(synthetic_train_batch(2, 128, seed=5), "cpu"))
    assert np.isfinite(metrics["total_loss"]) and step.optimizer.count == 1
    assert [getattr(w, a) for w, a in counts] == before
