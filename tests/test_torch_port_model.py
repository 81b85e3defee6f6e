"""The PyTorch port's fp32 serving forward against the JAX package on the CPU.

The JAX model and its variables are built once for the module; the BatchNorm
statistics are randomised so BN is not the identity, and the weights reach
the port through ``load_jax_params``.  Pooling is pinned: JAX's permutation is
replaced by a numpy-seeded one and the same kept rows go to the port as
``pool_samples``.  Tolerances are fp32 summation-order noise growing with
depth: 2e-4 at N=128, 5e-4 at N=1028 (as tests/test_torch_parity.py).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.layers as jlayers
from hspose_tpu.config import default_config
from hspose_tpu.geometry.rotations import generate_RT as j_generate_RT
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.models.hspose import eval_forward as j_eval_forward
from hspose_tpu.ops.knn import knn_indices as j_knn
from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.geometry.rotations import generate_RT
from hspose_tpu_torch.models import layers
from hspose_tpu_torch.models.hspose import build_model, draw_pool_samples, eval_forward
from hspose_tpu_torch.ops import cuda_hs_fused
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
from hspose_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)  # the suite runs several workers on one host
REPO = Path(__file__).resolve().parents[1]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    """(jax model, params, batch_stats, port model) with shared weights."""
    rng = np.random.default_rng(7)
    jmodel = j_build_model(default_config())
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
    model = build_model(ModelConfig(), device="cpu")
    load_jax_params(model, params, stats)
    return jmodel, params, stats, model


def _pin_jax_pooling(monkeypatch, perms):
    monkeypatch.setattr(jlayers.jax.random, "permutation",
                        lambda key, n, **kw: jnp.asarray(perms[n]))


def with_serve_k(models, serve_k: int):
    """The fixture's models, or both rebuilt with ``serve_k`` (the relaxed-KNN
    serving tier, hspose_tpu/models/face_recon.py:91-93) on the same weights."""
    if serve_k == 0:
        return models
    jmodel, params, stats, _ = models
    cfg = default_config()
    jmodel = j_build_model(cfg.replace(model=dataclasses.replace(cfg.model, serve_k=serve_k)))
    model = build_model(ModelConfig(serve_k=serve_k), device="cpu")
    load_jax_params(model, params, stats)
    return jmodel, params, stats, model


@pytest.mark.parametrize("N,atol,serve_k", [
    pytest.param(128, 2e-4, 0, id="128-0.0002"), pytest.param(1028, 5e-4, 0, id="1028-0.0005"),
    pytest.param(128, 2e-4, 16, id="128-0.0002-serve_k16"),
    pytest.param(1028, 5e-4, 16, id="1028-0.0005-serve_k16")])
def test_eval_forward_and_pose_match_jax(models, monkeypatch, N, atol, serve_k):
    jmodel, params, stats, model = with_serve_k(models, serve_k)
    rng = np.random.default_rng(N)
    pts = (rng.normal(scale=0.2, size=(2, N, 3)) + [0.1, -0.05, 0.6]).astype(np.float32)
    obj = np.array([1, 5], np.int32)
    sym = np.array([[0, 1, 0, 0], [1, 1, 0, 0]], np.float32)
    perms = {N: rng.permutation(N), N // 4: rng.permutation(N // 4)}
    _pin_jax_pooling(monkeypatch, perms)

    want = j_eval_forward(jmodel, params, stats, jax.random.key(3), jnp.asarray(pts),
                          jnp.asarray(obj))
    want_RT = j_generate_RT(want.p_green_R, want.p_red_R, want.f_green_R,
                            want.f_red_R, want.pred_T, jnp.asarray(sym))
    samples = [t(perms[N][:N // 4]), t(perms[N // 4][:N // 16])]
    got = eval_forward(model, t(pts), t(obj), pool_samples=samples)
    got_RT = generate_RT(got.p_green_R, got.p_red_R, got.f_green_R, got.f_red_R,
                         got.pred_T, t(sym))
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got_RT.numpy(), np.asarray(want_RT), rtol=0, atol=atol)


def test_generate_RT_matches_jax(rng):
    B = 16
    g = rng.normal(size=(B, 3)).astype(np.float32)
    r = rng.normal(size=(B, 3)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    fg, fr = rng.uniform(0.05, 1, B).astype(np.float32), rng.uniform(0.05, 1, B).astype(np.float32)
    T = rng.normal(size=(B, 3)).astype(np.float32)
    sym = np.zeros((B, 4), np.float32)
    sym[::2, 0] = 1
    want = np.asarray(j_generate_RT(*(jnp.asarray(a) for a in (g, r, fg, fr, T, sym))))
    got = generate_RT(*(t(a) for a in (g, r, fg, fr, T, sym))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    R = got[:, :3, :3]
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def _layer_inputs(rng, n=200, k=10, c=128):
    verts = rng.normal(scale=0.2, size=(2, n, 3)).astype(np.float32)
    feat = np.maximum(rng.normal(size=(2, n, c)), 0).astype(np.float32)
    idx = np.asarray(j_knn(jnp.asarray(verts), k))
    rf_idx = np.asarray(j_knn(jnp.asarray(feat), k))
    return verts, feat, idx, rf_idx


def test_hs_layer_surface_matches_jax(models, rng):
    _, params, _, model = models
    verts, _, idx, _ = _layer_inputs(rng)
    jl = jlayers.HSLayerSurface(128, 7)
    want = np.asarray(jl.apply({"params": params["face_recon"]["conv_0"]},
                               jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(idx)))
    with torch.no_grad():
        got = model.face_recon.conv_0(t(verts), t(idx), t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_hs_layer_matches_jax(models, rng):
    _, params, _, model = models
    verts, feat, idx, rf_idx = _layer_inputs(rng)
    jl = jlayers.HSLayer(128, 128, 7)
    want = np.asarray(jl.apply({"params": params["face_recon"]["conv_1"]},
                               jnp.asarray(verts), jnp.asarray(feat),
                               jnp.asarray(rf_idx), jnp.asarray(idx)))
    with torch.no_grad():
        got = model.face_recon.conv_1(t(verts), t(feat), t(rf_idx), t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_orl_global_and_pool_layer_match_jax(monkeypatch, rng):
    verts, feat, idx, _ = _layer_inputs(rng, n=120, k=4, c=32)
    want = np.asarray(jlayers.orl_global(jnp.asarray(feat), jnp.asarray(idx)))
    got = layers.orl_global(t(feat), t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    perm = rng.permutation(120)
    _pin_jax_pooling(monkeypatch, {120: perm})
    jv, jf = jlayers.pool_layer(jax.random.key(0), jnp.asarray(verts), jnp.asarray(feat),
                                jnp.asarray(idx))
    v, f = layers.pool_layer(t(verts), t(feat), t(idx), t(perm[:30]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def test_forward_on_cpu_counts_no_launch_and_draws_pools(models, rng):
    *_, model = models
    pts = t(rng.normal(scale=0.2, size=(2, 128, 3)).astype(np.float32))
    wrappers = (knn_indices_cuda, cuda_hs_fused.hs_surface_fused,
                cuda_hs_fused.hs_support_fused, cuda_hs_fused.orl_global_fused)
    before = [w.launches for w in wrappers]
    a = eval_forward(model, pts, t([0, 3]), generator=torch.Generator().manual_seed(4))
    b = eval_forward(model, pts, t([0, 3]), generator=torch.Generator().manual_seed(4))
    assert [w.launches for w in wrappers] == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    s1, s2 = draw_pool_samples(1028, torch.Generator().manual_seed(0), device="cpu")
    assert s1.shape == (257,) and s2.shape == (64,)
    assert len(set(s1.tolist())) == 257 and int(s2.max()) < 257


def test_build_model_tiers():
    torch.backends.cuda.matmul.allow_tf32 = True
    build_model(ModelConfig(), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    model = build_model(ModelConfig(compute_dtype="bfloat16"), device="cpu")
    assert model.face_recon.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(compute_dtype="f32x2"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the entry points on a machine "
                                                      "without CUDA")
def test_entry_points_run_on_the_card_unless_asked():
    """With no device named, ``build_model`` and ``draw_pool_samples`` go to
    the CUDA card: without one they raise instead of handing back CPU
    tensors.  A generator names its own device."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ModelConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        draw_pool_samples(1028)
    samples = draw_pool_samples(1028, torch.Generator().manual_seed(0))
    assert all(s.device.type == "cpu" for s in samples)


def test_load_jax_params_is_strict(models):
    _, params, stats, _ = models
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(build_model(ModelConfig(), device="cpu"), extra, stats)
    missing = {k: v for k, v in params.items() if k != "rot_red"}
    with pytest.raises(ValueError, match="rot_red"):
        load_jax_params(build_model(ModelConfig(), device="cpu"), missing, stats)


def test_port_imports_neither_jax_nor_hspose_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hspose_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hspose_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('models.hspose', 'ops.cuda_hs', 'engine.train_step', "
        "'engine.optimizer', 'losses.recon_loss', 'data.augment', 'utils.synthetic'):\n"
        "    assert 'hspose_tpu_torch.' + m in sys.modules, m\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
