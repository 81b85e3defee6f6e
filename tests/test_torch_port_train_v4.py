"""The port's fp32 training routes of ``bwd_store=False`` (K11 without
winner values, then K14) and ``train_v4_small=True`` (the fused ops'
backwards K8, K10, and K9 beside them) against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode with ``exact=True``; their
bf16-split operands carry about 1e-5 relative error
(pallas_hs_fused.py:19-27), the port computes in fp32.  The port's wrappers
run their plain versions because the tensors lie on the CPU.  The layer
and step tests send the JAX layers down their TPU route (``kernel_route``:
``hspose_tpu.models.layers`` sees a ``jax`` whose ``devices()`` report a
TPU, and the kernels it imports at call time run in interpret mode).  All
inputs come from numpy seeds.

Tolerances, each with its reason:

* kernels: outputs and every cotangent within ``ATOL`` = 2e-4 (the bf16
  splits, as tests/test_torch_port_ops.py), of values scaled to about 1;
  dverts, whose rf chain divides by neighbour distances of about 0.1, within
  2e-4 of its largest value;
* K14 against K13 (both plain, same forward): within 1e-6 of each
  cotangent's largest value (the same values in the same order);
* one layer on the kernel route: the output and every parameter's and the
  input features' cotangent within ``LAYER_REL`` = 1e-4 of the largest value
  (the splits, summed through the layer's products);
* six train steps: the gates of tests/test_torch_port_train.py::
  test_train_step_matches_jax_for_six_steps_and_skips_nan.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.layers as jlayers
import hspose_tpu.ops.pallas_hs as jpallas
import hspose_tpu.ops.pallas_hs_fused as jfused
from hspose_tpu.config import default_config
from hspose_tpu.engine.train_step import build_train_step as j_build_train_step
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, OptimConfig
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models import layers
from hspose_tpu_torch.models.hspose import build_model, draw_train, train_forward
from hspose_tpu_torch.models.layers import HSLayer
from hspose_tpu_torch.ops import cuda_hs, cuda_hs_fused
from hspose_tpu_torch.utils.convert import load_jax_params, port_name
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch
from test_torch_port_train import N, Pinned, _flat, train_batch
from test_torch_port_train_bf16 import _ReportsTPU

torch.set_num_threads(2)  # the suite runs several workers on one host

ATOL = 2e-4
LAYER_REL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def kernel_route(monkeypatch):
    """The JAX layers on their TPU training route, every kernel they import
    at call time in interpret mode."""
    monkeypatch.setattr(jlayers, "jax", _ReportsTPU(jax))
    for mod, names in ((jpallas, ("hs_support_reduce", "hs_surface_reduce")),
                       (jfused, ("hs_support_fused", "orl_global_fused"))):
        for name in names:
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def spy_layers(monkeypatch) -> list:
    """Record each reduction ``models/layers.py`` calls, with its N (and,
    for K11's caller, ``store``), and run it."""
    seen = []

    def spy(name, real):
        def fn(x, *a, **kw):
            seen.append((name, x.shape[1], kw.get("store", True)) if name == "reduce"
                        else (name, x.shape[1]))
            return real(x, *a, **kw)
        return fn

    for attr, name in (("hs_support_reduce", "reduce"), ("hs_support_fused", "fused"),
                       ("hs_surface_reduce", "surface"), ("orl_global_plain", "orl_plain"),
                       ("orl_global_fused", "orl_fused")):
        monkeypatch.setattr(layers, attr, spy(name, getattr(layers, attr)))
    return seen


def port_vjp(fn, args, cot):
    """Output and the cotangent of every float input of ``fn`` (CPU path)."""
    ts = [t(a) for a in args]
    for x in ts:
        x.requires_grad_(x.is_floating_point())
    out = fn(*ts)
    (out * t(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in ts if x.is_floating_point()]


def assert_close(name, got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= atol, f"{name}: {err:.3e} > {atol:.3e}"


# --------------------------------------------------------------------------- #
# K14: HSSupportReduce without stored winner values
# --------------------------------------------------------------------------- #

def _support_inputs(rng, Bk, Nk, K, cin, s, co, dup: bool):
    g = rng.normal(size=(Bk, Nk, K, cin)).astype(np.float32)
    rf = rng.normal(size=(Bk, Nk, K, 3)).astype(np.float32)
    rf /= np.linalg.norm(rf, axis=-1, keepdims=True)
    if dup:  # duplicated points: rf = 0, theta = 0 for every support, ties at 0
        rf[:, ::3, : K // 2] = 0.0
        g[:, ::5, 1] = g[:, ::5, 0]
    w = rng.normal(scale=0.2, size=(cin, s * co)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(s * co,)).astype(np.float32)
    d = rng.normal(size=(3, s * co)).astype(np.float32)
    cot = rng.normal(size=(Bk, Nk, co)).astype(np.float32)
    return g, rf, w, b, d, cot


@pytest.mark.parametrize("dup", [False, True])
def test_support_recompute_backward_matches_pallas_and_k13(rng, dup):
    Bk, Nk, K, cin, s, co = 2, 60, 6, 32, 3, 16
    g, rf, w, b, d, cot = _support_inputs(rng, Bk, Nk, K, cin, s, co, dup)

    def loss(*a):
        out = jpallas.hs_support_reduce(*a, s, co, tq=32, exact=True, interpret=True,
                                        bwd_store=False)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(
        *(jnp.asarray(a) for a in (g, rf, w, b, d)))
    got, grads = port_vjp(lambda *a: cuda_hs.hs_support_reduce(*a, s, co, store=False),
                          (g, rf, w, b, d), cot)
    assert_close("out", got, want, ATOL)
    for name, gt, gj in zip(("dg", "drf", "dw", "db", "dd"), grads, jgrads):
        assert_close(name, gt, gj, ATOL)

    # K14 against K13 from the same forward
    ts = [t(a) for a in (g, rf, w, b, d)]
    out, win, twin, pwin = cuda_hs.hs_support_fwd_plain(*ts, s, co)
    out2, win2 = cuda_hs.hs_support_fwd(*ts, s, co, store=False)
    assert torch.equal(out, out2) and torch.equal(win, win2)
    gb = t(cot)
    k13 = cuda_hs.hs_support_bwd_plain(ts[0], ts[1], ts[2], ts[4], win, twin, pwin, gb, s, co)
    k14 = cuda_hs.hs_support_bwd_recompute(*ts, win, gb, s, co)
    for name, a, c in zip(("dg", "drf", "dw", "db", "dd"), k14, k13):
        assert_close(name, a, c, 1e-6 * float(c.abs().max()))


def test_recompute_route_is_fp32_only(rng):
    """Once fp32 only, the recompute route takes the bf16 tier too: a bf16
    ``store=False`` call returns finite cotangents in its operands' dtypes,
    and a bf16 model with either flag or both builds and takes a train
    forward and backward on the CPU (tests/test_torch_port_train_v4_bf16.py
    holds them to the JAX package)."""
    g, rf, w, b, d, cot = _support_inputs(rng, 1, 10, 4, 8, 2, 4, False)
    ts = [t(a) for a in (g, rf, w, b, d)]
    for i in (0, 1, 4):
        ts[i] = ts[i].to(torch.bfloat16)
    for x in ts:
        x.requires_grad_(True)
    (cuda_hs.hs_support_reduce(*ts, 2, 4, store=False) * t(cot)).sum().backward()
    assert [x.grad.dtype for x in ts] == [x.dtype for x in ts]
    assert all(torch.isfinite(x.grad.float()).all() for x in ts)
    batch = to_device(synthetic_train_batch(2, N, seed=2), "cpu")
    for kw in ({"bwd_store": False}, {"train_v4_small": True},
               {"bwd_store": False, "train_v4_small": True}):
        cfg = ModelConfig(compute_dtype="bfloat16", **kw)
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu", train_heads=True).train()
        total, _ = train_forward(HSPoseConfig(model=cfg), model, batch,
                                 draws=draw_train(torch.Generator().manual_seed(0), 2, N))
        total.backward()
        assert torch.isfinite(total)
        assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


# --------------------------------------------------------------------------- #
# K8, K9, K10: the fused ops' VJPs
# --------------------------------------------------------------------------- #

def _cloud(rng, Bk, Nk, K, dup: bool):
    """Vertices and random neighbour indices; with ``dup`` point 7 duplicates
    point 3 and is 3's first neighbour, so that rf is exactly 0 there."""
    verts = rng.normal(scale=0.2, size=(Bk, Nk, 3)).astype(np.float32)
    idx = rng.integers(0, Nk, (Bk, Nk, K)).astype(np.int32)
    if dup:
        verts[:, 7] = verts[:, 3]
        idx[:, 3, 0] = 7
    return verts, idx


def _unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


# ragged: N = 45 is no multiple of the JAX tiles (32, 128)
CASES = {"ragged": (45, 7, False), "dup": (64, 6, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_support_vjp_matches_pallas(rng, case):
    Nk, K, dup = CASES[case]
    Bk, cin, s, co = 2, 16, 3, 8
    verts, idx = _cloud(rng, Bk, Nk, K, dup)
    feat = rng.normal(size=(Bk, Nk, cin)).astype(np.float32)
    w = rng.normal(scale=0.2, size=(cin, s * co)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(s * co,)).astype(np.float32)
    d = _unit_dirs(rng, s * co)
    cot = rng.normal(size=(Bk, Nk, co)).astype(np.float32)

    def loss(feat, verts, w, b, d):
        out = jfused.hs_support_fused(feat, verts, jnp.asarray(idx), w, b, d, s, co,
                                      exact=True, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(
        *(jnp.asarray(a) for a in (feat, verts, w, b, d)))
    got, grads = port_vjp(lambda f, v, i, w_, b_, d_: cuda_hs_fused.hs_support_fused(
        f, v, i, w_, b_, d_, s, co), (feat, verts, idx, w, b, d), cot)
    assert_close("out", got, want, ATOL)
    for name, gt, gj in zip(("dfeat", "dverts", "dw", "db", "dd"), grads, jgrads):
        gj = np.asarray(gj)
        assert_close(name, gt, gj, ATOL * (np.abs(gj).max() if name == "dverts" else 1.0))
    if dup:  # the duplicate's neighbour passes nothing to the query centre or the source
        assert np.all(np.isfinite(grads[1]))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_surface_vjp_matches_pallas(rng, case):
    Nk, K, dup = CASES[case]
    Bk, s, co = 2, 4, 8
    verts, idx = _cloud(rng, Bk, Nk, K, dup)
    d = _unit_dirs(rng, s * co)
    cot = rng.normal(size=(Bk, Nk, co)).astype(np.float32)

    def loss(verts, d):
        out = jfused.hs_surface_fused(verts, jnp.asarray(idx), d, s, co, exact=True,
                                      interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(d))
    got, grads = port_vjp(lambda v, i, d_: cuda_hs_fused.hs_surface_fused(v, i, d_, s, co),
                          (verts, idx, d), cot)
    assert_close("out", got, want, ATOL)
    assert_close("dverts", grads[0], jgrads[0], ATOL * np.abs(np.asarray(jgrads[0])).max())
    assert_close("dd", grads[1], jgrads[1], ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_orl_vjp_matches_pallas_with_ties(rng, case):
    """Duplicated source rows make exact ties in the max over k: both sides
    send each tied gradient to the first k only."""
    Nk, K, _ = CASES[case]
    Bk, C = 2, 16
    _, idx = _cloud(rng, Bk, Nk, K, False)
    feat = rng.normal(size=(Bk, Nk, C)).astype(np.float32)
    feat[:, 1::2] = feat[:, 0::2][:, : Nk // 2]  # rows 2i and 2i + 1 tie
    idx[:, :, 1] = np.minimum(idx[:, :, 0] ^ 1, Nk - 1)  # the twin of each first neighbour
    cot = rng.normal(size=(Bk, 1, C)).astype(np.float32)

    def loss(f):
        out = jfused.orl_global_fused(f, jnp.asarray(idx), tq=32, exact=True, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(feat))
    got, (grad,) = port_vjp(cuda_hs_fused.orl_global_fused, (feat, idx), cot)
    assert_close("out", got, want, ATOL)
    assert_close("dfeat", grad, jgrad, ATOL)


def test_fused_ops_route_ties_to_the_first_k_and_count_no_launch_on_cpu(rng):
    """Every row equal: every (point, channel) max ties over all k; the whole
    cotangent goes to k = 0 (``torch.amax``'s gradient would split it)."""
    Bk, Nk, K, C = 1, 12, 4, 3
    idx = t(rng.integers(0, Nk, (Bk, Nk, K)).astype(np.int32))
    feat = torch.ones((Bk, Nk, C), requires_grad=True)
    wrappers = [getattr(cuda_hs_fused, f"{op}_fused_{p}")
                for op in ("hs_surface", "hs_support", "orl_global") for p in ("fwd", "bwd")]
    before = [f.launches for f in wrappers]
    cuda_hs_fused.orl_global_fused(feat, idx).sum().backward()
    first = np.bincount(idx[0, :, 0].numpy(), minlength=Nk) / Nk
    np.testing.assert_allclose(feat.grad[0].numpy(), np.repeat(first[:, None], C, 1), atol=1e-7)
    verts = t(rng.normal(size=(Bk, Nk, 3)).astype(np.float32))
    d = t(_unit_dirs(rng, 2 * C)).requires_grad_(True)
    cuda_hs_fused.hs_surface_fused(verts, idx, d, 2, C).sum().backward()
    w = torch.zeros((C, 2 * C), requires_grad=True)
    cuda_hs_fused.hs_support_fused(feat, verts, idx, w, torch.zeros(2 * C), d, 2, C).sum().backward()
    assert [f.launches for f in wrappers] == before
    with torch.no_grad():  # the serving route takes no winners
        _, win = cuda_hs_fused.orl_global_fused_fwd(feat, idx)
    assert int(win.abs().max()) == 0


# --------------------------------------------------------------------------- #
# one layer on the JAX kernel route
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("route,Nl", [("fused", 64), ("reduce", 520)])
def test_layer_and_its_vjp_match_jax_kernel_route(rng, kernel_route, monkeypatch, route, Nl):
    """An ``HSLayer`` with ``bwd_store=False, train_v4_small=True`` in train
    mode: at N <= 512 it takes the fused ops (K3/K8, K4/K10), above 512 K11
    without winner values, K14 and the plain ORL branch."""
    Bl, K, cin, co, s = 2, 12, 16, 8, 3
    verts, rf_idx = _cloud(rng, Bl, Nl, K, True)
    orl_idx = rng.integers(0, Nl, (Bl, Nl, K)).astype(np.int32)
    feat = np.maximum(rng.normal(size=(Bl, Nl, cin)), 0).astype(np.float32)
    jlayer = jlayers.HSLayer(cin, co, s, bwd_store=False, train_v4_small=True, bwd_exact=True)
    layer = HSLayer(cin, co, s, device="cpu", bwd_store=False, train_v4_small=True)
    jargs = (jnp.asarray(verts), jnp.asarray(feat))
    idx = (jnp.asarray(rf_idx), jnp.asarray(orl_idx))
    params = jlayer.init(jax.random.key(0), *jargs, *idx, train=True)["params"]
    cot = rng.normal(size=(Bl, Nl, co)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, v, f: jlayer.apply({"params": p}, v, f, *idx, train=True),
                        params, *jargs)
    jgrads = vjp(jnp.asarray(cot))

    named = dict(layer.named_parameters())
    with torch.no_grad():
        for path, v in _flat(params).items():
            name, transpose = port_name(path)
            named[name].copy_(t(v.T if transpose else v))
    seen = spy_layers(monkeypatch)
    layer.train()
    x = t(feat).requires_grad_(True)
    got = layer(t(verts), x, t(rf_idx), t(orl_idx))
    got.backward(t(cot))
    assert seen[0][:2] == (route, Nl) and seen[1][0] == ("orl_fused" if Nl <= 512 else "orl_plain")
    scale = lambda a: LAYER_REL * max(np.abs(np.asarray(a)).max(), 1.0)
    assert_close("out", got.detach().numpy(), want, scale(want))
    for path, gj in _flat(jgrads[0]).items():
        name, transpose = port_name(path)
        gt = named[name].grad.numpy()
        assert_close(name, gt.T if transpose else gt, gj, scale(gj))
    assert_close("feature_map", x.grad.numpy(), jgrads[2], scale(jgrads[2]))


def test_flags_route_each_layer(monkeypatch):
    """Which reduction each layer of a train forward takes: the default
    routes as before; ``train_v4_small`` moves the HS layers and ORL
    branches at N <= 512 to the fused ops and leaves conv_0 and conv_1
    (N = 600) on K12 / K11; ``bwd_store`` reaches K11's caller."""
    seen = spy_layers(monkeypatch)
    Bs, Ns = 2, 600
    batch = to_device(synthetic_train_batch(Bs, Ns, seed=1), "cpu")
    sizes = (Ns, Ns // 4, Ns // 4, Ns // 16)
    for store, v4 in ((True, False), (False, False), (False, True)):
        cfg = ModelConfig(bwd_store=store, train_v4_small=v4)
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu", train_heads=True).train()
        seen.clear()
        draws = draw_train(torch.Generator().manual_seed(0), Bs, Ns)
        total, _ = train_forward(HSPoseConfig(model=cfg), model, batch, draws=draws)
        total.backward()
        hs = [x for x in seen if not x[0].startswith("orl")]
        orl = [x for x in seen if x[0].startswith("orl")]
        assert hs[0] == ("surface", Ns) and orl[0] == ("orl_plain", Ns)
        if v4:
            assert hs[1:] == [("reduce", Ns, store)] + [("fused", n) for n in sizes[1:]]
            assert orl[1:] == [("orl_plain", Ns)] + [("orl_fused", n) for n in sizes[1:]]
        else:
            assert hs[1:] == [("reduce", n, store) for n in sizes]
            assert orl[1:] == [("orl_plain", n) for n in sizes]


# --------------------------------------------------------------------------- #
# the whole step
# --------------------------------------------------------------------------- #

def test_v4_recompute_train_step_matches_jax_for_six_steps(kernel_route, monkeypatch):
    """Six ``build_train_step`` steps under ``bwd_store=False,
    train_v4_small=True`` against JAX ``make_train_step`` with the same
    flags on the kernel route (lr=1e-3, no warm-up, the same draws in every
    step); at N = 128 every HS layer but conv_0 is at N <= 512, so conv_1 ..
    conv_4 take the fused ops.  Gates: each step's loss within 1e-3
    relative; the six steps' parameter update within norm_rel 5e-2 and
    cosine 0.999 of JAX's."""
    jcfg = default_config()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, bwd_store=False, train_v4_small=True,
                                  bwd_exact=True),
        optim=dataclasses.replace(jcfg.optim, lr=1e-3, warmup_iters=0),
        data=dataclasses.replace(jcfg.data, num_points=N))
    mcfg = ModelConfig(bwd_store=False, train_v4_small=True)
    cfg = HSPoseConfig(model=mcfg).replace(
        optim=dataclasses.replace(OptimConfig(), lr=1e-3, warmup_iters=0))
    batch = train_batch(seed=4)
    pinned = Pinned(6, True)
    pinned.patch_jax(monkeypatch)
    _, state, jstep = j_build_train_step(jcfg, j_build_model(jcfg), jax.random.key(0))
    start = _flat(state.params)
    model = build_model(mcfg, device="cpu", train_heads=True)
    load_jax_params(model, jax.device_get(state.params), jax.device_get(state.batch_stats))
    model.train()
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = to_device(batch, "cpu")
    for i in range(6):
        state, jm = jstep(state, jbatch, jax.random.key(1))
        m = step(tbatch, pinned.port())
        assert m["skipped_nan"] == 0.0
        np.testing.assert_allclose(m["total_loss"], float(jm["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {i}")
    params = dict(model.named_parameters())
    got, want = [], []
    for path, v in _flat(state.params).items():
        name, transpose = port_name(path)
        p = params[name].detach().numpy()
        got.append(((p.T if transpose else p) - start[path]).ravel())
        want.append((v - start[path]).ravel())
    got, want = np.concatenate(got).astype(np.float64), np.concatenate(want).astype(np.float64)
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)
    assert got @ want >= 0.999 * np.linalg.norm(got) * np.linalg.norm(want)
