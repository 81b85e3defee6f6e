"""The PyTorch port's bf16 train step against the JAX package on the CPU.

The JAX package trains in bf16 (``compute_dtype="bfloat16"``) through the
``exact=False`` branches of its v3 Pallas kernels (K11, K12, K13, K15) on
the TPU.  On the CPU its layers would take their XLA scan branch, which
forms rf from fp32 vertices and rounds elsewhere, so the tests here send
them down the TPU route (``kernel_route``): ``hspose_tpu.models.layers``
sees a ``jax`` whose ``devices()`` report a TPU, and the two reductions run
in interpret mode; ``hspose_tpu.ops.knn`` keeps the real ``jax``, so its
gathers stay on the CPU path.  The whole-step test also points the JAX KNN
at the Pallas packed-key kernel in interpret mode.  The port's wrappers run
their plain versions because the tensors lie on the CPU.  Inputs come from
numpy seeds.

On the CPU, ``Precision.DEFAULT`` is full fp32: the interpreted JAX
kernels do not round W, dpi or du to bf16, while the port, like the TPU,
does.  W is therefore fed holding bf16 values, which leaves the rounding of
dpi and du as the one difference by design.

Tolerances, each with its reason (measured on the CPU):

* kernels, forward: both sides sum exact products of bf16 values in fp32,
  so only the order differs: outputs within ``FWD_REL`` = 1e-5 of the
  largest (measured <= 1.4e-7); winners equal on >= 99.9%, near-ties
  (1e-5 of the largest product) elsewhere;
* kernels, backward: every cotangent within ``BWD_REL`` = 1e-2 of its
  largest value (measured <= 5.0e-3, about one bf16 ulp, from rounding dpi
  and du) with a cosine >= 0.9999 (measured >= 0.9999964); with the port's
  operand rounding switched off, every cotangent lands within one bf16 ulp
  of each element plus 1e-6 of the largest (the final rounding of the
  bf16 cotangents after sums in another order), which shows the rounding
  sits where the TPU's one-pass products put it;
* one layer of each kind (no KNN, pooling or BatchNorm enters): the output
  and the VJP for every parameter and the input features within
  ``LAYER_REL`` = 2^-6 of the largest value, two bf16 ulps in its binade,
  with a cosine >= 0.9999.  A bf16 result (the output, the feature
  cotangent, the centre weights' cotangent out of a bf16 product) may sit
  one rounding apart when the two sides sum in another order, which is up
  to 2^-7 of the largest; the rounding of dpi and du and the gather's
  cotangent (the JAX CPU path scatters it into bf16, the port sums it in
  fp32 and rounds once) add less.  Measured: 7.6e-3 on the support layer's
  weights (one flip of the centre part, with or without the port's operand
  rounding), <= 5.2e-3 elsewhere; cosine >= 0.999991;
* the whole bf16 train forward and backward is chaotic: bf16 roundings
  flip KNN, pooling and winner selections, and train-mode BatchNorm ties
  every row to the batch.  So it is held to the JAX package's own spread,
  measured in the test: the JAX bf16 step against itself with the input
  cloud moved by 1e-6 relative, four ways (two random directions, both
  signs), the largest taken.  Measured at B=4, N=128: a move can leave
  the step unchanged (1e-9) or move the loss terms by 9.4e-3 of the total
  loss, the BatchNorm statistics by 4.9e-3 of their largest value and the
  global gradient cosine to 0.957; the port lies 7.2e-3, 5.0e-3 and 0.950
  from the JAX step.  Gate: ``SPREAD_MULT`` = 3 times the spread on each.
  Single gradient leaves are not gated element-wise.  The port's own fp32
  step at the same weights lies as far from its bf16 step as the JAX bf16
  step does (measured 1.4e-2, 1.9e-2, 0.78 against 7.2e-3, 2.3e-2, 0.80),
  gated at ``SPREAD_MULT`` times the larger of that and the spread.
"""

import dataclasses
import functools
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.face_recon as jface_recon
import hspose_tpu.models.layers as jlayers
import hspose_tpu.ops.pallas_hs as jpallas
from hspose_tpu.config import default_config
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.models.hspose import train_forward as j_train_forward
from hspose_tpu.ops.pallas_knn import knn_indices_pallas
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models.hspose import build_model, train_forward
from hspose_tpu_torch.models.layers import HSLayer, HSLayerSurface
from hspose_tpu_torch.ops import cuda_hs
from hspose_tpu_torch.ops.knn import neighbor_directions_normalized
from hspose_tpu_torch.utils.convert import load_jax_params, port_name
from test_torch_port_train import B, N, Pinned, _flat, port_grads_as_flax, train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host

S = 7
FWD_REL = 1e-5
BWD_REL = 1e-2
COS = 0.9999
WIN_AGREE = 0.999
LAYER_REL = 2.0 ** -6
SPREAD_MULT = 3.0
SPREAD_EPS = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def bf16_values(x):
    """numpy fp32 array of the values x takes in bf16."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


class _ReportsTPU:
    """``jax`` for ``hspose_tpu.models.layers``: ``devices()`` reports a TPU,
    everything else is the real module."""

    def __init__(self, real):
        self._real = real

    def devices(self, *args, **kwargs):
        return [SimpleNamespace(platform="tpu")]

    def __getattr__(self, name):
        return getattr(self._real, name)


@pytest.fixture
def kernel_route(monkeypatch):
    """The JAX layers on their TPU training route, with the v3 kernels in
    interpret mode (the layers import the reductions at call time)."""
    monkeypatch.setattr(jlayers, "jax", _ReportsTPU(jax))
    for name in ("hs_support_reduce", "hs_surface_reduce"):
        monkeypatch.setattr(jpallas, name,
                            functools.partial(getattr(jpallas, name), interpret=True))


def close(name, got, want, rel, cos=COS, slack=None):
    """Element-wise within ``rel`` of the largest value (plus ``slack`` per
    element), and the cosine of the two as vectors at least ``cos``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    diff = np.abs(got - want) - (0.0 if slack is None else slack)
    scale = np.abs(want).max()
    assert diff.max() <= rel * scale, f"{name}: {diff.max():.3e} > {rel} * {scale:.3e}"
    c = got.ravel() @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-300)
    assert c >= cos, f"{name}: cosine {c:.8f}"


def bf16_ulp(x):
    """The spacing of bf16 values at |x|."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def kernel_inputs(rng, N, K, cin, co, B=2):
    """bf16 g, rf (formed in bf16 from the vertices, with a duplicated point
    so that one rf row is exactly 0) and unit directions; W holding bf16
    values and b, both fp32; an output cotangent."""
    verts = rng.normal(scale=0.2, size=(B, N, 3)).astype(np.float32)
    verts[:, 7] = verts[:, 3]
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, 3, 0] = 7
    rf = neighbor_directions_normalized(t(verts).to(torch.bfloat16), t(idx)).float().numpy()
    assert np.all(rf[:, 3, 0] == 0)
    g = bf16_values(np.maximum(rng.normal(size=(B, N, K, cin)), 0).astype(np.float32))
    stdv = 1.0 / (co * (S + 1)) ** 0.5
    w = bf16_values(rng.uniform(-stdv, stdv, (cin, S * co)).astype(np.float32))
    b = rng.uniform(-stdv, stdv, (S * co,)).astype(np.float32)
    d = rng.normal(size=(3, S * co)).astype(np.float32)
    d = bf16_values(d / np.linalg.norm(d, axis=0, keepdims=True))
    cot = rng.normal(size=(B, N, co)).astype(np.float32)
    return g, rf, w, b, d, cot


def port_vjp(fn, args, bf16_args, cot):
    """Output and input cotangents of ``fn`` on the port's CPU path."""
    ts = [t(a).to(torch.bfloat16 if i in bf16_args else torch.float32).requires_grad_(True)
          for i, a in enumerate(args)]
    out = fn(*ts)
    (out * t(cot)).sum().backward()
    return out.detach(), [x.grad for x in ts]


SIZES = [(257, 20, 64, 32), (128, 8, 128, 16)]


@pytest.mark.parametrize("N,K,cin,co", SIZES)
def test_support_kernels_plain_match_pallas_exact_false(rng, monkeypatch, N, K, cin, co):
    """K11 and K13 (``bwd_store=True``, ``exact=False``) against the plain
    versions: forward, winners and every cotangent."""
    g, rf, w, b, d, cot = kernel_inputs(rng, N, K, cin, co)
    jin = (jnp.asarray(g).astype(jnp.bfloat16), jnp.asarray(rf).astype(jnp.bfloat16),
           jnp.asarray(w), jnp.asarray(b), jnp.asarray(d).astype(jnp.bfloat16))

    def loss(*a):
        out = jpallas.hs_support_reduce(*a, S, co, exact=False, interpret=True, bwd_store=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(*jin)
    # the kernel forward's winner records, on the padded k-major inputs
    tq = 64
    gp, _, n_pad = jpallas._prep_kmajor(jpallas._to_kmajor(jin[0]), tq)
    rfp, _, _ = jpallas._prep_kmajor(jpallas._to_kmajor(jin[1]), tq)
    _, jwin, jtw, jpw = (np.asarray(x)[:, :N] for x in jpallas._support_pallas(
        gp, rfp, jin[2], jin[3].reshape(1, -1), jin[4], s=S, co=co, k_valid=K, tq=tq,
        exact=False, interpret=True, want_win=True, want_vals=True))

    fwd = cuda_hs.hs_support_fwd_plain(t(g).bfloat16(), t(rf).bfloat16(), t(w), t(b),
                                       t(d).bfloat16(), S, co)
    out, win, tw, pw = (x.numpy() for x in fwd)
    close("out", out, want, FWD_REL)
    assert (win == jwin).mean() >= WIN_AGREE
    prod, jprod = tw * pw, jtw * jpw
    assert np.abs(prod - jprod)[win != jwin].max(initial=0) <= FWD_REL * np.abs(jprod).max()

    names = ("dg", "drf", "dw", "db", "dd")
    bf16_args = (0, 1, 4)

    def port_grads():
        got, grads = port_vjp(lambda *a: cuda_hs.hs_support_reduce(*a, S, co),
                              (g, rf, w, b, d), bf16_args, cot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FWD_REL * np.abs(np.asarray(want)).max())
        return grads

    grads = port_grads()
    for i, (name, gt, gj) in enumerate(zip(names, grads, jgrads)):
        assert gt.dtype == (torch.bfloat16 if i in bf16_args else torch.float32), name
        assert gj.dtype == (jnp.bfloat16 if i in bf16_args else jnp.float32), name
        close(name, gt.float().numpy(), np.asarray(gj.astype(jnp.float32)), BWD_REL)
    rounded_dw = np.abs(grads[2].numpy() - np.asarray(jgrads[2])).max()
    assert rounded_dw > 1e-4 * np.abs(np.asarray(jgrads[2])).max()  # the rounding shows

    # without the operand rounding the plain backward is the interpreted one
    monkeypatch.setattr(cuda_hs, "_operand", lambda x, fast: x)
    for i, (name, gt, gj) in enumerate(zip(names, port_grads(), jgrads)):
        gj = np.asarray(gj.astype(jnp.float32))
        close(name, gt.float().numpy(), gj, 1e-6, slack=bf16_ulp(gj) if i in bf16_args else None)


@pytest.mark.parametrize("N,K,co", [(n, k, co) for n, k, _, co in SIZES])
def test_surface_kernels_plain_match_pallas_exact_false(rng, monkeypatch, N, K, co):
    """K12 and K15 (``exact=False``) against the plain versions."""
    _, rf, _, _, d, cot = kernel_inputs(rng, N, K, 4, co)
    jin = (jnp.asarray(rf).astype(jnp.bfloat16), jnp.asarray(d).astype(jnp.bfloat16))

    def loss(*a):
        out = jpallas.hs_surface_reduce(*a, S, co, exact=False, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(*jin)
    tq = 64
    rfp, _, _ = jpallas._prep_kmajor(jpallas._to_kmajor(jin[0]), tq)
    _, jwin = (np.asarray(x)[:, :N] for x in jpallas._surface_pallas(
        rfp, jin[1], s=S, co=co, k_valid=rf.shape[2], tq=tq, exact=False, interpret=True,
        want_win=True))
    out, win = cuda_hs.hs_surface_fwd_plain(t(rf).bfloat16(), t(d).bfloat16(), S, co)
    close("out", out.numpy(), want, FWD_REL)
    win = win.numpy()
    assert (win == jwin).mean() >= WIN_AGREE
    theta = np.maximum(rf.astype(np.float64) @ d.astype(np.float64), 0)  # (B, N, K, S*Co)
    at = lambda w: np.take_along_axis(theta, w[:, :, None].astype(np.int64), 2)[:, :, 0]
    assert np.abs(at(win) - at(jwin)).max() <= FWD_REL * theta.max()

    def port_grads():
        got, grads = port_vjp(lambda *a: cuda_hs.hs_surface_reduce(*a, S, co), (rf, d),
                              (0, 1), cot)
        close("out", got.numpy(), want, FWD_REL)
        return grads

    for name, gt, gj in zip(("drf", "dd"), port_grads(), jgrads):
        assert gt.dtype == torch.bfloat16 and gj.dtype == jnp.bfloat16, name
        close(name, gt.float().numpy(), np.asarray(gj.astype(jnp.float32)), BWD_REL)
    monkeypatch.setattr(cuda_hs, "_operand", lambda x, fast: x)
    for name, gt, gj in zip(("drf", "dd"), port_grads(), jgrads):
        gj = np.asarray(gj.astype(jnp.float32))
        close(name, gt.float().numpy(), gj, 1e-6, slack=bf16_ulp(gj))


@pytest.mark.parametrize("kind", ["surface", "support"])
def test_bf16_layer_and_its_vjp_match_jax_kernel_route(rng, kernel_route, kind):
    """One bf16 layer in train mode, with the same weights (the matrices
    holding bf16 values) and fixed neighbour indices: the output and the
    VJP for every parameter and the input features."""
    Bl, Nl, K = 2, 257, 20
    verts = rng.normal(scale=0.2, size=(Bl, Nl, 3)).astype(np.float32)
    verts[:, 7] = verts[:, 3]
    rf_idx = rng.integers(0, Nl, (Bl, Nl, K)).astype(np.int32)
    rf_idx[:, 3, 0] = 7
    orl_idx = rng.integers(0, Nl, (Bl, Nl, K)).astype(np.int32)
    if kind == "support":
        cin, co = 64, 32
        jlayer = jlayers.HSLayer(cin, co, S, dtype=jnp.bfloat16, bwd_store=True)
        layer = HSLayer(cin, co, S, device="cpu", dtype=torch.bfloat16)
        feat = bf16_values(np.maximum(rng.normal(size=(Bl, Nl, cin)), 0).astype(np.float32))
        jargs = (jnp.asarray(verts), jnp.asarray(feat).astype(jnp.bfloat16))
    else:
        co = 128
        jlayer = jlayers.HSLayerSurface(co, S, dtype=jnp.bfloat16)
        layer = HSLayerSurface(co, S, device="cpu", dtype=torch.bfloat16)
        jargs = (jnp.asarray(verts),)
    idx = (jnp.asarray(rf_idx), jnp.asarray(orl_idx))
    params = jlayer.init(jax.random.key(0), *jargs, *idx, train=True)["params"]
    # matrices (not the (3, S*Co) directions) as bf16 values, so that the
    # interpreted kernels' unrounded W equals the port's rounded one
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(bf16_values(x)) if x.ndim == 2 and x.shape[0] != 3 else x, params)
    cot = bf16_values(rng.normal(size=(Bl, Nl, co)).astype(np.float32))

    def apply(p, *a):
        return jlayer.apply({"params": p}, *a, *idx, train=True)

    want, vjp = jax.vjp(apply, params, *jargs)
    jgrads = vjp(jnp.asarray(cot).astype(jnp.bfloat16))

    named = dict(layer.named_parameters())
    with torch.no_grad():
        for path, v in _flat(params).items():
            name, transpose = port_name(path)
            named[name].copy_(t(v.T if transpose else v))
    layer.train()
    targs = [t(verts)]
    if kind == "support":
        targs.append(t(feat).to(torch.bfloat16).requires_grad_(True))
    got = layer(*targs, t(rf_idx), t(orl_idx))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got.backward(t(cot).to(torch.bfloat16))
    close("out", got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)), LAYER_REL)
    for path, gj in _flat(jgrads[0]).items():
        name, transpose = port_name(path)
        gt = named[name].grad.numpy()
        close(name, gt.T if transpose else gt, np.asarray(gj, np.float32), LAYER_REL)
    if kind == "support":
        assert targs[1].grad.dtype == torch.bfloat16
        close("feature_map", targs[1].grad.float().numpy(),
              np.asarray(jgrads[2].astype(jnp.float32)), LAYER_REL)


def _step_gaps(a, b) -> dict:
    """How far two train forwards (terms, BN statistics, gradients) lie
    apart: the largest loss-term difference as a share of the total loss,
    the largest statistic difference as a share of its buffer's largest
    value, and 1 - the cosine of all gradients as one vector."""
    (ta, sa, ga), (tb, sb, gb) = a, b
    grad_a = np.concatenate([ga[k].ravel() for k in gb])
    grad_b = np.concatenate([gb[k].ravel() for k in gb])
    return {"loss": max(abs(ta[k] - v) for k, v in tb.items()) / abs(tb["total"]),
            "bn": max(float(np.abs(sa[k] - v).max() / np.abs(v).max()) for k, v in sb.items()),
            "grad": 1.0 - grad_a @ grad_b / (np.linalg.norm(grad_a) * np.linalg.norm(grad_b))}


def _terms(total, losses):
    return {"total": float(total),
            **{f"{fam}/{k}": float(v) for fam, d in losses.items() for k, v in d.items()}}


def test_bf16_train_step_lies_within_the_jax_spread(kernel_route, monkeypatch):
    check_bf16_step_within_jax_spread(monkeypatch)


def check_bf16_step_within_jax_spread(monkeypatch, **flags):
    """The port's bf16 train forward and backward against the JAX step's own
    spread (module docstring), on the kernel route; ``flags``
    (``bwd_store``, ``train_v4_small``) go to both packages' model config,
    the port's fp32 step included."""
    cfg = default_config()
    jcfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16", **flags))
    jmodel = j_build_model(jcfg)
    rng = np.random.default_rng(11)
    variables = jax.jit(lambda rngs, pts, obj: jmodel.init(rngs, pts, obj, True))(
        {"params": jax.random.key(0), "pool": jax.random.key(1),
         "dropout": jax.random.key(2)},
        jnp.zeros((2, N, 3), jnp.float32), jnp.zeros((2,), jnp.int32))
    params = jax.device_get(variables["params"])
    stats = flax.traverse_util.unflatten_dict({
        k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
            else rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        for k, v in _flat(variables["batch_stats"]).items()})
    batch = train_batch()
    pinned = Pinned(5, True)
    pinned.patch_jax(monkeypatch)
    monkeypatch.setattr(jface_recon, "knn_indices_fast",
                        lambda p, kk, fast=False, source=None:
                        knn_indices_pallas(p, kk, fast=True, interpret=True))

    def loss_fn(p, b):
        return j_train_forward(jcfg, jmodel, p, stats, {
            "augment": jax.random.key(0), "pool": jax.random.key(1),
            "dropout": jax.random.key(2)}, b)

    # jitted once: the pinned draws are read while tracing
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def jax_run(b):
        (total, (losses, new_stats)), grads = step(params, {k: jnp.asarray(v)
                                                           for k, v in b.items()})
        return (_terms(total, losses), {k: np.asarray(v) for k, v in _flat(new_stats).items()},
                {k: np.asarray(v, np.float64) for k, v in _flat(grads).items()})

    def port_run(dtype):
        tier = ModelConfig(compute_dtype=dtype, **flags)
        model = build_model(tier, device="cpu", train_heads=True)
        load_jax_params(model, params, stats)
        model.train()
        total, losses = train_forward(HSPoseConfig(model=tier), model, to_device(batch, "cpu"),
                                      draws=pinned.port())
        total.backward()
        buffers = dict(model.named_buffers())
        return (_terms(total.detach(), {f: {k: v.detach() for k, v in d.items()}
                                        for f, d in losses.items()}),
                {k: buffers[port_name(k, stats=True)[0]].numpy() for k in _flat(stats)},
                {k: np.asarray(v, np.float64)
                 for k, v in port_grads_as_flax(model, list(_flat(params))).items()})

    ref = jax_run(batch)
    spread = {}
    for seed in (12, 13):
        z = np.random.default_rng(seed).standard_normal(batch["pcl_in"].shape)
        for sign in (1.0, -1.0):
            moved = (batch["pcl_in"] * (1.0 + sign * SPREAD_EPS * z)).astype(np.float32)
            gaps = _step_gaps(jax_run(dict(batch, pcl_in=moved)), ref)
            spread = {k: max(spread.get(k, 0.0), v) for k, v in gaps.items()}
    port = port_run("bfloat16")
    assert all(np.isfinite(v) for v in port[0].values())
    gap = _step_gaps(port, ref)
    for k, v in gap.items():
        assert v <= SPREAD_MULT * spread[k], f"{k}: port {v:.3e}, JAX spread {spread[k]:.3e}"
    # against the port's fp32 step: as far as the JAX bf16 step lies from it
    fp32 = port_run("float32")
    tier_gap, jax_tier_gap = _step_gaps(port, fp32), _step_gaps(ref, fp32)
    for k, v in tier_gap.items():
        bound = SPREAD_MULT * max(jax_tier_gap[k], spread[k])
        assert v <= bound, f"{k}: port bf16 - fp32 {v:.3e}, JAX bf16 - port fp32 " \
                           f"{jax_tier_gap[k]:.3e}"


def test_bf16_train_step_trains_and_skips_a_nan_batch():
    """Two ``build_train_step`` steps in bf16: finite losses, the parameters
    move, Ranger counts; then a NaN batch leaves the parameters, the
    BatchNorm buffers and the optimizer state as they were."""
    cfg = HSPoseConfig(model=ModelConfig(compute_dtype="bfloat16"))
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu", train_heads=True)
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))
    batch = to_device(train_batch(seed=4), "cpu")
    start = [p.detach().clone() for p in model.parameters()]
    for _ in range(2):
        m = step(batch)
        assert m["skipped_nan"] == 0.0 and all(np.isfinite(v) for v in m.values())
    assert step.optimizer.count == 2
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(start, model.parameters()))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [{k: v.clone() for k, v in step.optimizer.state[p].items()}
                  for p in model.parameters()]
    m = step(dict(batch, pcl_in=torch.full_like(batch["pcl_in"], float("nan"))))
    assert m["skipped_nan"] == 1.0 and not np.isfinite(m["total_loss"])
    assert step.optimizer.count == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, p in zip(opt_before, model.parameters()):
        for k, v in step.optimizer.state[p].items():
            assert torch.equal(v, a[k]), k
