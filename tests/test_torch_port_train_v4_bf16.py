"""The port's bf16 training routes of ``bwd_store=False`` (K11 without
winner values, then K14) and ``train_v4_small=True`` (the fused ops' forwards
with winners and their backwards K8, K10, and K9 beside them) against the
JAX package's ``exact=False`` kernels on the CPU.

The JAX Pallas kernels run in interpret mode.  The fused kernels
(pallas_hs_fused.py) round their one-pass products' operands to bf16
explicitly (``astype``), so the interpreted kernels make the TPU's roundings
and the port's plain versions are held to them element-wise.  The v3
kernels (pallas_hs.py, K14) leave that rounding to ``Precision.DEFAULT``,
which is full fp32 on the CPU: there W is fed holding bf16 values and the
rounding of dpi and du is the one difference by design, as in
tests/test_torch_port_train_bf16.py.  The port's wrappers run their plain
versions because the tensors lie on the CPU.  Inputs come from numpy seeds;
the ``ragged`` and ``dup`` cases of tests/test_torch_port_train_v4.py build
duplicated points (rf = 0, theta = 0 for every support, so the max over k
ties at 0) and, for the ORL branch, duplicated rows (exact ties).

Tolerances, each with its reason:

* the fused ops (K2-K4 with winners, K8, K9, K10): the winners equal; each
  bf16 output within one bf16 ulp of each element plus ``REL`` = 1e-4 of
  the largest, each fp32 output within ``REL`` of the largest (both sides
  sum exact products of bf16 values in fp32, in another order, which moves
  a final rounding to bf16 by at most one ulp);
* K14: every cotangent within ``BWD_REL`` = 1e-2 of its largest with a
  cosine >= 0.9999, and with the port's operand rounding switched off
  within 1e-6 plus one bf16 ulp (tests/test_torch_port_train_bf16.py);
  K14 against K13 (both plain, same forward) within 1e-6 of the largest;
* one bf16 layer on the kernel route: ``LAYER_REL`` = 2^-6 of the largest
  and a cosine >= 0.9999, the gate and the reasons of
  tests/test_torch_port_train_bf16.py::test_bf16_layer_and_its_vjp_match_jax_kernel_route
  (a bf16 result one rounding apart after sums in another order).

The whole bf16 step under each flag is held to the JAX package's spread in
tests/test_torch_port_step_bf16_flags.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.layers as jlayers
import hspose_tpu.ops.pallas_hs as jpallas
import hspose_tpu.ops.pallas_hs_fused as jfused
from hspose_tpu_torch.models.layers import HSLayer
from hspose_tpu_torch.ops import cuda_hs, cuda_hs_fused
from hspose_tpu_torch.utils.convert import port_name
from test_torch_port_train import _flat
from test_torch_port_train_bf16 import (
    BWD_REL,
    LAYER_REL,
    S,
    bf16_ulp,
    bf16_values,
    close,
    kernel_inputs,
    port_vjp,
)
from test_torch_port_train_v4 import CASES, _cloud, _unit_dirs, kernel_route, spy_layers  # noqa: F401

torch.set_num_threads(2)  # the suite runs several workers on one host

REL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def check(name, got, want):
    """bf16 outputs within one bf16 ulp of each element plus REL of the
    largest, fp32 outputs within REL of the largest; the same dtypes."""
    bf16 = want.dtype == jnp.bfloat16
    assert (got.dtype == torch.bfloat16) == bf16, f"{name}: {got.dtype}, {want.dtype}"
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape, name
    diff = np.abs(got - want) - (bf16_ulp(want) if bf16 else 0.0)
    bound = REL * np.abs(want).max()
    assert diff.max() <= bound, f"{name}: {diff.max():.3e} > {bound:.3e}"


def tie_features(rng, Bk, Nk, C):
    """bf16-valued features whose odd rows repeat the even ones: exact ties."""
    feat = bf16_values(np.maximum(rng.normal(size=(Bk, Nk, C)), 0).astype(np.float32)).copy()
    feat[:, 1::2] = feat[:, 0::2][:, : Nk // 2]
    return feat


# --------------------------------------------------------------------------- #
# K2-K4 with winners and K8, K9, K10 in bf16
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", list(CASES))
def test_fused_support_bf16_vjp_matches_pallas(rng, case):
    """K3 with winners and K8, ``exact=False``: bf16 features, fp32
    vertices, W, b and directions, as the bf16 layer passes them."""
    Nk, K, dup = CASES[case]
    Bk, cin, s, co = 2, 16, 3, 8
    verts, idx = _cloud(rng, Bk, Nk, K, dup)
    feat = tie_features(rng, Bk, Nk, cin)
    w = rng.normal(scale=0.2, size=(cin, s * co)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(s * co,)).astype(np.float32)
    d = bf16_values(_unit_dirs(rng, s * co))
    cot = rng.normal(size=(Bk, Nk, co)).astype(np.float32)
    jin = (jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(verts), jnp.asarray(idx),
           jnp.asarray(w), jnp.asarray(b), jnp.asarray(d))

    def loss(feat, verts, w, b, d):
        out = jfused.hs_support_fused(feat, verts, jin[2], w, b, d, s, co, exact=False,
                                      interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(
        *(jin[i] for i in (0, 1, 3, 4, 5)))
    (_, jwin), _ = jfused._support_fwd_call(*jin, s=s, co=co, tq=64, exact=False,
                                            interpret=True, want_win=True)
    tin = [t(feat).to(torch.bfloat16), t(verts), t(idx), t(w), t(b), t(d)]
    _, win, _ = cuda_hs_fused.hs_support_fused_fwd_plain(*tin, s, co)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin)[:, :Nk])

    for x in tin:
        x.requires_grad_(x.is_floating_point())
    out = cuda_hs_fused.hs_support_fused(*tin, s, co)
    (out * t(cot)).sum().backward()
    check("out", out, want)
    for name, x, gj in zip(("dfeat", "dverts", "dw", "db", "dd"),
                           (tin[i] for i in (0, 1, 3, 4, 5)), jgrads):
        check(name, x.grad, gj)
    assert torch.isfinite(tin[1].grad).all()


@pytest.mark.parametrize("case", list(CASES))
def test_fused_surface_bf16_vjp_matches_pallas(rng, case):
    """K2 with winners and K9, ``exact=False`` (K9's carrier: autograd
    through ``hs_surface_fused``)."""
    Nk, K, dup = CASES[case]
    Bk, s, co = 2, 4, 8
    verts, idx = _cloud(rng, Bk, Nk, K, dup)
    d = _unit_dirs(rng, s * co)
    cot = rng.normal(size=(Bk, Nk, co)).astype(np.float32)

    def loss(verts, d):
        out = jfused.hs_surface_fused(verts, jnp.asarray(idx), d, s, co, exact=False,
                                      interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(d))
    (_, jwin), _ = jfused._surface_fwd_call(jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(d),
                                            s=s, co=co, tq=64, exact=False, interpret=True,
                                            want_win=True)
    _, win = cuda_hs_fused.hs_surface_fused_fwd_plain(t(verts), t(idx), t(d), s, co, exact=False)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin)[:, :Nk])
    tv, td = t(verts).requires_grad_(True), t(d).requires_grad_(True)
    out = cuda_hs_fused.hs_surface_fused(tv, t(idx), td, s, co, exact=False)
    (out * t(cot)).sum().backward()
    check("out", out, want)
    check("dverts", tv.grad, jgrads[0])
    check("dd", td.grad, jgrads[1])


@pytest.mark.parametrize("case", list(CASES))
def test_fused_orl_bf16_vjp_matches_pallas_with_ties(rng, case):
    """K4 with winners and K10, ``exact=False``: duplicated rows tie in the
    max over k; both sides send each tied gradient to the first k only."""
    Nk, K, _ = CASES[case]
    Bk, C = 2, 16
    _, idx = _cloud(rng, Bk, Nk, K, False)
    feat = tie_features(rng, Bk, Nk, C)
    idx[:, :, 1] = np.minimum(idx[:, :, 0] ^ 1, Nk - 1)  # the twin of each first neighbour
    cot = rng.normal(size=(Bk, 1, C)).astype(np.float32)

    def loss(f):
        out = jfused.orl_global_fused(f, jnp.asarray(idx), tq=32, exact=False, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(feat).astype(jnp.bfloat16))
    tf = t(feat).to(torch.bfloat16).requires_grad_(True)
    out = cuda_hs_fused.orl_global_fused(tf, t(idx))
    (out * t(cot)).sum().backward()
    assert out.dtype == torch.float32 and tf.grad.dtype == torch.bfloat16
    check("out", out, want)
    check("dfeat", tf.grad, jgrad)


def test_bf16_fused_ops_count_no_launch_on_cpu_and_serve_under_no_grad(rng):
    """With grad on, a bf16 call takes the autograd route and returns finite
    grads on the CPU (no launch counted); under ``no_grad`` it takes the
    serving plain version, the winner-recording forward's output."""
    Bk, Nk, K, C, s = 1, 24, 4, 8, 2
    verts, idx = (t(a) for a in _cloud(rng, Bk, Nk, K, True))
    feat = t(tie_features(rng, Bk, Nk, C)).to(torch.bfloat16)
    d = t(_unit_dirs(rng, s * C))
    w, b = t(rng.normal(size=(C, s * C)).astype(np.float32)), torch.zeros(s * C)
    wrappers = [getattr(cuda_hs_fused, f"{op}_fused_{p}")
                for op in ("hs_surface", "hs_support", "orl_global") for p in ("fwd", "bwd")]
    before = [(f.launches, f.bf16_launches) for f in wrappers]
    with torch.no_grad():
        served = cuda_hs_fused.hs_support_fused(feat, verts, idx, w, b, d, s, C)
    x = feat.clone().requires_grad_(True)
    out = cuda_hs_fused.hs_support_fused(x, verts, idx, w, b, d, s, C)
    assert torch.equal(out.detach(), served)
    (out.sum() + cuda_hs_fused.orl_global_fused(x, idx).sum()).backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    assert [(f.launches, f.bf16_launches) for f in wrappers] == before


# --------------------------------------------------------------------------- #
# K11 without values and K14 in bf16
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("N,K,cin,co", [(96, 12, 32, 8), (64, 8, 16, 16)])
def test_support_recompute_bf16_matches_pallas_and_k13(rng, monkeypatch, N, K, cin, co):
    """K11 without winner values and K14 (``bwd_store=False``,
    ``exact=False``) against the interpreted kernels, and K14 against K13
    from the same forward."""
    g, rf, w, b, d, cot = kernel_inputs(rng, N, K, cin, co)
    jin = (jnp.asarray(g).astype(jnp.bfloat16), jnp.asarray(rf).astype(jnp.bfloat16),
           jnp.asarray(w), jnp.asarray(b), jnp.asarray(d).astype(jnp.bfloat16))

    def loss(*a):
        out = jpallas.hs_support_reduce(*a, S, co, exact=False, interpret=True, bwd_store=False)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(*jin)
    names, bf16_args = ("dg", "drf", "dw", "db", "dd"), (0, 1, 4)

    def port_grads():
        got, grads = port_vjp(lambda *a: cuda_hs.hs_support_reduce(*a, S, co, store=False),
                              (g, rf, w, b, d), bf16_args, cot)
        close("out", got.numpy(), want, 1e-5)
        return grads

    for i, (name, gt, gj) in enumerate(zip(names, port_grads(), jgrads)):
        assert gt.dtype == (torch.bfloat16 if i in bf16_args else torch.float32), name
        close(name, gt.float().numpy(), np.asarray(gj.astype(jnp.float32)), BWD_REL)

    # K14 against K13 from the same forward (plain versions)
    ts = [t(g).bfloat16(), t(rf).bfloat16(), t(w), t(b), t(d).bfloat16()]
    out, win, twin, pwin = cuda_hs.hs_support_fwd_plain(*ts, S, co)
    out2, win2 = cuda_hs.hs_support_fwd(*ts, S, co, store=False)
    assert torch.equal(out, out2) and torch.equal(win, win2)
    gb = t(cot)
    k13 = cuda_hs.hs_support_bwd_plain(ts[0], ts[1], ts[2], ts[4], win, twin, pwin, gb, S, co)
    k14 = cuda_hs.hs_support_bwd_recompute(*ts, win, gb, S, co)
    for name, a, c in zip(names, k14, k13):
        assert a.dtype == c.dtype, name
        close(name, a.float().numpy(), c.float().numpy(), 1e-6)

    # without the operand rounding the plain backward is the interpreted one
    monkeypatch.setattr(cuda_hs, "_operand", lambda x, fast: x)
    for i, (name, gt, gj) in enumerate(zip(names, port_grads(), jgrads)):
        gj = np.asarray(gj.astype(jnp.float32))
        close(name, gt.float().numpy(), gj, 1e-6, slack=bf16_ulp(gj) if i in bf16_args else None)


# --------------------------------------------------------------------------- #
# one bf16 layer on the JAX kernel route
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("route,flags", [
    ("fused", {"bwd_store": False, "train_v4_small": True}),
    ("reduce", {"bwd_store": False, "train_v4_small": False})], ids=["v4", "recompute"])
def test_bf16_layer_and_its_vjp_match_jax_kernel_route(rng, kernel_route, monkeypatch, route,
                                                       flags):
    """A bf16 ``HSLayer`` in train mode at N = 64: with ``train_v4_small``
    it takes the fused ops (K3/K8, K4/K10), else K11 without winner values,
    K14 and the plain ORL branch."""
    Bl, Nl, K, cin, co = 2, 64, 12, 32, 16
    verts, rf_idx = _cloud(rng, Bl, Nl, K, True)
    orl_idx = rng.integers(0, Nl, (Bl, Nl, K)).astype(np.int32)
    feat = bf16_values(np.maximum(rng.normal(size=(Bl, Nl, cin)), 0).astype(np.float32))
    jlayer = jlayers.HSLayer(cin, co, S, dtype=jnp.bfloat16, **flags)
    layer = HSLayer(cin, co, S, device="cpu", dtype=torch.bfloat16, **flags)
    jargs = (jnp.asarray(verts), jnp.asarray(feat).astype(jnp.bfloat16))
    idx = (jnp.asarray(rf_idx), jnp.asarray(orl_idx))
    params = jlayer.init(jax.random.key(0), *jargs, *idx, train=True)["params"]
    # matrices as bf16 values: the interpreted v3 kernels do not round W
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(bf16_values(x)) if x.ndim == 2 and x.shape[0] != 3 else x, params)
    cot = bf16_values(rng.normal(size=(Bl, Nl, co)).astype(np.float32))
    want, vjp = jax.vjp(lambda p, *a: jlayer.apply({"params": p}, *a, *idx, train=True),
                        params, *jargs)
    jgrads = vjp(jnp.asarray(cot).astype(jnp.bfloat16))

    named = dict(layer.named_parameters())
    with torch.no_grad():
        for path, v in _flat(params).items():
            name, transpose = port_name(path)
            named[name].copy_(t(v.T if transpose else v))
    seen = spy_layers(monkeypatch)
    layer.train()
    x = t(feat).to(torch.bfloat16).requires_grad_(True)
    got = layer(t(verts), x, t(rf_idx), t(orl_idx))
    got.backward(t(cot).to(torch.bfloat16))
    assert seen[0][:2] == (route, Nl)
    assert seen[1][0] == ("orl_fused" if route == "fused" else "orl_plain")
    assert got.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    close("out", got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)), LAYER_REL)
    for path, gj in _flat(jgrads[0]).items():
        name, transpose = port_name(path)
        gt = named[name].grad.numpy()
        close(name, gt.T if transpose else gt, np.asarray(gj, np.float32), LAYER_REL)
    close("feature_map", x.grad.float().numpy(), np.asarray(jgrads[2].astype(jnp.float32)),
          LAYER_REL)
