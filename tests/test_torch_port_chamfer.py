"""The port's chamfer distance and Sinkhorn EMD against the JAX package on
the CPU.

The port's wrappers run their plain versions (the tensors lie on the CPU):
``chamfer_min``, ``chamfer_min_argmin`` and ``chamfer_grad``, the oracles of
K16, K17 and K18 on the card.  They are held against the JAX XLA
``chamfer_distance`` and its VJP, and against the Pallas kernels in
interpret mode: ``chamfer_min_dists_pallas`` (K16), and
``chamfer_distance_kernel`` forward and VJP (K17, K18).  Inputs come from a
numpy seed, once as two independent clouds and once with duplicated points
(a point of a copied into b twice, and a duplicate inside a), where the
distance is |a|^2 + |b|^2 - 2 a.b of equal vectors on both sides.
Tolerances: the distances and gradients are the same fp32 expressions
summed in another order, so 1e-5 of the largest value; the argmins, whose
minima are far from any tie at this seed except the exact duplicates, which
both sides break to the lowest index, are equal.  The EMD is 200 Sinkhorn
sweeps of the same expressions: 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hspose_tpu.ops.chamfer import (
    _chamfer_min_argmin_pallas,
    _nearest,
    _tile_for,
    chamfer_distance_kernel,
    chamfer_distance_pallas,
)
from hspose_tpu.ops.chamfer import chamfer_distance as j_chamfer
from hspose_tpu.ops.chamfer import chamfer_loss as j_chamfer_loss
from hspose_tpu.ops.emd import emd_distance as j_emd
from hspose_tpu_torch.ops import chamfer
from hspose_tpu_torch.ops.emd import emd_distance

torch.set_num_threads(2)  # the suite runs several workers on one host

REL = 1e-5
EMD_REL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def clouds(kind, n=128, m=96, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=0.2, size=(2, n, 3)).astype(np.float32)
    b = (rng.normal(scale=0.2, size=(2, m, 3)) + [0.05, 0.0, -0.02]).astype(np.float32)
    if kind == "duplicates":
        b[:, 5] = a[:, 7]
        b[:, 40] = a[:, 7]
        a[:, 90] = a[:, 11]
    return a, b


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_chamfer_forward_matches_jax_and_k16_k17(kind):
    a, b = clouds(kind)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    with torch.no_grad():
        da, db = chamfer.chamfer_distance(t(a), t(b))
    assert da.shape == (2, 128) and db.shape == (2, 96) and da.dtype == torch.float32
    for name, (wa, wb) in {"xla": j_chamfer(ja, jb),
                           "K16": chamfer_distance_pallas(ja, jb, interpret=True),
                           "K17": chamfer_distance_kernel(ja, jb, True)}.items():
        close(da, wa, f"da vs {name}")
        close(db, wb, f"db vs {name}")
    for x, y, jx, jy in ((a, b, ja, jb), (b, a, jb, ja)):
        d, i = chamfer.chamfer_min_argmin(t(x), t(y))
        assert i.dtype == torch.int32
        close(d, _nearest(jx, jy)[0], "chamfer_min_argmin distance")
        np.testing.assert_array_equal(i.numpy(), np.asarray(_nearest(jx, jy)[1]))
        _, k17_i = _chamfer_min_argmin_pallas(jx, jy, _tile_for(x.shape[1]),
                                              _tile_for(y.shape[1]), True)
        np.testing.assert_array_equal(i.numpy(), np.asarray(k17_i))
    if kind == "duplicates":  # b[5] and b[40] are a[7]: the lower index wins
        assert (chamfer.chamfer_min_argmin(t(a), t(b))[1][:, 7] == 5).all()


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_chamfer_vjp_matches_jax_and_k18(kind):
    a, b = clouds(kind)
    rng = np.random.default_rng(4)
    gda = rng.normal(size=(2, 128)).astype(np.float32)
    gdb = rng.normal(size=(2, 96)).astype(np.float32)
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    da, db = chamfer.chamfer_distance(ta, tb)
    torch.autograd.backward((da, db), (t(gda), t(gdb)))
    ja, jb, cot = jnp.asarray(a), jnp.asarray(b), (jnp.asarray(gda), jnp.asarray(gdb))
    for name, fn in {"xla": j_chamfer,
                     "K17/K18": lambda x, y: chamfer_distance_kernel(x, y, True)}.items():
        (wa, wb), vjp = jax.vjp(fn, ja, jb)
        wga, wgb = vjp(cot)
        close(da.detach(), wa, f"da vs {name}")
        close(ta.grad, wga, f"ga vs {name}")
        close(tb.grad, wgb, f"gb vs {name}")


def test_chamfer_grad_is_the_autograd_of_the_distance():
    """chamfer_grad against torch's own autograd of pairwise_sq_dist + min,
    for each cloud, with the argmins of chamfer_min_argmin."""
    a, b = clouds("random", n=64, m=80, seed=8)
    rng = np.random.default_rng(9)
    gda = t(rng.normal(size=(2, 64)).astype(np.float32))
    gdb = t(rng.normal(size=(2, 80)).astype(np.float32))
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    diff = ta[:, :, None, :] - tb[:, None, :, :]
    d = (diff * diff).sum(-1)
    ((d.amin(2) * gda).sum() + (d.amin(1) * gdb).sum()).backward()
    _, ia = chamfer.chamfer_min_argmin(t(a), t(b))
    _, ib = chamfer.chamfer_min_argmin(t(b), t(a))
    close(chamfer.chamfer_grad(t(a), t(b), ia, ib, gda, gdb), ta.grad, "ga")
    close(chamfer.chamfer_grad(t(b), t(a), ib, ia, gdb, gda), tb.grad, "gb")


def test_chamfer_routes_k16_without_grad_and_k17_k18_with_it(monkeypatch):
    """chamfer_distance calls K16's wrapper twice under no_grad, K17's twice
    with a gradient and K18's once per cloud in the backward; on CPU
    tensors no wrapper counts a launch."""
    wrappers = (chamfer.chamfer_min_cuda, chamfer.chamfer_min_argmin_cuda,
                chamfer.chamfer_grad_cuda)
    before = [w.launches for w in wrappers]
    calls = []
    for fn in wrappers:
        monkeypatch.setattr(chamfer, fn.__name__,
                            lambda *args, _fn=fn: calls.append(_fn.__name__) or _fn(*args))
    a, b = clouds("random")
    with torch.no_grad():
        chamfer.chamfer_distance(t(a).requires_grad_(), t(b))
    assert calls == ["chamfer_min_cuda"] * 2
    calls.clear()
    ta = t(a).requires_grad_()
    loss = chamfer.chamfer_loss(ta, t(b))
    assert calls == ["chamfer_min_argmin_cuda"] * 2
    loss.backward()
    assert calls == ["chamfer_min_argmin_cuda"] * 2 + ["chamfer_grad_cuda"]
    assert ta.grad.shape == (2, 128, 3)
    np.testing.assert_allclose(loss.item(), float(j_chamfer_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=REL)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("offset", [0.0, 0.3])
def test_emd_matches_jax(offset):
    rng = np.random.default_rng(int(offset * 10) + 1)
    a = rng.normal(scale=0.2, size=(2, 128, 3)).astype(np.float32)
    b = (rng.normal(scale=0.2, size=(2, 128, 3)) + offset).astype(np.float32)
    want = np.asarray(j_emd(jnp.asarray(a), jnp.asarray(b), epsilon=0.005, iters=200))
    got = emd_distance(t(a), t(b), epsilon=0.005, iters=200)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=EMD_REL)
