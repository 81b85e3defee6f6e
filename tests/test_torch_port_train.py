"""The PyTorch port's fp32 training step against the JAX package on the CPU.

The JAX model's training tree (``init(..., train=True)``) reaches the port
through ``load_jax_params``.  Randomness is pinned on both sides: the numpy
draws go to the port as ``TrainDraws``, and JAX's ``jax.random.uniform``
(augmentation), ``jax.random.permutation`` (pooling) and
``jax.random.bernoulli`` (flax dropout) are replaced by functions that hand
out the same numbers.  On the CPU the JAX layers take their XLA branch and
the port's kernels their plain versions.

Tolerances: loss terms within 1e-4 relative and BatchNorm statistics within
1e-5 (fp32 summation order through the backbone at N=128).  Gradients: per
leaf norm_rel <= 1e-2, the norm part of the N <= 128 gate of
tests/test_torch_parity.py, and the cosine of all leaves as one vector
>= 0.9999.  The element-wise part of that gate (written for the eval graph)
does not hold in train mode even for the JAX package against itself: moving
its input cloud by 1e-7 relative moves its own gradients by norm_rel up to
4.7e-3 and single elements by up to 2.8e-2 of the leaf's largest, because
train-mode BatchNorm ties every row to the batch statistics (E[x^2] - E[x]^2
cancels) and the KNN and max selections flip; the port lands at norm_rel
<= 4.3e-3.  A bias that a train-mode BatchNorm follows has a zero gradient
in exact arithmetic, so both sides hold rounding noise there; such a leaf
(reference norm below 1e-5 of the largest) is held to being as small in
the port.
"""

import dataclasses
import itertools
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hspose_tpu.data.augment as jaugment
import hspose_tpu.models.layers as jlayers
from hspose_tpu.config import OptimConfig as JOptimConfig
from hspose_tpu.config import default_config
from hspose_tpu.data.augment import augment_batch as j_augment_batch
from hspose_tpu.engine import schedule as jschedule
from hspose_tpu.engine.optimizer import build_optimizer
from hspose_tpu.engine.train_step import build_train_step as j_build_train_step
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.models.hspose import train_forward as j_train_forward
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, OptimConfig
from hspose_tpu_torch.data.augment import AugmentDraws, augment_batch, draw_augment
from hspose_tpu_torch.engine import schedule
from hspose_tpu_torch.engine.optimizer import Ranger
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.models import face_recon
from hspose_tpu_torch.models.hspose import (
    TrainDraws,
    build_model,
    draw_train,
    train_forward,
)
from hspose_tpu_torch.utils.convert import load_jax_params, port_name
from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

torch.set_num_threads(2)  # the suite runs several workers on one host
B, N = 4, 128
ZERO_LEAF = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return flax.traverse_util.flatten_dict(jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_model():
    """(jax model, training params, batch_stats) with randomised statistics."""
    rng = np.random.default_rng(11)
    jmodel = j_build_model(default_config())
    variables = jax.jit(lambda rngs, pts, obj: jmodel.init(rngs, pts, obj, True))(
        {"params": jax.random.key(0), "pool": jax.random.key(1),
         "dropout": jax.random.key(2)},
        jnp.zeros((2, N, 3), jnp.float32), jnp.zeros((2,), jnp.int32))
    stats = flax.traverse_util.unflatten_dict({
        k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
            else rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        for k, v in _flat(variables["batch_stats"]).items()})
    return jmodel, jax.device_get(variables["params"]), stats


def port_model(params, stats) -> torch.nn.Module:
    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    load_jax_params(model, params, stats)
    return model.train()


def train_batch(seed: int = 3):
    """synthetic_train_batch with a mug and a bowl, mixed symmetry flags and
    a real perturbation rotation, so every mask and transform is live."""
    batch = synthetic_train_batch(B, N, seed=seed)
    rng = np.random.default_rng(seed + 100)
    batch["cat_id"] = np.array([5, 1, 3, 0], np.float32)
    batch["sym_info"] = np.array([[0, 1, 0, 0], [1, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]],
                                 np.float32)
    q, _ = np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(B, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    batch["aug_rt_R"] = q.astype(np.float32)
    return batch


class Pinned:
    """The numpy draws of one train forward, for both packages."""

    def __init__(self, seed: int, flags_on: bool):
        rng = np.random.default_rng(seed)
        self.flags = np.full((4, B, 1), 0.0 if flags_on else 0.999, np.float32)
        self.ey_up = rng.uniform(0.8, 1.2, (B, 1)).astype(np.float32)
        self.ey_down = rng.uniform(0.8, 1.2, (B, 1)).astype(np.float32)
        self.defor = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
        self.perms = {N: rng.permutation(N), N // 4: rng.permutation(N // 4)}
        self.keep = [rng.uniform(size=(B, 1, 256)) < 0.8 for _ in range(3)]

    def port(self) -> TrainDraws:
        return TrainDraws(
            AugmentDraws(t(self.flags), t(self.ey_up), t(self.ey_down), t(self.defor)),
            [t(self.perms[N][:N // 4]), t(self.perms[N // 4][:N // 16])],
            [t(k[:, 0]) for k in self.keep])

    def patch_jax(self, monkeypatch):
        """Each call of the patched functions hands out the next number of
        its kind, in the order the JAX code draws them."""
        flags = itertools.cycle(self.flags)
        ey = itertools.cycle([self.ey_up, self.ey_down])
        keep = itertools.cycle(self.keep)

        def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            if tuple(shape) == (B, N, 3):
                return jnp.asarray(self.defor)
            if minval == 0.8:
                return jnp.asarray(next(ey))
            return jnp.asarray(next(flags))

        # the augmentation and dropout modules see a jax.random of their own:
        # flax checks parameter shapes by tracing their initialisers, which
        # draw from the real jax.random.uniform
        monkeypatch.setattr(jaugment, "jax", SimpleNamespace(
            random=SimpleNamespace(split=jax.random.split, uniform=uniform)))
        def bernoulli(key, p=0.5, shape=None):  # model.init draws at its own batch size
            if tuple(shape) != (B, 1, 256):
                return jax.random.bernoulli(key, p, shape)
            return jnp.asarray(next(keep))

        monkeypatch.setattr(flax.linen.stochastic, "random",
                            SimpleNamespace(bernoulli=bernoulli))
        monkeypatch.setattr(jlayers.jax.random, "permutation",
                            lambda key, n, **kw: jnp.asarray(self.perms[n]))


def check_grads(got: dict, want: dict):
    """Per leaf norm_rel <= 1e-2, all leaves' cosine >= 0.9999 (see above)."""
    top = max(np.linalg.norm(w) for w in want.values())
    all_g, all_w = [], []
    for name, w in want.items():
        g = np.asarray(got[name], np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        if np.linalg.norm(w) <= ZERO_LEAF * top:
            assert np.linalg.norm(g) <= ZERO_LEAF * top, name
            continue
        norm_rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert norm_rel <= 1e-2, f"{name}: norm_rel={norm_rel:.2e}"
        all_g.append(g)
        all_w.append(w)
    g, w = np.concatenate(all_g), np.concatenate(all_w)
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999


def port_grads_as_flax(model, paths) -> dict:
    """The port's parameter grads at the flax ``paths``, in the flax layout."""
    params = dict(model.named_parameters())
    out = {}
    for path in paths:
        name, transpose = port_name(path)
        g = params[name].grad.numpy()
        out[path] = g.T if transpose else g
    return out


@pytest.mark.parametrize("flags_on", [True, False], ids=["all-augment", "no-augment"])
def test_train_forward_losses_stats_and_grads_match_jax(jax_model, monkeypatch, flags_on):
    jmodel, params, stats = jax_model
    cfg = default_config()
    batch = train_batch()
    pinned = Pinned(5, flags_on)
    pinned.patch_jax(monkeypatch)

    def loss_fn(p):
        return j_train_forward(cfg, jmodel, p, stats, {
            "augment": jax.random.key(0), "pool": jax.random.key(1),
            "dropout": jax.random.key(2)}, {k: jnp.asarray(v) for k, v in batch.items()})

    # jitted: the patched draws are read once, while tracing
    (j_total, (j_losses, j_stats)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = port_model(params, stats)
    total, losses = train_forward(HSPoseConfig(), model, to_device(batch, "cpu"),
                                  draws=pinned.port())
    total.backward()

    for fam, d in j_losses.items():
        assert set(d) == set(losses[fam]), fam
        for k, v in d.items():
            np.testing.assert_allclose(float(losses[fam][k].detach()), float(v), rtol=1e-4,
                                       err_msg=f"{fam}/{k}")
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)

    buffers = dict(model.named_buffers())
    for path, v in _flat(j_stats).items():
        name, _ = port_name(path, stats=True)
        np.testing.assert_allclose(buffers[name].numpy(), v, rtol=0, atol=1e-5, err_msg=name)

    flat_grads = _flat(j_grads)
    check_grads(port_grads_as_flax(model, flat_grads), flat_grads)


def test_augment_matches_jax(monkeypatch):
    batch = train_batch(seed=8)
    for flags_on in (True, False):
        pinned = Pinned(9, flags_on)
        pinned.patch_jax(monkeypatch)
        args = [batch[k] for k in ("pcl_in", "rotation", "translation", "fsnet_scale",
                                   "mean_shape", "sym_info", "aug_bb", "aug_rt_t",
                                   "aug_rt_R", "model_point", "nocs_scale")]
        obj = batch["cat_id"].astype(np.int32)
        want = j_augment_batch(jax.random.key(0), default_config().aug,
                               *(jnp.asarray(a) for a in args), jnp.asarray(obj))
        got = augment_batch(HSPoseConfig().aug, *(t(a) for a in args), t(obj),
                            pinned.port().aug)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6,
                                       err_msg=f"{name} flags_on={flags_on}")
    draws = draw_augment(torch.Generator().manual_seed(0), B, N)
    assert draws.flags.shape == (4, B, 1) and draws.defor.shape == (B, N, 3)
    assert 0.8 <= float(draws.ey_up.min()) and float(draws.ey_down.max()) < 1.2


@pytest.mark.parametrize("name", ["flat_and_anneal", "warmupmultisteplr", "warmupcosinelr"])
def test_schedules_match_jax(name):
    jcfg = dataclasses.replace(JOptimConfig(), lr_scheduler_name=name, warmup_iters=7)
    cfg = dataclasses.replace(OptimConfig(), lr_scheduler_name=name, warmup_iters=7)
    jsched = jschedule.build_schedule(jcfg, 40)
    for step in range(0, 41, 3):
        np.testing.assert_allclose(schedule.learning_rate(cfg, 40, step),
                                   float(jsched(step)), rtol=1e-6, err_msg=f"step {step}")


def test_ranger_matches_jax_optimizer():
    """30 steps on a fixed gradient stream: a Dense kernel (a Linear weight in
    the port), an HS ``weights`` leaf and a bias; the stream crosses t=5 (the
    rectification switch), the lookahead syncs, the clip and the anneal."""
    rng = np.random.default_rng(21)
    jcfg = dataclasses.replace(JOptimConfig(), lr=1e-2, warmup_iters=4)
    cfg = dataclasses.replace(OptimConfig(), lr=1e-2, warmup_iters=4)
    kernel = rng.normal(size=(5, 4)).astype(np.float32)
    weights = rng.normal(size=(6, 8)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    jparams = {"dense": {"kernel": jnp.asarray(kernel)}, "hs": {"weights": jnp.asarray(weights)},
               "b": jnp.asarray(bias)}
    tx = build_optimizer(jcfg, 30)
    jstate = tx.init(jparams)
    ps = [torch.nn.Parameter(t(kernel.T.copy())), torch.nn.Parameter(t(weights)),
          torch.nn.Parameter(t(bias))]
    opt = Ranger(ps, cfg, 30)
    for step in range(30):
        scale = 10.0 if step % 7 == 3 else 0.3  # some steps clip
        gk, gw, gb = (rng.normal(size=s).astype(np.float32) * scale
                      for s in ((5, 4), (6, 8), (4,)))
        grads = {"dense": {"kernel": jnp.asarray(gk)}, "hs": {"weights": jnp.asarray(gw)},
                 "b": jnp.asarray(gb)}
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(ps, (gk.T.copy(), gw, gb)):
            p.grad = t(g)
        opt.step()
        for got, want in zip(ps, (np.asarray(jparams["dense"]["kernel"]).T,
                                  jparams["hs"]["weights"], jparams["b"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step}")
    assert opt.count == 30


def test_train_step_matches_jax_for_six_steps_and_skips_nan(jax_model, monkeypatch):
    """Six steps of build_train_step against JAX make_train_step (lr=1e-3, no
    warm-up), with the same draws in every step; then a NaN batch leaves the
    parameters, BatchNorm buffers and optimizer state bit-identical.

    Gates: each step's loss within 1e-3 relative (measured up to 3.5e-4 at
    step 6), and the six steps' parameter update, all leaves as one vector,
    within norm_rel 5e-2 and cosine 0.999 of JAX's (measured 7.9e-3 and
    0.99997): the gradients differ by up to 5e-3 (module docstring) and
    Ranger's adaptive step m/sqrt(v), taken from step 6, normalises them, so
    a single element is no fair gate."""
    jmodel, _, _ = jax_model
    jcfg = default_config()
    jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim, lr=1e-3, warmup_iters=0),
                        data=dataclasses.replace(jcfg.data, num_points=N))
    cfg = HSPoseConfig().replace(optim=dataclasses.replace(OptimConfig(), lr=1e-3,
                                                           warmup_iters=0))
    batch = train_batch(seed=4)
    pinned = Pinned(6, True)
    pinned.patch_jax(monkeypatch)
    _, state, jstep = j_build_train_step(jcfg, jmodel, jax.random.key(0))
    start = _flat(state.params)
    model = port_model(jax.device_get(state.params), jax.device_get(state.batch_stats))
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = to_device(batch, "cpu")
    for i in range(6):
        state, jm = jstep(state, jbatch, jax.random.key(1))
        m = step(tbatch, pinned.port())
        assert set(m) == set(jm)
        np.testing.assert_allclose(m["total_loss"], float(jm["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {i}")
    assert step.optimizer.count == 6
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

    # a NaN batch: nothing moves
    def opt_state():
        opt = step.optimizer
        return opt.count, [{k: v.clone() for k, v in opt.state[p].items()}
                           for p in model.parameters()]

    before = {k: v.clone() for k, v in model.state_dict().items()}
    count_before, opt_before = opt_state()
    nan_batch = dict(tbatch, pcl_in=torch.full_like(tbatch["pcl_in"], float("nan")))
    m = step(nan_batch, pinned.port())
    assert m["skipped_nan"] == 1.0 and not np.isfinite(m["total_loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    count_after, opt_after = opt_state()
    assert count_after == count_before == 6
    for a, b in zip(opt_after, opt_before):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_serve_k_does_not_reach_training(monkeypatch):
    """The relaxed-KNN tier serves only: a train forward searches with gcn_n_num."""
    ks = []
    real = face_recon.knn

    def spy(x, k):
        ks.append(k)
        return real(x, k)

    monkeypatch.setattr(face_recon, "knn", spy)
    model = build_model(ModelConfig(serve_k=8), device="cpu", train_heads=True)
    batch = to_device(train_batch(), "cpu")
    model.train()
    train_forward(HSPoseConfig(model=ModelConfig(serve_k=8)), model, batch,
                  generator=torch.Generator().manual_seed(0))
    # k = 20 at N, min(20, n // 8) at the pooled sizes 32 and 8; 4 for the pools
    assert sorted(set(ks)) == [1, 4, 20]
    ks.clear()
    model.eval()
    with torch.no_grad():
        model(batch["pcl_in"], batch["cat_id"].int(), draw_train(
            torch.Generator().manual_seed(0), B, N).pool_samples)
    assert sorted(set(ks)) == [1, 4, 8]


def test_load_jax_params_round_trips_the_training_tree(jax_model):
    _, params, stats = jax_model
    model = port_model(params, stats)
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    for tree, is_stats in ((params, False), (stats, True)):
        for path, v in _flat(tree).items():
            name, transpose = port_name(path, is_stats)
            got = named[name].detach().numpy()
            np.testing.assert_array_equal(got.T if transpose else got, v)
    heads = ("conv1d_block", "recon_head", "face_head")
    assert all(any(h in n for n in named) for h in heads)
    # the eval tree, without the heads, loads into a model built without them
    eval_params = dict(params, face_recon={k: v for k, v in params["face_recon"].items()
                                           if k not in heads})
    eval_stats = dict(stats, face_recon={k: v for k, v in stats["face_recon"].items()
                                         if k not in heads})
    load_jax_params(build_model(ModelConfig(), device="cpu"), eval_params, eval_stats)
    with pytest.raises(KeyError, match="conv1d_block"):
        load_jax_params(build_model(ModelConfig(), device="cpu"), params, stats)
