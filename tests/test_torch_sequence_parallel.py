"""The port's sequence-parallel serving (``parallel.sp``: the point axis
sharded over the ranks of a process group) against the port's one-device
forward and the JAX package's ``sp_eval_fn``, on the CPU; and the
query-sharded branches of the KNN, HS surface, HS support and ORL ops
against full-call slices (mirroring tests/test_sequence_parallel.py).

The wrappers run their plain versions here (the tensors lie on the CPU); the
JAX Pallas kernels run in interpret mode.  Process groups are real: four
ranks of a ``gloo`` group joined through a file store under ``tmp_path``
(``tests/_torch_dist_worker.py``), with join timeouts.  Weights are a JAX
init with randomised BatchNorm statistics, crossed over by
``load_jax_params``; pooling is pinned (JAX's permutation replaced, the same
kept rows given to the port).  Tolerances, each with its reason:

* the query-sharded KNN: the same distances of the same rows, so the indices
  equal the full call's rows; and JAX's ``knn_indices(..., source=)`` and
  its interpreted Pallas searches, the same sums on both sides for xyz
  (equal), bf16 features within test_torch_port_bf16.py's gates;
* the query-sharded K2/K3 plain versions: every row's arithmetic is the full
  call's (the support projection runs over the same source rows), bit for
  bit; against the interpreted Pallas kernels test_torch_port_ops.py's
  1e-4 of the largest value (fp32 tier: the kernels' bf16-split operands)
  and test_torch_port_bf16.py's 1e-5 (bf16 tier);
* K4's shard means recombined against the full mean: JAX's ``rtol=2e-7,
  atol=1e-7`` (another fp32 order of the same terms);
* the sp forward (sp = 2, 4, and dp = 2 x sp = 2): against the port's
  one-device forward and against JAX's ``sp_eval_fn`` (dp = 2 x sp = 2)
  ``rtol=2e-5, atol=2e-6``, JAX's tolerance for its own
  sp-against-one-device comparison (the centring and ORL means are
  another fp32 order; the measured gap to JAX is at most 6.6e-7); the ranks
  of a dp row agree bit for bit (their outputs come from collectives);
* the harness with dp = 2 x sp = 2 against JAX's with the same parallel
  settings, and against the port's one-device harness: JAX's own budgets
  for sp against dp (test_sp_eval_harness_matches_dp: ``pred_RTs`` atol
  1e-3, ``pred_scales`` 1e-4, which generate_RT's re-orthogonalisation of
  an untrained model's near-parallel axes needs).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.layers as jlayers
from hspose_tpu.config import default_config
from hspose_tpu.evaluation.evaluate import batched_pose_inference as j_batched_pose_inference
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.ops import knn as jknn
from hspose_tpu.ops.pallas_hs_fused import hs_support_fused as j_support
from hspose_tpu.ops.pallas_hs_fused import hs_surface_fused as j_surface
from hspose_tpu.ops.pallas_hs_fused import orl_global_fused as j_orl
from hspose_tpu.ops.pallas_knn import knn_indices_pallas_qs
from hspose_tpu.parallel.sp import make_sp_mesh, sp_eval_fn
from hspose_tpu_torch.config import ModelConfig, parse_overrides
from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
from hspose_tpu_torch.models.hspose import build_model, eval_forward
from hspose_tpu_torch.ops import cuda_hs_fused, knn
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
from hspose_tpu_torch.utils.convert import load_jax_params

import _torch_dist_worker as worker

torch.set_num_threads(2)  # the suite runs several workers on one host
N_PTS, B = 256, 2  # N divides by 16 * sp for sp = 2, 4
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
LAYOUTS = [(1, 2), (1, 4), (2, 2)]  # (dp, sp)
HARNESS_BATCH = 4


def t(x):
    return torch.from_numpy(np.array(x))


def cloud(rng, b, n, d=3):
    return rng.normal(scale=0.3, size=(b, n, d)).astype(np.float32)


def bf16_values(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# --------------------------------------------------------------------------- #
# the query-sharded ops against full-call slices
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("D", [3, 128])
def test_knn_query_shard_is_the_full_call_slice(rng, D):
    pts = cloud(rng, 2, 96, D)
    lo, hi = 24, 48
    full = knn.knn_indices(t(pts), 5)
    part = knn.knn_indices(t(pts[:, lo:hi]), 5, source=t(pts))
    torch.testing.assert_close(part, full[:, lo:hi], rtol=0, atol=0)
    torch.testing.assert_close(knn_indices_cuda(t(pts[:, lo:hi]), 5, source=t(pts)), part,
                               rtol=0, atol=0)
    want = np.asarray(jknn.knn_indices(jnp.asarray(pts[:, lo:hi]), 5, source=jnp.asarray(pts)))
    np.testing.assert_array_equal(part.numpy(), want)


@pytest.mark.parametrize("D", [3, 128])
def test_packed_knn_query_shard_is_the_full_call_slice(rng, D):
    """Packed keys with the source's index bits: xyz in fp32, features bf16,
    as the bf16 tier gives them; JAX's K1 fast branch with queries."""
    if D == 3:
        pts = cloud(rng, 2, 96, D)
        tp, jp = t(pts), jnp.asarray(pts)
    else:
        pts = bf16_values(np.maximum(rng.normal(size=(2, 96, D)), 0).astype(np.float32))
        tp, jp = t(pts).to(torch.bfloat16), jnp.asarray(pts).astype(jnp.bfloat16)
    lo, hi, k = 32, 64, 8
    full = knn.knn_indices_packed(tp, k)
    part = knn_indices_cuda(tp[:, lo:hi].contiguous(), k, packed=True, source=tp)
    torch.testing.assert_close(part, full[:, lo:hi], rtol=0, atol=0)
    want = np.asarray(knn_indices_pallas_qs(jp[:, lo:hi], jp, k, fast=True, interpret=True))
    got = part.numpy()
    if D == 3:
        np.testing.assert_array_equal(got, want)
    else:  # bf16 products summed in another order: test_torch_port_bf16.py's gate
        assert (got[..., :, None] == want[..., None, :]).any(-1).mean() >= 0.999


def test_knn_query_shard_above_2048_runs_the_exact_search(rng):
    """NQ = 300 <= 2048 < M = 2200: the packed request goes to the exact
    search by the source's size, and the streamed Pallas branch agrees."""
    pts = cloud(rng, 1, 2200)
    q = pts[:, 1100:1400]
    full = knn.knn_indices(t(pts), 4)
    part = knn_indices_cuda(t(q), 4, packed=True, source=t(pts))
    torch.testing.assert_close(part, full[:, 1100:1400], rtol=0, atol=0)
    torch.testing.assert_close(knn.knn_indices(t(q), 4, source=t(pts)), part, rtol=0, atol=0)
    with pytest.raises(ValueError, match="2200 source points"):
        knn.knn_indices_packed(t(q), 4, source=t(pts))
    want = np.asarray(knn_indices_pallas_qs(jnp.asarray(q), jnp.asarray(pts), 4, interpret=True))
    np.testing.assert_array_equal(part.numpy(), want)


@pytest.mark.parametrize("exact", [True, False])
def test_hs_query_shard_is_the_full_call_slice(exact):
    """K2 and K3 with ``vertices_q`` (tests/test_sequence_parallel.py:53-103),
    in the fp32 and the bf16 tier."""
    r = np.random.default_rng(1)
    Bn, N, K, S, co = 2, 64, 8, 7, 32
    verts = cloud(r, Bn, N)
    feat = r.normal(size=(Bn, N, 16)).astype(np.float32)
    idx = np.asarray(jknn.knn_indices(jnp.asarray(verts), K)).astype(np.int32)
    dirs = r.normal(size=(3, S * co)).astype(np.float32)
    w = (r.normal(size=(16, S * co)) * 0.1).astype(np.float32)
    b = (r.normal(size=(S * co,)) * 0.1).astype(np.float32)
    lo, hi = 16, 48
    tv, ti, td = t(verts), t(idx), t(dirs)
    tq = t(verts[:, lo:hi])
    tf = t(feat) if exact else t(feat).to(torch.bfloat16)

    full = cuda_hs_fused.hs_surface_fused(tv, ti, td, S, co, exact)
    part = cuda_hs_fused.hs_surface_fused(tv, ti[:, lo:hi], td, S, co, exact, vertices_q=tq)
    torch.testing.assert_close(part, full[:, lo:hi], rtol=0, atol=0)
    want = np.asarray(j_surface(jnp.asarray(verts), jnp.asarray(idx[:, lo:hi]),
                                jnp.asarray(dirs), S, co, exact=exact, interpret=True,
                                vertices_q=jnp.asarray(verts[:, lo:hi])))
    tol = 1e-4 if exact else 1e-5
    np.testing.assert_allclose(part.numpy(), want, rtol=0, atol=tol * np.abs(want).max())

    args = (tv, ti, t(w), t(b), td, S, co)
    fullc = cuda_hs_fused.hs_support_fused(tf, *args)
    partc = cuda_hs_fused.hs_support_fused(tf, tv, ti[:, lo:hi], *args[2:], vertices_q=tq)
    torch.testing.assert_close(partc, fullc[:, lo:hi], rtol=0, atol=0)
    jf = jnp.asarray(feat) if exact else jnp.asarray(feat).astype(jnp.bfloat16)
    wantc = np.asarray(j_support(jf, jnp.asarray(verts), jnp.asarray(idx[:, lo:hi]),
                                 jnp.asarray(w), jnp.asarray(b), jnp.asarray(dirs), S, co,
                                 exact=exact, interpret=True,
                                 vertices_q=jnp.asarray(verts[:, lo:hi])))
    np.testing.assert_allclose(partc.numpy(), wantc, rtol=0, atol=tol * np.abs(wantc).max())

    # the query-sharded branch serves only
    with pytest.raises(NotImplementedError, match="serves only"):
        cuda_hs_fused.hs_surface_fused(tv, ti[:, lo:hi], td.requires_grad_(), S, co, exact,
                                       vertices_q=tq)


@pytest.mark.parametrize("exact", [True, False])
def test_orl_shard_means_recombine(exact):
    r = np.random.default_rng(1)
    feat = r.normal(size=(2, 64, 16)).astype(np.float32)
    idx = np.asarray(jknn.knn_indices(jnp.asarray(cloud(r, 2, 64)), 8)).astype(np.int32)
    tf = t(feat) if exact else t(feat).to(torch.bfloat16)
    m_full = cuda_hs_fused.orl_global_fused(tf, t(idx))
    m_a = cuda_hs_fused.orl_global_fused(tf, t(idx[:, :32]), query_sharded=True)
    m_b = cuda_hs_fused.orl_global_fused(tf, t(idx[:, 32:]), query_sharded=True)
    torch.testing.assert_close((m_a + m_b) / 2, m_full, rtol=2e-7, atol=1e-7)
    jf = jnp.asarray(feat) if exact else jnp.asarray(feat).astype(jnp.bfloat16)
    want = np.asarray(j_orl(jf, jnp.asarray(idx[:, 32:]), exact=exact, interpret=True))
    tol = 1e-4 if exact else 1e-5
    np.testing.assert_allclose(m_b.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_orl_index_rows_are_checked():
    """The single-source ORL call takes one index row per feature row and
    refuses fewer; the query-sharded call takes 0 < NQ < N rows."""
    feat = torch.zeros((1, 64, 8))
    idx = torch.zeros((1, 32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="32 rows for 64 feature rows"):
        cuda_hs_fused.orl_global_fused(feat, idx)
    with pytest.raises(ValueError, match="0 < NQ < N"):
        cuda_hs_fused.orl_global_fused(feat, torch.zeros((1, 64, 4), dtype=torch.int32),
                                       query_sharded=True)
    assert cuda_hs_fused.orl_global_fused(feat, idx, query_sharded=True).shape == (1, 1, 8)


# --------------------------------------------------------------------------- #
# the sp forward and the sp harness on four gloo ranks
# --------------------------------------------------------------------------- #

def perms(seed):
    r = np.random.default_rng(seed)
    return {N_PTS: r.permutation(N_PTS), N_PTS // 4: r.permutation(N_PTS // 4)}


def samples_of(p):
    return [t(p[N_PTS][:N_PTS // 4]), t(p[N_PTS // 4][:N_PTS // 16])]


def pinned_pooling(mp, p):
    mp.setattr(jlayers.jax.random, "permutation", lambda key, n, **kw: jnp.asarray(p[n]))


def records():
    """tests/test_sequence_parallel.py's records: 3 and 5 crops, batches of
    4 (the second padded)."""
    def record(n_inst, seed):
        r = np.random.default_rng(seed)
        data = {"pcl_in": r.normal(scale=0.2, size=(n_inst, N_PTS, 3)).astype(np.float32),
                "cat_id_0base": (np.arange(n_inst) % 6).astype(np.int32),
                "sym_info": np.tile(np.array([[0, 1, 0, 0]], np.float32), (n_inst, 1)),
                "mean_shape": np.abs(r.normal(size=(n_inst, 3))).astype(np.float32) * 0.1}
        return (data, {}, {})
    return [record(3, 1), record(5, 2)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, params, batch_stats, port model, crops, obj, pool perms,
    the four ranks' outputs)."""
    cfg = default_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_points=N_PTS))
    jmodel = j_build_model(cfg)
    variables = jax.jit(lambda: jmodel.init(
        {"params": jax.random.key(0), "pool": jax.random.key(1), "dropout": jax.random.key(2)},
        np.zeros((B, N_PTS, 3), np.float32), np.zeros((B,), np.int32), False))()
    rng = np.random.default_rng(5)
    params = jax.device_get(variables["params"])
    flat = flax.traverse_util.flatten_dict(jax.device_get(variables["batch_stats"]))
    stats = flax.traverse_util.unflatten_dict({
        k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
            else rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        for k, v in flat.items()})
    model = build_model(ModelConfig(), device="cpu")
    load_jax_params(model, params, stats)
    pc = rng.normal(scale=0.2, size=(B, N_PTS, 3)).astype(np.float32)
    obj = (np.arange(B) % 6).astype(np.int32)
    p = perms(7)
    tasks = {f"{dp}x{sp}": {"kind": "forward", "dp": dp, "sp": sp, "pc": t(pc), "obj": t(obj),
                            "samples": samples_of(p)} for dp, sp in LAYOUTS}
    tasks["harness"] = {"kind": "harness", "records": records(), "seed": 0,
                        "samples": samples_of(p),
                        "overrides": [f"data.num_points={N_PTS}",
                                      f"eval.eval_batch={HARNESS_BATCH}", "parallel.dp=2",
                                      "parallel.sp=2"]}
    outs = worker.launch(tmp_path_factory.mktemp("sp"), 4,
                         {"model": {}, "state_dict": model.state_dict(), "tasks": tasks})
    return jmodel, params, stats, model, pc, obj, p, outs


def gathered(outs, name):
    """The per-crop outputs of one layout: each dp row's from its first sp
    rank, after checking that its other ranks hold the same bits."""
    rows = {}
    for out in outs:
        res = out[name]
        if res is None:
            continue
        if res["rows"] in rows:
            for a, b in zip(res["out"], rows[res["rows"]]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            rows[res["rows"]] = res["out"]
    parts = [rows[k] for k in sorted(rows)]
    return [torch.cat(fields) for fields in zip(*parts)]


@pytest.fixture(scope="module")
def jax_sp(setup):
    """JAX's sp_eval_fn on a (dp=2, sp=2) mesh of its virtual CPU devices,
    with the same weights, crops and pools."""
    jmodel, params, stats, _, pc, obj, p, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        pinned_pooling(mp, p)
        fn = sp_eval_fn(jmodel, make_sp_mesh(dp=2, sp=2), with_rt=False)
        return [np.asarray(x) for x in fn(params, stats, jnp.asarray(pc), jnp.asarray(obj),
                                          jnp.zeros((B, 4)), jnp.zeros((B, 3)),
                                          jax.random.key(42))]


@pytest.mark.parametrize("layout", [f"{dp}x{sp}" for dp, sp in LAYOUTS])
def test_sp_forward_matches_one_device_and_jax(setup, jax_sp, layout):
    _, _, _, model, pc, obj, p, outs = setup
    got = gathered(outs, layout)
    ref = eval_forward(model, t(pc), t(obj), pool_samples=samples_of(p))
    names = ("green", "red", "f_green", "f_red", "T", "s")
    for name, a, b, j in zip(names, got, ref, jax_sp):
        torch.testing.assert_close(a, b, **FWD_TOL, msg=name)
        np.testing.assert_allclose(a.numpy(), j, **FWD_TOL, err_msg=name)


def test_sp_harness_matches_jax_and_one_device(setup, monkeypatch):
    """batched_pose_inference with dp = 2 x sp = 2 on four ranks against JAX's
    with the same settings and against the port's one-device harness; every
    rank returns every result."""
    jmodel, params, stats, model, _, _, p, outs = setup
    got = [out["harness"] for out in outs]
    for other in got[1:]:
        for a, b in zip(other, got[0]):
            np.testing.assert_array_equal(a["pred_RTs"], b["pred_RTs"])
    pinned_pooling(monkeypatch, p)
    jcfg = default_config()
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, num_points=N_PTS),
                        eval=dataclasses.replace(jcfg.eval, eval_batch=HARNESS_BATCH),
                        parallel=dataclasses.replace(jcfg.parallel, dp=2, sp=2))
    jax_preds, _ = j_batched_pose_inference(jcfg, jmodel, params, stats, records(), 0)
    cfg = parse_overrides([f"data.num_points={N_PTS}", f"eval.eval_batch={HARNESS_BATCH}"])
    one, _ = batched_pose_inference(cfg, model, records(), 0, pool_samples=samples_of(p))
    for want in (jax_preds, one):
        assert len(got[0]) == len(want)
        for a, b in zip(got[0], want):
            np.testing.assert_allclose(a["pred_RTs"], b["pred_RTs"], atol=1e-3)
            np.testing.assert_allclose(a["pred_scales"], b["pred_scales"], atol=1e-4)
