"""The serving route of the pose heads' first block (``models/heads.py::
FirstLayers``, ``ops/heads_epilogue.py``) on the CPU: the maps multiplied per
backbone resolution, then the gather-add-BatchNorm-ReLU epilogue, against the
concatenated route that every head runs on the 1286-d feature.

Tolerances, each with its reason:

* fp32: the two routes add the same products in another order (three
  products per resolution and a gather, against one K = 1286 product):
  ``FP32_REL`` = 1e-5 of the largest value, on each head's block output and
  on every pose output;
* bf16: the factored route rounds each head's sum and its bias to bf16 once;
  the concatenated route rounds the same sum once for the rotation heads,
  and for the translation head also its two products and their sum (its
  split product on the feature and the points).  So each element may sit one
  bf16 ulp of every rounding away, carried through the BatchNorm's scale,
  plus one ulp of the output, plus the fp32 order of a K = 1286 sum:
  ``ORDER_REL`` = 2^-16 of the head's largest sum;
* the epilogue against its formula (a float64 loop over rows, rounded where
  the tier rounds): fp32 within ``FP32_REL``; bf16 within one ulp of the
  rounded sum carried through the scale, plus one ulp of the output.
"""

import numpy as np
import pytest
import torch

import hspose_tpu_torch.models.heads as heads_mod
from hspose_tpu_torch.config import ModelConfig
from hspose_tpu_torch.models.face_recon import batch_norm
from hspose_tpu_torch.models.hspose import build_model, draw_pool_samples, eval_forward
from hspose_tpu_torch.models.layers import dense
from hspose_tpu_torch.ops.heads_epilogue import build_params, heads_epilogue
from hspose_tpu_torch.utils.convert import flax_variables, load_jax_params

torch.set_num_threads(2)  # the suite runs several workers on one host

FP32_REL = 1e-5
ORDER_REL = 2.0 ** -16
B, N = 2, 256


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x|, as fp32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def seeded_model(dtype: str, seed: int = 0, train_heads: bool = False):
    """A full-width serving model on the CPU with BatchNorm statistics and
    affine parameters away from their defaults."""
    torch.manual_seed(seed)
    model = build_model(ModelConfig(compute_dtype=dtype), device="cpu", train_heads=train_heads)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return model


def inputs(seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    pc = torch.randn(B, N, 3, generator=g) * 0.2 + torch.randn(B, 1, 3, generator=g) * 0.1
    obj = torch.tensor([1, 4])
    return pc, obj, draw_pool_samples(N, torch.Generator().manual_seed(seed + 1), device="cpu")


def concatenated_block(model, feat, centred):
    """Each head's first block as ``VecHead.forward`` runs it on the
    concatenated feature: the block's output and the roundings its sum went
    through (bf16)."""
    out = []
    for head in model.pose_heads():
        v = head.vec
        dt = v.dtype
        if head is not model.ts:
            pre = dense(v.conv1, feat, dt)
            parts = [pre]
        else:
            w = v.conv1.weight.to(dt)
            cx = feat.shape[-1]
            a, b = feat.to(dt) @ w[:, :cx].t(), centred.to(dt) @ w[:, cx:].t()
            pre = a + b + v.conv1.bias.to(dt)
            parts = [a, b, a + b, pre]
        out.append((torch.relu(batch_norm(v.bn1, pre)), parts))
    return out


def bn_scale(v) -> torch.Tensor:
    return (torch.rsqrt(v.bn1.running_var + v.bn1.eps) * v.bn1.weight).abs()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factored_route_matches_concatenated(dtype):
    model = seeded_model(dtype)
    pc, obj, smp = inputs()
    with torch.no_grad():
        centred = pc - pc.mean(dim=1, keepdim=True)
        got = model.first_layers(model.face_recon.maps(centred, smp), obj, centred)
        want = concatenated_block(model, model.face_recon(centred, obj, smp), centred)
    for (hw, parts), hg, head in zip(want, got, model.pose_heads()):
        assert hg.dtype == hw.dtype and hg.shape == hw.shape
        gap = (hg.float() - hw.float()).abs()
        if dtype == "float32":
            assert float(gap.max()) <= FP32_REL * float(hw.abs().max())
        else:
            order = ORDER_REL * float(parts[-1].float().abs().max())
            tol = bn_scale(head.vec) * (sum(ulp(p) for p in parts) + order) + ulp(hw)
            assert bool((gap <= tol).all()), float((gap / tol).max())

    served = eval_forward(model, pc, obj, pool_samples=smp)
    model.factored = lambda: False
    reference = eval_forward(model, pc, obj, pool_samples=smp)
    for name, x, y in zip(served._fields, served, reference):
        assert bool(torch.isfinite(x).all()), name
        if dtype == "float32":
            assert float((x - y).abs().max()) <= FP32_REL * max(float(y.abs().max()), 1.0), name


def formula(p0, p1, p2, up_1, up_2, cat_id, xyz, w_cat, w_xyz, bias, bns, dtype):
    """The epilogue's function written out row by row in float64: the sum,
    then (bf16) its rounding with the bias, each head's eval BatchNorm and
    ReLU; returns (h, the rounded sums)."""
    Bq, Nq, C = p0.shape
    s = torch.empty(Bq, Nq, C, dtype=torch.float64)
    for b in range(Bq):
        for n in range(Nq):
            row = (p0[b, n].double() + p1[b, up_1[b, n]].double() + p2[b, up_2[b, n]].double()
                   + w_cat[cat_id[b]].double())
            row[C - w_xyz.shape[1]:] += xyz[b, n].double() @ w_xyz.double()
            s[b, n] = row + bias.double()
    if dtype == torch.bfloat16:
        s = s.float().to(torch.bfloat16).double()
    mean, var, gamma, beta, eps = bns
    y = (s - mean.double()) / torch.sqrt(var.double() + eps) * gamma.double() + beta.double()
    return torch.relu(y), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("indices", ["tie_free", "repeated"])
def test_epilogue_plain_against_formula(dtype, indices):
    rng = np.random.default_rng(7)
    Bq, Nq, N1, N2, C, obj_c = 3, 40, 10, 3, 2048, 6

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    p0, p1, p2 = t(Bq, Nq, C), t(Bq, N1, C), t(Bq, N2, C)
    if indices == "tie_free":  # every pooled row used, in a shuffled order
        up_1 = np.stack([rng.permutation(np.arange(Nq) % N1) for _ in range(Bq)])
        up_2 = np.stack([rng.permutation(np.arange(Nq) % N2) for _ in range(Bq)])
    else:  # a few rows gathered by many points, some never
        up_1 = rng.integers(0, 2, size=(Bq, Nq))
        up_2 = np.zeros((Bq, Nq), dtype=np.int64)
    up_1 = torch.from_numpy(up_1.astype(np.int32))
    up_2 = torch.from_numpy(up_2.astype(np.int32))
    cat_id = torch.tensor([0, 5, 2], dtype=torch.int32)
    xyz = t(Bq, Nq, 3, scale=0.2).to(dtype)
    w_cat, w_xyz = t(obj_c, C, scale=0.1), t(3, 1024, scale=0.5)
    if dtype == torch.bfloat16:  # the tier's weights hold bf16 values
        w_cat, w_xyz = w_cat.to(dtype).float(), w_xyz.to(dtype).float()
    bias, mean, gamma, beta = t(C, scale=0.1), t(C, scale=0.1), t(C).abs() + 0.5, t(C, scale=0.1)
    var = torch.from_numpy(rng.random(C).astype(np.float32)) + 0.5
    eps = 1e-5
    params = build_params(bias, mean, var, gamma, beta, eps, dtype)

    got = heads_epilogue(p0, p1, p2, up_1, up_2, cat_id, xyz, w_cat, w_xyz, params)
    bias_t = params[0]  # bf16: the bias the tier adds, rounded to bf16
    want, sums = formula(p0, p1, p2, up_1, up_2, cat_id, xyz.float(), w_cat, w_xyz, bias_t,
                         (mean, var, gamma, beta, eps), dtype)
    assert got.dtype == dtype and got.shape == (Bq, Nq, C)
    gap = (got.double() - want).abs()
    if dtype == torch.float32:
        assert float(gap.max()) <= FP32_REL * float(want.abs().max())
    else:
        scale = (torch.rsqrt(var + eps) * gamma).abs().double()
        tol = scale * ulp(sums).double() + ulp(want).double()
        assert bool((gap <= tol).all()), float((gap / tol).max())


def count_epilogue(monkeypatch) -> list:
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return heads_epilogue(*args, **kwargs)

    monkeypatch.setattr(heads_mod, "heads_epilogue", counting)
    return calls


@pytest.mark.parametrize("case", ["served", "train_mode", "grad_on", "with_heads", "mp_layer"])
def test_route_selection(case, monkeypatch):
    """Every forward in eval mode without gradients takes the factored route
    and runs the epilogue once (with_heads too; an sp forward is counted in
    test_torch_sequence_parallel.py), unless a head layer is sharded over mp;
    training and gradients do not."""
    model = build_model(ModelConfig(), device="cpu",
                        train_heads=case in ("with_heads", "train_mode"))
    calls = count_epilogue(monkeypatch)
    pc, obj, smp = inputs()
    if case == "mp_layer":
        model.ts.vec.conv2.mp_group = object()
        assert not model.factored()
        return
    if case == "train_mode":
        model.train()
        model(pc, obj, smp)
    elif case == "grad_on":
        with torch.enable_grad():
            out = model(pc, obj, smp)
        assert out.pred_T.requires_grad
    else:
        eval_forward(model, pc, obj, pool_samples=smp, with_heads=case == "with_heads")
    assert len(calls) == (0 if case in ("train_mode", "grad_on") else 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_with_heads_serves_the_same_poses(dtype):
    """``with_heads`` (the recon harness) serves the poses of the plain served
    forward bit for bit, and its train heads read the concatenated feature:
    recon and face are those of the concatenated route."""
    model = seeded_model(dtype, train_heads=True)
    pc, obj, smp = inputs()
    served = eval_forward(model, pc, obj, pool_samples=smp)
    recon = eval_forward(model, pc, obj, pool_samples=smp, with_heads=True)
    for name, x in zip(served._fields, served):
        assert torch.equal(getattr(recon, name), x), name
    model.factored = lambda: False
    concatenated = eval_forward(model, pc, obj, pool_samples=smp, with_heads=True)
    for name in ("recon", "face_normal", "face_dis", "face_f"):
        assert torch.equal(getattr(recon, name), getattr(concatenated, name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_into_p0(dtype):
    """fp32 writes h over P0 (the serving route's buffer) with the bits of a
    fresh output; bf16 refuses P0, whose type is not h's."""
    rng = np.random.default_rng(3)
    Bq, Nq, N1, N2, C = 2, 16, 4, 1, 3072

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    p0, p1, p2 = t(Bq, Nq, C), t(Bq, N1, C), t(Bq, N2, C)
    up_1 = torch.from_numpy(rng.integers(0, N1, size=(Bq, Nq)).astype(np.int32))
    up_2 = torch.zeros(Bq, Nq, dtype=torch.int32)
    params = build_params(t(C), t(C), t(C).abs() + 0.5, t(C), t(C), 1e-5, dtype)
    args = (p1, p2, up_1, up_2, torch.tensor([0, 3]), t(Bq, Nq, 3).to(dtype), t(6, C),
            t(3, 1024), params)
    fresh = heads_epilogue(p0, *args)
    if dtype == torch.bfloat16:
        with pytest.raises(TypeError):
            heads_epilogue(p0, *args, out=p0)
        return
    got = heads_epilogue(p0, *args, out=p0)
    assert got is p0 and torch.equal(got, fresh)


@pytest.mark.parametrize("change", ["load_state_dict", "load_jax_params", "in_place_step",
                                    "train_mode_batch_norm"])
def test_stacked_weights_follow_parameters(change):
    """The stacked weights are cached, and rebuilt after every way the port
    writes the heads' parameters and statistics: the served forward after the
    write equals the concatenated route on the new values."""
    model = seeded_model("float32", train_heads=change == "train_mode_batch_norm")
    pc, obj, smp = inputs()
    eval_forward(model, pc, obj, pool_samples=smp)  # builds the cache
    first = model.first_layers.consts()
    assert model.first_layers.consts() is first  # unchanged parameters: the cache stays
    other = seeded_model("float32", seed=5, train_heads=change == "train_mode_batch_norm")
    if change == "load_state_dict":
        model.load_state_dict(other.state_dict())
    elif change == "load_jax_params":
        load_jax_params(model, *flax_variables(other))
    elif change == "in_place_step":
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.25)
    else:
        model.train()
        with torch.no_grad():
            model(pc, obj, smp)
        model.eval()
    served = eval_forward(model, pc, obj, pool_samples=smp)
    assert model.first_layers.consts() is not first
    model.factored = lambda: False
    reference = eval_forward(model, pc, obj, pool_samples=smp)
    for name, x, y in zip(served._fields, served, reference):
        assert float((x - y).abs().max()) <= FP32_REL * max(float(y.abs().max()), 1.0), name
