"""The plain reference against the port's CPU path at a tiny size, and the
control: the reference in a lower precision reads far from it.

This test imports both; the reference itself imports nothing of the port
(``test_portbench_imports.py``)."""

import pytest
import torch

from portbench import inputs
from portbench.kinds import train
from portbench.reference import model as ref
from portbench.reference.precision import Precision, round_fp8, round_tf32
from portbench.weights import make_weights, param_spec, trainable
from portbench_helpers import N, tiny_cell, run_cpu

MODEL = dict(gcn_sup_num=7, gcn_n_num=20, obj_c=6, face_recon_c=30)


def _serving_inputs(B=4):
    g = torch.Generator().manual_seed(3)
    pc = torch.randn(B, N, 3, generator=g) * 0.2
    obj = torch.arange(B) % 6
    sym = torch.tensor(inputs.SYM, dtype=torch.float32)[obj]
    mean = torch.rand(B, 3, generator=g) * 0.1 + 0.1
    return pc, obj, sym, mean, inputs.pool_samples(N, g)


def test_serving_reference_follows_the_port():
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import build_model, eval_forward

    pc, obj, sym, mean, pools = _serving_inputs()
    w = make_weights(MODEL, False, 7, "cpu")
    model = build_model(ModelConfig(), device="cpu")
    model.load_state_dict(w)
    o = eval_forward(model, pc, obj.to(torch.int32), pool_samples=pools)
    RT = generate_RT(o.p_green_R, o.p_red_R, o.f_green_R, o.f_red_R, o.pred_T, sym)
    RT_ref, s_ref = ref.serve(w, ref.Arch.of(MODEL), pc, obj, sym, mean, pools)
    assert (RT - RT_ref).abs().max() < 2e-6
    assert (o.pred_s + mean - s_ref).abs().max() < 2e-6
    RT_tf32, _ = ref.serve(w, ref.Arch.of(MODEL), pc, obj, sym, mean, pools, Precision("tf32"))
    assert (RT_tf32 - RT_ref).abs().max() > 100 * (RT - RT_ref).abs().max()


def test_training_reference_follows_the_port():
    out = run_cpu(tiny_cell("train-fp32-b24"))
    n = out.extra["numbers"]
    # the worst leaf's change is left out: over six steps a near tie of the
    # port's CPU searches turns one way or the other from run to run and moves
    # a leaf's change by up to 3e-2 (the cell compares the median leaf's)
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-3 and n["update_gap_median"] < 1e-3
    x = out.extra
    control = train.reference_steps(tiny_cell("train-fp32-b24"), x["weights"], x["batches"],
                                    x["draws"], Precision("tf32"))
    c = train.gaps(control, x["reference"])
    assert all(c[k] > 3 * n[k] for k in n)


def test_weights_match_the_state_dict_and_train_names():
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model

    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    w = make_weights(MODEL, True, 2**40 + 1, "cpu")
    model.load_state_dict(w, strict=True)
    assert trainable(param_spec(MODEL, True)) == [n for n, _ in model.named_parameters()]
    again = make_weights(MODEL, True, 2**40 + 1, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@pytest.mark.parametrize("x", [1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.14159, -2.5e-3])
def test_operand_rounding(x):
    t = torch.tensor([x])
    r = round_tf32(t).item()
    assert abs(r - x) <= abs(x) * 2 ** -11
    assert (torch.tensor([r]).view(torch.int32) & 0x1FFF).item() == 0
    f = round_fp8(torch.tensor([x, 448.0 * x])).tolist()
    assert abs(f[0] - x) <= abs(x) * 2 ** -4 + 1e-12
