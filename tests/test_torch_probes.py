"""The port's training and tier probes against the JAX scripts on the CPU.

``hspose_tpu_torch/tools/train_sanity.py`` and ``fast_mode_parity.py`` are
the port's copies of ``scripts/train_sanity.py`` and
``scripts/fast_mode_parity.py``.  The JAX scripts are loaded here by file
path (the port never imports them).  Tolerances:

- the synthetic data (``make_batch``, ``upright_rotations``,
  ``random_rotations``): bit for bit;
- ``pose_errors`` on the same weights (``utils/convert.py::load_jax_params``),
  batch and pinned pooling: 2e-3 degree, 1e-3 cm and 1e-4 in size error.  The
  fp32 forwards agree within 5e-4 at N=1028 (tests/test_torch_port_model.py);
  on these random weights the mean errors part by up to 9e-4 degree, 2.8e-4
  cm (2.8e-6 m, float32 summation order in a 1028-point forward) and 2.2e-6
  in size;
- ``assemble`` fed the JAX forward's poses: the JAX ``map_table``'s table to
  1e-9 points (the same numpy arithmetic); ``predict`` against those poses
  (the JAX forward jitted at B=8, N=1028): RT within 2e-3, sizes within
  5e-4.  On these random weights 6 of the 8 crops' RT agree within 1e-4, the
  worst crop within 7.7e-4 (5.4e-4 at ``serve_k=16``); sizes within 3.2e-5;
- the convergence artifact's ``--set`` pass-through and the two ``main``
  functions: control flow only, on small shapes.
"""

import ast
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.models.hspose as jhspose
import hspose_tpu.models.layers as jlayers
from hspose_tpu.config import default_config
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu_torch.config import ModelConfig, parse_overrides
from hspose_tpu_torch.models.hspose import build_model
from hspose_tpu_torch.tools import convergence_artifact as ca
from hspose_tpu_torch.tools import fast_mode_parity as fmp
from hspose_tpu_torch.tools import train_sanity as ts
from hspose_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)  # the suite runs several workers on one host
REPO = Path(__file__).resolve().parents[1]
POSE_DEG, POSE_CM, POSE_SIZE = 2e-3, 1e-3, 1e-4
TABLE_PTS = 1e-9
PREDICT_RT_ATOL, PREDICT_S_ATOL = 2e-3, 5e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jscripts():
    """(scripts/train_sanity.py, scripts/fast_mode_parity.py) as modules; the
    second imports the first as ``train_sanity``, which is registered only
    while it loads."""
    jts = _load("jax_train_sanity", REPO / "scripts" / "train_sanity.py")
    saved = sys.modules.get("train_sanity")
    sys.modules["train_sanity"] = jts
    try:
        jfmp = _load("jax_fast_mode_parity", REPO / "scripts" / "fast_mode_parity.py")
    finally:
        if saved is None:
            sys.modules.pop("train_sanity", None)
        else:
            sys.modules["train_sanity"] = saved
    return jts, jfmp


@pytest.fixture(scope="module")
def models():
    """(jax model, params, batch_stats, port model) with shared weights and
    randomised BatchNorm statistics (as tests/test_torch_port_model.py)."""
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


def _pin_jax_pooling(monkeypatch, seed, n):
    """JAX's pooling permutations replaced by those that a CPU generator
    seeded ``seed`` gives the port (``draw_pool_samples``: a permutation of
    n, then of n // 4)."""
    gen = torch.Generator().manual_seed(seed)
    perms = {n: torch.randperm(n, generator=gen).numpy(),
             n // 4: torch.randperm(n // 4, generator=gen).numpy()}
    monkeypatch.setattr(jlayers.jax.random, "permutation",
                        lambda key, m, **kw: jnp.asarray(perms[m]))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("easy", [False, True], ids=["so3", "upright"])
def test_make_batch_bit_for_bit(jscripts, easy, seed):
    jts, _ = jscripts
    want = jts.make_batch(np.random.default_rng(seed), 6, 300, ts.MEAN_SHAPE, easy=easy)
    got = ts.make_batch(np.random.default_rng(seed), 6, 300, ts.MEAN_SHAPE, easy=easy)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
def test_rotations_bit_for_bit(jscripts, seed):
    jts, _ = jscripts
    for name in ("random_rotations", "upright_rotations"):
        want = getattr(jts, name)(np.random.default_rng(seed), 9)
        got = getattr(ts, name)(np.random.default_rng(seed), 9)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("easy", [False, True], ids=["so3", "upright"])
def test_pose_errors_match_jax(jscripts, models, monkeypatch, easy):
    jts, _ = jscripts
    jmodel, params, stats, model = models
    batch = ts.make_batch(np.random.default_rng(11), 4, 1028, ts.MEAN_SHAPE, easy=easy)
    _pin_jax_pooling(monkeypatch, ts.EVAL_POOL_SEED, 1028)
    want = jts.pose_errors(jmodel, params, stats, batch, jax.random.key(7))
    got = ts.pose_errors(model, batch, torch.Generator().manual_seed(ts.EVAL_POOL_SEED))
    assert not model.training
    for g, w, tol, name in zip(got, want, (POSE_DEG, POSE_CM, POSE_SIZE),
                               ("rot_deg", "trans_cm", "size")):
        assert abs(g - w) <= tol, (name, g, w)
    # a model in train mode is evaluated with its running statistics and put back
    model.train()
    try:
        again = ts.pose_errors(model, batch, torch.Generator().manual_seed(ts.EVAL_POOL_SEED))
        assert model.training
    finally:
        model.eval()
    assert again == got


def _capture_tables(monkeypatch, jfmp, jmodel, params, stats, n_crops):
    """JAX ``map_table`` at ``eval_bs = n_crops``, with the detections it
    hands to ``compute_degree_cm_mAP`` captured: (table, RT, pred_s) with RT
    and pred_s those of the JAX forward (pred_s recovered exactly from
    float64 pred_scales - mean_shape)."""
    import hspose_tpu.evaluation.metrics as jmetrics

    seen = []
    real = jmetrics.compute_degree_cm_mAP

    def spy(results, *a, **kw):
        seen.extend(results)
        return real(results, *a, **kw)

    monkeypatch.setattr(jmetrics, "compute_degree_cm_mAP", spy)
    table = jfmp.map_table(jmodel, params, stats, n_crops=n_crops, eval_bs=n_crops, easy=True)
    RT = np.concatenate([r["pred_RTs"] for r in seen])
    s = np.concatenate([r["pred_scales"] for r in seen]) - ts.MEAN_SHAPE[None]
    assert RT.dtype == s.dtype == np.float64
    return table, RT, s


@pytest.mark.parametrize("case", ["fp32", "serve_k16", "near_gt"])
def test_assemble_and_predict_match_jax_map_table(jscripts, models, monkeypatch, case):
    _, jfmp = jscripts
    jmodel, params, stats, model = models
    n_crops = 8
    batches = fmp.held_out(n_crops, n_crops, easy=True)
    if case == "serve_k16":
        cfg = default_config()
        jmodel = j_build_model(cfg.replace(model=dataclasses.replace(cfg.model, serve_k=16)))
        model = build_model(ModelConfig(serve_k=16), device="cpu")
        load_jax_params(model, params, stats)
    if case == "near_gt":
        # the JAX forward replaced by poses near the ground truth, so that the
        # table has mass in every bin
        b = batches[0]
        rng = np.random.default_rng(3)

        def noisy(x, scale, unit=False):
            x = x + rng.normal(scale=scale, size=x.shape)
            if unit:
                x /= np.linalg.norm(x, axis=-1, keepdims=True)
            return jnp.asarray(x.astype(np.float32))

        out = jhspose.PoseNetOutput(
            None, None, None, None, noisy(b["rotation"][:, :, 1], 0.02, True),
            noisy(b["rotation"][:, :, 0], 0.02, True), jnp.full(n_crops, 0.9, jnp.float32),
            jnp.full(n_crops, 0.8, jnp.float32), noisy(b["translation"], 0.005),
            noisy(b["fsnet_scale"], 0.004))
        monkeypatch.setattr(jhspose, "eval_forward", lambda *a, **kw: out)
    else:
        _pin_jax_pooling(monkeypatch, 1000, 1028)
    want, RT, s = _capture_tables(monkeypatch, jfmp, jmodel, params, stats, n_crops)
    got = fmp.assemble(batches, [(RT, s)])
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TABLE_PTS, (k, got[k], want[k])
    if case == "near_gt":
        assert min(want.values()) > 0, want
        return
    (p_RT, p_s), = fmp.predict(model, batches)
    np.testing.assert_allclose(p_RT, RT, rtol=0, atol=PREDICT_RT_ATOL)
    np.testing.assert_allclose(p_s, s, rtol=0, atol=PREDICT_S_ATOL)


ROUTES = {"default": [], "recompute": ["model.bwd_store=false"],
          "v4": ["model.bwd_store=false", "model.train_v4_small=true"]}


@pytest.mark.parametrize("route", list(ROUTES))
def test_convergence_artifact_set_pass_through(tmp_path, route):
    overrides = ROUTES[route]
    trained, init = ca.run_dirs(str(tmp_path), "bfloat16", overrides)
    tag = "bfloat16" + "".join("_" + o.replace("=", "-") for o in overrides)
    assert (trained, init) == (str(tmp_path / f"conv_{tag}"), str(tmp_path / f"conv_init_{tag}"))
    cmd = ca.train_cmd("TREE", trained, 3000, "bfloat16", overrides)
    assert cmd[1:4] == ["-u", "-m", "hspose_tpu_torch.engine.train"]
    assert cmd[len(cmd) - len(overrides):] == overrides  # after the recipe
    cfg = parse_overrides(cmd[4:])  # what the train CLI parses
    assert (cfg.model.compute_dtype, cfg.train.batch_size, cfg.train.train_steps,
            cfg.train.model_save) == ("bfloat16", 24, 3000, trained)
    assert cfg.model.bwd_store == (route == "default")
    assert cfg.model.train_v4_small == (route == "v4")
    assert not any(tmp_path.iterdir())  # nothing ran
    with pytest.raises(AttributeError):
        ca.run_dirs(str(tmp_path), "bfloat16", ["model.bwd_stor=false"])


def test_convergence_artifact_sample_mode(tmp_path):
    """``--sample-mode device`` reaches the train CLI as data.sample_mode and
    the eval CLI as eval.sample_mode, and names the run directories; host
    mode keeps the names it had."""
    assert ca.run_dirs(str(tmp_path), "float32") == (str(tmp_path / "conv_float32"),
                                                     str(tmp_path / "conv_init_float32"))
    trained, init = ca.run_dirs(str(tmp_path), "float32", ["model.bwd_store=false"], "device")
    assert (trained, init) == (str(tmp_path / "conv_float32_model.bwd_store-false_device"),
                               str(tmp_path / "conv_init_float32_model.bwd_store-false_device"))
    for mode in ("host", "device"):
        cmd = ca.train_cmd("TREE", trained, 3000, "float32", ["model.bwd_store=false"],
                           sample_mode=mode)
        cfg = parse_overrides(cmd[4:])
        assert (cfg.data.sample_mode, cfg.model.bwd_store) == (mode, False)
        cmd = ca.eval_cmd("TREE", "CKPT", trained, mode)
        assert cmd[1:4] == ["-u", "-m", "hspose_tpu_torch.evaluation.evaluate"]
        cfg = parse_overrides(cmd[4:])
        assert (cfg.eval.sample_mode, cfg.train.resume_model) == (mode, "CKPT")
    assert not any(tmp_path.iterdir())


def test_train_sanity_main_returns_a_verdict(tmp_path):
    out = tmp_path / "sanity.json"
    rec = ts.main(2, batch_size=2, overrides=["data.num_points=256"], device="cpu",
                  json_path=str(out))
    assert isinstance(rec["pass"], bool)
    for k in ("before", "after"):
        assert all(np.isfinite(v) for v in rec[k].values()), rec[k]
    assert rec["route"] == {"compute_dtype": "float32", "bwd_store": True,
                            "train_v4_small": False}
    assert json.loads(out.read_text())["pass"] == rec["pass"]


def test_fast_mode_parity_main_gates_serve_k16(tmp_path, monkeypatch):
    monkeypatch.setattr(fmp, "N_PTS", 256)
    monkeypatch.setattr(fmp, "N_CROPS", 8)
    monkeypatch.setattr(fmp, "EVAL_BS", 4)
    rec = fmp.main(1, easy=True, device="cpu", json_path=str(tmp_path / "fmp.json"))
    assert list(rec["tables"]) == ["fp32", "bf16", "bf16+k16", "bf16+k12", "fp32+k16"]
    assert rec["gated"] == ["bf16", "bf16+k16"]
    assert rec["map_ok"] == (max(rec["worst_delta"][n] for n in rec["gated"])
                             <= fmp.HEADLINE_BUDGET_PTS and rec["mass_5d2cm_pct"] >= 60.0)
    assert rec["pass"] == (rec["map_ok"] and rec["screen"]["pass"])
    assert json.loads((tmp_path / "fmp.json").read_text())["gated"] == rec["gated"]


def test_probes_import_neither_jax_nor_hspose_tpu_nor_scripts():
    files = [REPO / "hspose_tpu_torch" / "tools" / f for f in
             ("train_sanity.py", "fast_mode_parity.py", "convergence_artifact.py")]
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "jaxlib", "flax", "hspose_tpu", "scripts", "train_sanity",
              "fast_mode_parity")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not [n for n in names if n.split(".")[0] in banned], (f.name, names)
    code = ("import sys\n"
            "import hspose_tpu_torch.tools.fast_mode_parity, hspose_tpu_torch.tools.train_sanity\n"
            "import hspose_tpu_torch.tools.convergence_artifact, chip_smoke\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{banned!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
