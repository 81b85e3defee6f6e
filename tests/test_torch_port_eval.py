"""The port's eval harness, weight loading and recon-metric tier against the
JAX package on the CPU.

The weights are a JAX training init (train heads included) with randomised
BatchNorm statistics, written as a reference-format ``.pth`` by the JAX
package's ``convert_to_torch_state_dict``; the port reads it with no JAX in
between.  Pooling is pinned: JAX's permutation is replaced by a numpy-seeded
one and the same kept rows go to the port.  The harness runs on the
``nocs_root`` scene of ``tests/test_data_pipeline.py`` (one image, two
detections) at 128 points, batches of 4, so every batch is padded, with
0.1 mm of shared noise on the sampled clouds (``jittered``).
Tolerances, each with its reason:

* weights: copied values, bit for bit;
* ``eval_forward(with_heads=True)``: fp32 summation-order noise growing with
  depth, as tests/test_torch_port_model.py: 2e-4 at N=128, 5e-4 at
  N=1028, on the recon cloud and the face outputs too.  The bf16 tier:
  tests/test_torch_port_bf16.py's 1e-2, against the JAX bf16 forward on the
  Pallas packed-key KNN;
* the harness's poses: 5e-4 (the N=1028 forward's bound); its chamfer and
  EMD: 1e-3 relative (fp32 noise of the recon cloud through 200 Sinkhorn
  sweeps);
* the metric code, the eval dataset and the report lines: the same numpy
  code on the same inputs, bit for bit;
* K5 (the exact KNN above N = 2048): the port's plain version forms fp32
  distances as |a|^2 + |b|^2 - 2 a.b, the streamed Pallas kernel as a sum of
  squared differences (xyz) or a product summed in another order: >= 99.9%
  of the neighbours agree and a swapped neighbour's exact distance is
  within 1e-4 relative of the one it replaced.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import zlib
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.evaluation.eval_dataset as j_eval_dataset
import hspose_tpu.models.face_recon as jface_recon
import hspose_tpu.models.layers as jlayers
import hspose_tpu.utils.params_io as j_params_io
from hspose_tpu.config import parse_overrides as j_parse_overrides
from hspose_tpu.evaluation.eval_dataset import PoseEvalDataset as JPoseEvalDataset
from hspose_tpu.evaluation.evaluate import evaluate as j_evaluate
from hspose_tpu.evaluation.evaluate import report_lines as j_report_lines
from hspose_tpu.evaluation.metrics import aggregate_recon_metrics as j_aggregate
from hspose_tpu.evaluation.metrics import compute_degree_cm_mAP as j_mAP
from hspose_tpu.models.hspose import build_model as j_build_model
from hspose_tpu.models.hspose import eval_forward as j_eval_forward
from hspose_tpu.ops.pallas_knn import knn_indices_pallas
from hspose_tpu.utils.torch_convert import convert_to_torch_state_dict
from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, parse_overrides
from hspose_tpu_torch.evaluation import eval_dataset as port_eval_dataset
from hspose_tpu_torch.evaluation import evaluate as port_eval
from hspose_tpu_torch.evaluation.eval_dataset import PoseEvalDataset
from hspose_tpu_torch.evaluation.metrics import aggregate_recon_metrics, compute_degree_cm_mAP
from hspose_tpu_torch.geometry.symmetry import SYNSET_NAMES
from hspose_tpu_torch.models.hspose import build_model, eval_forward
from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
from hspose_tpu_torch.ops.knn import knn_indices
from hspose_tpu_torch.utils.convert import load_jax_params
from hspose_tpu_torch.utils.params_io import load_torch_checkpoint
import test_data_pipeline

torch.set_num_threads(2)  # the suite runs several workers on one host
REPO = Path(__file__).resolve().parents[1]
N_HARNESS = 128
HEADS = ("conv1d_block", "recon_head", "face_head")
POSE_ATOL = 5e-4
RECON_REL = 1e-3
KNN_AGREE = 0.999
KNN_SWAP_REL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def perms_for(n, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.permutation(n), n // 4: rng.permutation(n // 4)}


def samples_of(perms, n):
    return [t(perms[n][:n // 4]), t(perms[n // 4][:n // 16])]


def pinned_pooling(mp, perms):
    mp.setattr(jlayers.jax.random, "permutation", lambda key, n, **kw: jnp.asarray(perms[n]))


def jit_init_variables(cfg):
    """``hspose_tpu.utils.params_io.init_variables`` under ``jax.jit``: the
    same variables, built in a third of the time on the CPU."""
    model = j_build_model(cfg)
    n = cfg.data.num_points
    init = jax.jit(lambda: model.init(
        {"params": jax.random.key(0), "pool": jax.random.key(1), "dropout": jax.random.key(2)},
        np.zeros((1, n, 3), np.float32), np.zeros((1,), np.int32), True))
    return model, init()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(params, batch_stats, path of the reference-format .pth) of a JAX
    training init with randomised BatchNorm statistics."""
    rng = np.random.default_rng(11)
    _, variables = jit_init_variables(j_parse_overrides([f"data.num_points={N_HARNESS}"]))
    params = jax.device_get(variables["params"])
    flat = flax.traverse_util.flatten_dict(jax.device_get(variables["batch_stats"]))
    stats = flax.traverse_util.unflatten_dict({
        k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
            else rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        for k, v in flat.items()})
    path = tmp_path_factory.mktemp("weights") / "hspose.pth"
    save_pth(convert_to_torch_state_dict(params, stats), path)
    return params, stats, str(path)


def save_pth(state_dict, path):
    torch.save({"posenet_state_dict": {k: t(v) for k, v in state_dict.items()}}, path)


def assert_same_tensors(model, ref):
    got, want = model.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k


def test_pth_loads_bit_for_bit_as_load_jax_params(weights):
    params, stats, path = weights
    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    load_torch_checkpoint(model, path)
    ref = build_model(ModelConfig(), device="cpu", train_heads=True)
    load_jax_params(ref, params, stats)
    assert_same_tensors(model, ref)


def test_pth_with_legacy_resconv_keys_loads(weights, tmp_path):
    params, stats, _ = weights
    sd = {k.replace("STE_layer", "resconv"): v
          for k, v in convert_to_torch_state_dict(params, stats).items()}
    assert any("resconv" in k for k in sd)
    save_pth(sd, tmp_path / "legacy.pth")
    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    load_torch_checkpoint(model, str(tmp_path / "legacy.pth"))
    ref = build_model(ModelConfig(), device="cpu", train_heads=True)
    load_jax_params(ref, params, stats)
    assert_same_tensors(model, ref)


def test_pth_without_train_heads_loads_into_eval_model(weights, tmp_path):
    """A pruned checkpoint loads into an eval model, and into a model with
    the train heads, whose heads keep their own values; a full checkpoint
    loads into an eval model, its heads dropped."""
    params, stats, full = weights
    sd = {k: v for k, v in convert_to_torch_state_dict(params, stats).items()
          if not any(f".{h}." in k for h in HEADS)}
    save_pth(sd, tmp_path / "pruned.pth")
    eval_params = {**params, "face_recon": {k: v for k, v in params["face_recon"].items()
                                            if k not in HEADS}}
    eval_stats = {**stats, "face_recon": {k: v for k, v in stats["face_recon"].items()
                                          if k not in HEADS}}
    ref = build_model(ModelConfig(), device="cpu")
    load_jax_params(ref, eval_params, eval_stats)
    for path in (tmp_path / "pruned.pth", full):
        model = build_model(ModelConfig(), device="cpu")
        load_torch_checkpoint(model, str(path))
        assert_same_tensors(model, ref)
    model = build_model(ModelConfig(), device="cpu", train_heads=True)
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if k.split(".")[1] in HEADS}
    load_torch_checkpoint(model, str(tmp_path / "pruned.pth"))
    state = model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in heads.items())
    name = "face_recon.conv_1.weights"
    assert torch.equal(state[name], ref.state_dict()[name])


@pytest.mark.parametrize("N,dtype,atol", [(128, "float32", 2e-4), (1028, "float32", 5e-4),
                                          (128, "bfloat16", 1e-2)])
def test_eval_forward_with_heads_matches_jax(weights, N, dtype, atol):
    params, stats, path = weights
    jcfg = j_parse_overrides([f"model.compute_dtype={dtype}"])
    rng = np.random.default_rng(N)
    pts = (rng.normal(scale=0.2, size=(2, N, 3)) + [0.1, -0.05, 0.6]).astype(np.float32)
    obj = np.array([1, 5], np.int32)
    perms = perms_for(N, N + 1)
    with pytest.MonkeyPatch.context() as mp:
        pinned_pooling(mp, perms)
        if dtype == "bfloat16":  # the JAX CPU path would take the exact XLA search
            mp.setattr(jface_recon, "knn_indices_fast",
                       lambda p, kk, fast=False, source=None:
                       knn_indices_pallas(p, kk, fast=True, interpret=True))
        jmodel = j_build_model(jcfg)
        want = jax.jit(lambda p, s, x, o: j_eval_forward(jmodel, p, s, jax.random.key(3), x, o,
                                                         with_heads=True))(
            params, stats, jnp.asarray(pts), jnp.asarray(obj))
    model = build_model(ModelConfig(compute_dtype=dtype), device="cpu", train_heads=True)
    load_torch_checkpoint(model, path)
    got = eval_forward(model, t(pts), t(obj), pool_samples=samples_of(perms, N), with_heads=True)
    assert not model.training and got.recon.shape == (2, N, 3)
    for name in got._fields:
        g = getattr(got, name)
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def harness(weights, nocs_root, tmp_path_factory):  # noqa: F811
    """The JAX and the port's ``evaluate`` on the same scene, weights and
    pool samples, with ``eval.recon``: (JAX output dir, port output dir,
    port summary, overrides)."""
    _, _, path = weights
    out = tmp_path_factory.mktemp("eval")
    detections = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    args = [f"data.dataset_dir={nocs_root}", f"data.detection_dir={detections}",
            "data.num_workers=0", f"data.num_points={N_HARNESS}", f"train.resume_model={path}",
            "eval.eval_seed=5", "eval.eval_batch=4", "eval.recon=true"]
    perms = perms_for(N_HARNESS, 21)
    with pytest.MonkeyPatch.context() as mp:
        pinned_pooling(mp, perms)
        # the template JAX's load_torch_checkpoint merges into, built jitted
        mp.setattr(j_params_io, "init_variables", jit_init_variables)
        for module in (j_eval_dataset, port_eval_dataset):
            mp.setattr(module, "host_sample_points", jittered(module.host_sample_points))
        j_evaluate(j_parse_overrides(args + [f"train.model_save={out / 'jax'}"]))
        summary = port_eval.evaluate(parse_overrides(args + [f"train.model_save={out / 'port'}"]),
                                     device="cpu", pool_samples=samples_of(perms, N_HARNESS))
    return out / "jax" / "eval_result_hspose", out / "port" / "eval_result_hspose", summary, args


def jittered(sample):
    """host_sample_points plus 0.1 mm of noise from the same generator.  The
    scene's depth is integer millimetres, so its clouds lie on a lattice
    whose equal neighbour distances the two frameworks' fp32 KNN break apart
    in different orders (a flip moved a pose by 8.5e-4); both packages draw
    the same noise from their identical generators, which leaves a generic
    cloud."""
    def sample_jittered(rng, pcl, n_pts):
        out = sample(rng, pcl, n_pts)
        return out + rng.normal(scale=1e-4, size=out.shape).astype(np.float32)
    return sample_jittered


def stable_hash(obj):
    return zlib.crc32(repr(obj).encode())


@pytest.fixture(scope="module")
def nocs_root(tmp_path_factory):
    """The ``nocs_root`` scene of ``tests/test_data_pipeline.py`` with its
    depth noise drawn from a fixed seed.  Its ``_write_scene`` seeds each
    image from ``hash((scene, img_id))``, which Python randomises per
    process, so every run would draw another scene; on a few of them the
    two packages' fp32 distances pick different neighbours at a near-tie
    (candidates closer than the rounding of the ||q||^2 + ||c||^2 - 2 q.c
    expansion both use) and a pose moves by up to about 1e-3, which made
    ``test_harness_poses_and_recon_metrics_match_jax`` pass or fail by the
    run (``tests/_harness_knn_splits.py`` shows the candidates for a given
    ``PYTHONHASHSEED``).  Here the seed is ``zlib.crc32`` of the same key,
    the same in every process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_data_pipeline, "hash", stable_hash, raising=False)
        return test_data_pipeline.nocs_root.__wrapped__(tmp_path_factory)


def read_preds(out_dir):
    with open(out_dir / "pred_result.pkl", "rb") as f:
        return pickle.load(f)


def test_harness_poses_and_recon_metrics_match_jax(harness):
    jdir, pdir, _, _ = harness
    want, got = read_preds(jdir), read_preds(pdir)
    assert len(got) == len(want) == 1 and len(got[0]["pred_class_ids"]) == 2
    for key in ("pred_RTs", "pred_scales"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=0, atol=POSE_ATOL, err_msg=key)
    for key in ("chamfer_dis_cass", "emd_dis_cass"):
        assert (got[0][key] > 0).all() and np.isfinite(got[0][key]).all(), key
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=RECON_REL, err_msg=key)
    for key in ("gt_class_ids", "gt_RTs", "gt_scales", "gt_handle_visibility"):
        np.testing.assert_array_equal(got[0][key], want[0][key], err_msg=key)
    assert aggregate_recon_metrics(got, SYNSET_NAMES).keys() == {"cmf", "emd"}


def test_harness_report_lines_match_jax(harness):
    """The mAP arrays each harness saved give the same report lines, for the
    mean and every category."""
    jdir, pdir, summary, _ = harness
    want, got = np.load(jdir / "mAP_data.npz"), np.load(pdir / "mAP_data.npz")
    deg, shift, iou = (list(got[k]) for k in ("degree_thres_list", "shift_thres_list",
                                              "iou_thres_list"))
    for idx in range(-1, len(SYNSET_NAMES)):
        assert (port_eval.report_lines(got["iou_3d_aps"], got["pose_aps"], deg, shift, iou, idx)
                == j_report_lines(want["iou_3d_aps"], want["pose_aps"], deg, shift, iou, idx))
    assert summary["IoU25"] == got["iou_3d_aps"][-1, iou.index(0.25)] * 100


def test_metrics_bit_identical_on_shared_predictions(harness):
    """compute_degree_cm_mAP and aggregate_recon_metrics on the JAX
    harness's predictions, and on perturbed ground truth (non-zero APs)."""
    jdir, _, _, _ = harness
    rng = np.random.default_rng(2)
    results = read_preds(jdir)
    for n in (3, 5):
        gt_RTs = np.tile(np.eye(4), (n, 1, 1))
        gt_RTs[:, :3, :3] = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        gt_RTs[:, :3, 3] = rng.normal(scale=0.3, size=(n, 3))
        pred_RTs = gt_RTs.copy()
        pred_RTs[:, :3, 3] += rng.normal(scale=0.02, size=(n, 3))
        cls = rng.integers(1, 7, n)
        results.append({
            "gt_class_ids": cls, "gt_RTs": gt_RTs, "gt_scales": rng.uniform(0.05, 0.3, (n, 3)),
            "gt_handle_visibility": rng.integers(0, 2, n), "pred_class_ids": cls,
            "pred_RTs": pred_RTs, "pred_scales": rng.uniform(0.05, 0.3, (n, 3)),
            "pred_scores": rng.uniform(size=n), "chamfer_dis_cass": rng.uniform(size=n),
            "emd_dis_cass": rng.uniform(size=n)})
    grids = (list(range(0, 61)), [i / 2 for i in range(21)], [i / 100 for i in range(101)])
    got = compute_degree_cm_mAP(results, SYNSET_NAMES, None, *grids, iou_pose_thres=0.1,
                                use_matches_for_pose=True)
    want = j_mAP(results, SYNSET_NAMES, None, *grids, iou_pose_thres=0.1,
                 use_matches_for_pose=True)
    assert got[1].max() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert aggregate_recon_metrics(results, SYNSET_NAMES) == j_aggregate(results, SYNSET_NAMES)


def test_eval_dataset_matches_jax(harness):
    _, _, _, args = harness
    for seed in (0, 7):
        got = PoseEvalDataset(parse_overrides(args).data).get_image(
            0, np.random.default_rng(seed))
        want = JPoseEvalDataset(j_parse_overrides(args).data).get_image(
            0, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_cli_prints_the_jax_harness_table(harness, tmp_path):
    """``python -m hspose_tpu_torch.evaluation.evaluate`` on the CPU
    (HSPOSE_PLATFORM=cpu) prints the JAX harness's mean table."""
    jdir, _, _, args = harness
    env = dict(os.environ, HSPOSE_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-m", "hspose_tpu_torch.evaluation.evaluate",
                           *args, f"train.model_save={tmp_path}"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = np.load(jdir / "mAP_data.npz")
    deg, shift, iou = (list(want[k]) for k in ("degree_thres_list", "shift_thres_list",
                                               "iou_thres_list"))
    lines = j_report_lines(want["iou_3d_aps"], want["pose_aps"], deg, shift, iou)
    printed = [line.split(" INFO ", 1)[1] for line in proc.stdout.splitlines() if " INFO " in line]
    start = printed.index("Evaluation Seed: 5") + 1
    assert printed[start:start + len(lines)] == lines
    assert (tmp_path / "eval_result_hspose" / "pred_result.pkl").exists()


@pytest.mark.parametrize("overrides,error,match", [
    (["parallel.mp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.dp=2", "parallel.mp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.dp=2"], RuntimeError, "torchrun --standalone"),
    (["parallel.sp=2", "data.num_points=4096"], RuntimeError, "torchrun --standalone"),
    (["parallel.sp=2", "data.num_points=4096", "eval.recon=true"], ValueError,
     "eval.recon is not supported with parallel.sp"),
    (["parallel.sp=2", "parallel.mp=2"], ValueError, "mutually exclusive"),
    (["parallel.sp=2"], ValueError, r"num_points % \(16\*sp\)")])
def test_harness_refuses_what_it_does_not_run(overrides, error, match):
    """The refusals of the JAX harness (with its messages: sp with mp, sp
    with recon, an N that does not shard), and dp, sp or mp without a
    process group: no one-device run instead."""
    cfg = parse_overrides(overrides)
    model = build_model(ModelConfig(), device="cpu")
    with pytest.raises(error, match=match):
        port_eval.batched_pose_inference(cfg, model, [], seed=0)


def test_parse_overrides_matches_jax():
    argv = ["data.num_points=2056", "--eval.recon=true", "eval.emd_iters=50",
            "model.compute_dtype=bfloat16", "train.resume_model=w.pth", "parallel.dp=1",
            "data.dzi_pad_scale=1.25", "data.dzi_type=roi10d", "data.dzi_scale_ratio=0.5",
            "data.dzi_shift_ratio=0.125", "data.roi_mask_r=2", "data.roi_mask_pro=0.75",
            "data.sample_method=basic", "data.sample_mode=device", "data.prefetch=2",
            "train.seed=1677330429", "train.save_every=3", "train.log_every=7",
            "train.resume=true", "train.resume_point=4"]
    got, want = parse_overrides(argv), j_parse_overrides(argv)
    for section in dataclasses.fields(HSPoseConfig):
        for f in dataclasses.fields(getattr(got, section.name)):
            assert (getattr(getattr(got, section.name), f.name)
                    == getattr(getattr(want, section.name), f.name)), (section.name, f.name)
    with pytest.raises(ValueError, match="section.key"):
        parse_overrides(["eval"])


@pytest.mark.parametrize("D", [3, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_knn_above_2048_matches_k5(D, dtype):
    """K5, the streamed Pallas KNN for padded N > 2048, against the port's
    plain exact search, which the wrapper runs there in both tiers (bf16
    points widened to fp32, an exact widening)."""
    rng = np.random.default_rng(D)
    pts = rng.normal(scale=0.2 if D == 3 else 1.0, size=(1, 2056, D)).astype(np.float32)
    jpts, tpts = jnp.asarray(pts), t(pts)
    if dtype == "bfloat16":
        jpts, tpts = jpts.astype(jnp.bfloat16), tpts.to(torch.bfloat16)
        pts = np.asarray(jpts.astype(jnp.float32))
    want = np.asarray(knn_indices_pallas(jpts, 20, fast=dtype == "bfloat16", interpret=True))
    got = knn_indices_cuda(tpts, 20, packed=dtype == "bfloat16").numpy()
    np.testing.assert_array_equal(got, knn_indices(t(pts), 20).numpy())
    agree = (got[..., :, None] == want[..., None, :]).any(-1).mean()
    assert agree >= KNN_AGREE, agree
    p = pts[0].astype(np.float64)
    for i in np.nonzero((got[0] != want[0]).any(-1))[0]:
        d = ((p[i] - p) ** 2).sum(-1)
        gs, ws = set(got[0, i].tolist()), set(want[0, i].tolist())
        for g, w in zip(sorted(gs - ws, key=lambda j: d[j]), sorted(ws - gs, key=lambda j: d[j])):
            assert abs(d[g] - d[w]) <= KNN_SWAP_REL * d[w], (i, g, w)


def test_new_modules_import_neither_jax_nor_hspose_tpu():
    code = (
        "import importlib, sys\n"
        "for m in ('evaluation.evaluate', 'evaluation.eval_dataset', 'evaluation.metrics',\n"
        "          'evaluation.native_matcher', 'geometry.boxes', 'geometry.symmetry',\n"
        "          'utils.torch_convert', 'utils.params_io', 'utils.logging', 'ops.chamfer',\n"
        "          'ops.emd', 'data.image_utils', 'data.native_preproc', 'data.dataset',\n"
        "          'engine.train', 'engine.checkpoint'):\n"
        "    importlib.import_module('hspose_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hspose_tpu', 'cv2', 'matplotlib'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
