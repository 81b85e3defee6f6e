"""Device sampling (``data.sample_mode=device``, ``eval.sample_mode=device``)
of the port against the JAX package on the CPU.

The port's ``ops/sampling.py`` and ``data/preprocess.py`` take their scores
as an argument; each test hands them the JAX package's own draws
(``jax.random.uniform`` of ``jax.random.split`` of the key the JAX code
uses).  Tolerances, each with its reason:

* ``sample_points_fixed``, ``roi_to_pointcloud``: bit for bit.  The same
  fp32 operations in the same order (a true division by fx / fy, the
  multiply by fp32(1e-3) that XLA makes of ``/ 1000``), and a stable sort
  for ``lax.top_k``, which orders tied scores by the lower index first;
* ``backproject_roi`` against the host back-projection: 1e-2 mm, the JAX
  package's own gate (tests/test_data_pipeline.py::TestDevicePreprocessParity;
  the host path runs in float64);
* device-mode batches and eval records: the same numpy code on the same
  inputs, bit for bit, on both decode paths and through the spawned pool;
* one fp32 device-mode train step: the gates of tests/test_torch_port_train.py
  (loss 1e-3 relative; the update, all leaves as one vector, norm_rel 5e-2
  and cosine 0.999), with the cloud sampled inside the step bit for bit
  JAX's;
* the device-mode harness: poses within 5e-4, tests/test_torch_port_eval.py's
  gate for the harness.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hspose_tpu.evaluation.eval_dataset as j_eval_dataset
import hspose_tpu.ops.sampling as jsampling
import hspose_tpu.utils.params_io as j_params_io
from hspose_tpu.config import DataConfig as JDataConfig
from hspose_tpu.config import default_config
from hspose_tpu.config import parse_overrides as j_parse_overrides
from hspose_tpu.data import dataset as jds
from hspose_tpu.data import native_preproc as jnpp
from hspose_tpu.data.preprocess import roi_to_pointcloud as j_roi_to_pointcloud
from hspose_tpu.engine.train_step import build_train_step as j_build_train_step
from hspose_tpu.evaluation.evaluate import evaluate as j_evaluate
from hspose_tpu_torch.config import DataConfig, HSPoseConfig, OptimConfig, parse_overrides
from hspose_tpu_torch.data import dataset as pds
from hspose_tpu_torch.data.preprocess import CROP_KEYS, backproject_roi, roi_to_pointcloud
from hspose_tpu_torch.engine.checkpoint import latest_checkpoint
from hspose_tpu_torch.engine.train import check_trainable
from hspose_tpu_torch.engine.train_step import build_train_step, to_device
from hspose_tpu_torch.evaluation import eval_dataset as port_eval_dataset
from hspose_tpu_torch.evaluation import evaluate as port_eval
from hspose_tpu_torch.models.hspose import build_model, draw_train, train_forward
from hspose_tpu_torch.ops.sampling import batched_sample_points, sample_points_fixed
from hspose_tpu_torch.utils.convert import port_name
import test_data_pipeline
from test_torch_port_eval import (  # noqa: F401  (weights: fixture)
    N_HARNESS,
    POSE_ATOL,
    jit_init_variables,
    perms_for,
    pinned_pooling,
    read_preds,
    samples_of,
    stable_hash,
    weights,
)
from test_torch_port_train import B, N, Pinned, _flat, jax_model, port_model  # noqa: F401

torch.set_num_threads(2)  # the suite runs several workers on one host
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = jnpp.get_lib() is not None
S = 256  # data.img_size: a crop is S x S pixels
N_OUT = 1028


def t(x):
    return torch.from_numpy(np.array(x))


def jax_scores(key, b, n):
    """The uniform draws JAX's ``roi_to_pointcloud(key, ...)`` makes: one
    row per crop, from ``jax.random.split(key, b)``."""
    return np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key, b)])


@pytest.fixture(scope="module")
def nocs_root(tmp_path_factory):
    """The ``nocs_root`` scene of tests/test_data_pipeline.py, its depth
    noise seeded by ``zlib.crc32`` as in tests/test_torch_port_eval.py, with
    its test image listed twice: four detection crops, so the harness test
    runs a full batch of 3 and a padded one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_data_pipeline, "hash", stable_hash, raising=False)
        root = test_data_pipeline.nocs_root.__wrapped__(tmp_path_factory)
    with open(os.path.join(root, "Real", "test_list.txt"), "a") as f:
        f.write("test/scene_2/0000\n")
    return root


def configs(root, native, **over):
    return (JDataConfig(dataset="Real", dataset_dir=root, num_workers=0, native_preproc=native,
                        **over),
            DataConfig(dataset="Real", dataset_dir=root, num_workers=0, native_preproc=native,
                       **over))


def assert_batches_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def cloud_case(case, n=S * S):
    """(points (n, 3), valid (n,), scores (n,) or None for JAX's own draws)."""
    rng = np.random.default_rng(len(case))
    points = rng.normal(size=(n, 3)).astype(np.float32)
    valid = {"many": rng.uniform(size=n) < 0.3, "short": np.isin(np.arange(n), [5, 77, 4000]),
             "empty": np.zeros(n, bool), "ties": rng.uniform(size=n) < 0.5}[case]
    # eight score values: every valid score ties with thousands of others
    scores = (np.floor(rng.uniform(size=n) * 8) / 8).astype(np.float32) if case == "ties" else None
    return points, valid, scores


@pytest.mark.parametrize("case", ["many", "short", "empty", "ties"])
def test_sample_points_fixed_matches_jax(case, monkeypatch):
    points, valid, scores = cloud_case(case)
    key = jax.random.key(7)
    if scores is None:
        scores = np.asarray(jax.random.uniform(key, (len(points),)))
    else:
        monkeypatch.setattr(jsampling, "jax", SimpleNamespace(
            lax=jax.lax, random=SimpleNamespace(uniform=lambda k, shape: jnp.asarray(scores))))
    want = np.asarray(jsampling.sample_points_fixed(key, jnp.asarray(points), jnp.asarray(valid),
                                                    N_OUT))
    got = sample_points_fixed(t(scores), t(points), t(valid), N_OUT).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "many":  # uniform fp32 draws tie among the valid points too
        s = scores[valid]
        assert len(np.unique(s)) < len(s)
    if case in ("many", "ties"):  # valid points by score, ties to the lower index
        order = np.lexsort((np.arange(len(points)), -(scores + valid)))
        np.testing.assert_array_equal(got, points[order[:N_OUT]])
    if case == "short":  # three valid points, tiled in score order
        np.testing.assert_array_equal(got[3:], np.tile(got[:3], (N_OUT // 3, 1))[:N_OUT - 3])
    batched = batched_sample_points(t(np.stack([scores] * 2)), t(np.stack([points] * 2)),
                                    t(np.stack([valid] * 2)), N_OUT)
    np.testing.assert_array_equal(batched.numpy(), np.stack([got] * 2))


def device_samples(root, n, native=True, seed=3):
    """``n`` device-mode train samples of the scene (the port's loader)."""
    _, cfg = configs(root, native)
    ds = pds.PoseTrainDataset(cfg, sample_mode="device")
    rng = np.random.default_rng(seed)
    return [ds.get_sample(ds.sample_index(rng), rng) for _ in range(n)]


def crop_batch(root):
    """Two real crops, one with 13 valid pixels (fewer than the cloud's
    points: it tiles) and one with none."""
    samples = device_samples(root, 4)
    batch = {k: np.stack([s[k] for s in samples]) for k in CROP_KEYS}
    batch["roi_mask"][2] = 0
    rows, cols = np.nonzero(batch["roi_depth"][2] > 0)
    batch["roi_mask"][2, rows[:13], cols[:13]] = 1
    batch["roi_mask"][3] = 0
    return batch


@pytest.mark.parametrize("n_pts", [N_HARNESS, N_OUT])
def test_roi_to_pointcloud_matches_jax(nocs_root, n_pts):
    batch = crop_batch(nocs_root)
    key = jax.random.key(n_pts)
    want, want_n = j_roi_to_pointcloud(key, *(jnp.asarray(batch[k]) for k in CROP_KEYS), n_pts)
    got, got_n = roi_to_pointcloud(t(jax_scores(key, 4, S * S)),
                                   *(t(batch[k]) for k in CROP_KEYS), n_pts)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n.dtype == torch.int32 and got_n[2] == 13 and got_n[3] == 0 and got_n[0] > n_pts
    assert got.shape == (4, n_pts, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_backproject_matches_host(nocs_root):
    """The valid points equal the host back-projection (float64) within
    1e-2 mm."""
    for s in device_samples(nocs_root, 3):
        pts, valid = backproject_roi(*(t(s[k]) for k in CROP_KEYS))
        host = pds.host_depth_to_pcl(s["roi_depth"], s["cam_k"], s["roi_coord"], s["roi_mask"])
        dev = pts.numpy()[valid.numpy()]
        assert dev.shape == host.shape and len(host) > 50
        np.testing.assert_allclose(dev, host, rtol=0, atol=1e-2)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_device_batches_match_jax(nocs_root, native):
    """``_make_batch_from`` in device mode against the JAX loader's: the
    crops in place of the cloud, no 50-point rule, no sampling draw."""
    if native and not NATIVE:
        pytest.skip("native preproc library unavailable")
    jcfg, pcfg = configs(nocs_root, native)
    jd = jds.PoseTrainDataset(jcfg, sample_mode="device")
    pd = pds.PoseTrainDataset(pcfg, sample_mode="device")
    for seed, step in ((0, 0), (5, 3), (11, 7), (1677330429, 1499)):
        got = pds._make_batch_from(pd, seed, step, 3)
        assert_batches_equal(got, jds._make_batch_from(jd, seed, step, 3),
                             f"seed {seed} step {step}")
        assert "pcl_in" not in got and got["roi_depth"].shape == (3, S, S)
        assert got["roi_coord"].shape == (3, 2, S, S) and got["cam_k"].shape == (3, 3, 3)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_device_eval_records_match_jax(nocs_root, native):
    if native and not NATIVE:
        pytest.skip("native preproc library unavailable")
    det = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    jcfg, pcfg = configs(nocs_root, native, detection_dir=det)
    want = j_eval_dataset.PoseEvalDataset(jcfg, sample_mode="device").get_image(
        0, np.random.default_rng(0))
    got = port_eval_dataset.PoseEvalDataset(pcfg, sample_mode="device").get_image(
        0, np.random.default_rng(0))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    assert got[0]["roi_depth"].shape == (2, S, S) and "pcl_in" not in got[0]


def test_device_pool_stream_matches_sync_and_jax(nocs_root):
    _, cfg = configs(nocs_root, False)
    ds = pds.PoseTrainDataset(cfg, sample_mode="device")
    sync = list(pds.train_batches(ds, 2, 4, seed=9))
    pool = pds.make_worker_pool(cfg, sample_mode="device", num_workers=2)
    try:
        pooled = list(pds.train_batches(ds, 2, 4, seed=9, pool=pool))
    finally:
        pool.terminate()
    jd = jds.PoseTrainDataset(configs(nocs_root, False)[0], sample_mode="device")
    for i, (a, b) in enumerate(zip(sync, pooled)):
        assert_batches_equal(b, a, "pool")
        assert_batches_equal(a, jds._make_batch_from(jd, 9, i, 2), f"jax step {i}")
    assert len(pooled) == 4


def test_sample_modes_are_checked(nocs_root):
    _, cfg = configs(nocs_root, False)
    for make in (pds.PoseTrainDataset, port_eval_dataset.PoseEvalDataset):
        with pytest.raises(ValueError, match="'host' or 'device'"):
            make(cfg, sample_mode="gpu")
    with pytest.raises(ValueError, match="'host' or 'device'"):
        check_trainable(parse_overrides(["data.sample_mode=gpu"]))


def test_crop_draws_come_last_and_are_needed():
    """The sampling scores are drawn after a cloud batch's draws, which stay
    as they were; a batch of crops without scores raises."""
    plain = draw_train(torch.Generator().manual_seed(4), 2, 128)
    crops = draw_train(torch.Generator().manual_seed(4), 2, 128, S * S)
    assert plain.sample_scores is None and crops.sample_scores.shape == (2, S * S)
    assert crops.sample_scores.dtype == torch.float32
    for draws_a, draws_b in zip(plain[:3], crops[:3]):
        for a, b in zip(draws_a, draws_b):
            assert torch.equal(a, b)
    assert torch.equal(crops.to("cpu").sample_scores, crops.sample_scores)
    batch = {k: t(v) for k, v in synthetic_crop_batch().items()}
    model = build_model(HSPoseConfig().model, device="cpu", train_heads=True).train()
    with pytest.raises(ValueError, match="sample_scores"):
        train_forward(HSPoseConfig(), model, batch, draws=plain)


def synthetic_crop_batch():
    """A device-mode batch of B crops without files: the synthetic train
    batch's labels, a plane of depth and the pixel grid."""
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    batch = synthetic_train_batch(B, N, seed=1)
    del batch["pcl_in"]
    rng = np.random.default_rng(1)
    batch["roi_depth"] = rng.uniform(500, 700, (B, S, S)).astype(np.float32)
    batch["roi_mask"] = (rng.uniform(size=(B, S, S)) < 0.4).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(S), np.arange(S), indexing="xy")).astype(np.float32)
    batch["roi_coord"] = np.repeat(grid[None] + 100, B, 0)
    batch["cam_k"] = np.repeat(pds.REAL_INTRINSICS[None], B, 0)
    return batch


def test_device_train_step_matches_jax(jax_model, nocs_root, monkeypatch):
    """One fp32 step of build_train_step on a device-mode batch against JAX
    make_train_step on the same batch, weights and draws: the augmentation,
    pooling and dropout draws pinned as in tests/test_torch_port_train.py,
    the sampling scores JAX's own (its augment key, split over the batch)."""
    jmodel, _, _ = jax_model
    jcfg = default_config()
    jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim, lr=1e-3, warmup_iters=0),
                        data=dataclasses.replace(jcfg.data, num_points=N))
    cfg = HSPoseConfig().replace(optim=dataclasses.replace(OptimConfig(), lr=1e-3,
                                                           warmup_iters=0))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_points=N))
    _, pcfg = configs(nocs_root, False)
    batch = pds._make_batch_from(pds.PoseTrainDataset(pcfg, sample_mode="device"), 2, 5, B)
    pinned = Pinned(6, True)
    pinned.patch_jax(monkeypatch)
    _, state, jstep = j_build_train_step(jcfg, jmodel, jax.random.key(0))
    start = _flat(state.params)
    model = port_model(jax.device_get(state.params), jax.device_get(state.batch_stats))
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0))

    # the step's augment key, as make_train_step derives it at step 0
    k_aug = jax.random.split(jax.random.fold_in(jax.random.key(1), 0), 3)[0]
    scores = jax_scores(k_aug, B, S * S)
    want_pc, _ = j_roi_to_pointcloud(k_aug, *(jnp.asarray(batch[k]) for k in CROP_KEYS), N)
    got_pc, _ = roi_to_pointcloud(t(scores), *(t(batch[k]) for k in CROP_KEYS), N)
    np.testing.assert_array_equal(got_pc.numpy(), np.asarray(want_pc))

    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    m = step(to_device(batch, "cpu"), pinned.port()._replace(sample_scores=t(scores)))
    assert set(m) == set(jm) and m["skipped_nan"] == 0.0
    np.testing.assert_allclose(m["total_loss"], float(jm["total_loss"]), rtol=1e-3)
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


def jittered(get_image):
    """get_image plus up to 0.1 mm of depth noise on the crops' non-zero
    depth, drawn from the image index, the same in both packages.  The
    scene's depth is integer millimetres on the pixel grid, so its clouds lie
    on a lattice whose equal neighbour distances the two frameworks' fp32 KNN
    break apart in different orders (tests/test_torch_port_eval.py jitters
    its host-sampled clouds for the same reason)."""
    def get_image_jittered(self, index, rng):
        rec = get_image(self, index, rng)
        depth = rec[0]["roi_depth"]
        noise = np.random.default_rng(index).uniform(0, 0.1, depth.shape).astype(np.float32)
        rec[0]["roi_depth"] = np.where(depth > 0, depth + noise, depth)
        return rec
    return get_image_jittered


@pytest.fixture(scope="module")
def device_harness(weights, nocs_root, tmp_path_factory):  # noqa: F811
    """The JAX and the port's ``evaluate`` in device mode on the same scene,
    weights, pool samples and per-batch scores: JAX draws batch i's scores
    from ``fold_in(key(eval_seed), i)``, the port is handed them."""
    _, _, path = weights
    out = tmp_path_factory.mktemp("eval")
    detections = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    seed, bs = 5, 3
    args = [f"data.dataset_dir={nocs_root}", f"data.detection_dir={detections}",
            "data.num_workers=0", f"data.num_points={N_HARNESS}", f"train.resume_model={path}",
            f"eval.eval_seed={seed}", f"eval.eval_batch={bs}", "eval.sample_mode=device"]
    perms = perms_for(N_HARNESS, 21)
    scores = [t(jax_scores(jax.random.fold_in(jax.random.key(seed), i), bs, S * S))
              for i in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        pinned_pooling(mp, perms)
        mp.setattr(j_params_io, "init_variables", jit_init_variables)
        for cls in (j_eval_dataset.PoseEvalDataset, port_eval_dataset.PoseEvalDataset):
            mp.setattr(cls, "get_image", jittered(cls.get_image))
        j_evaluate(j_parse_overrides(args + [f"train.model_save={out / 'jax'}"]))
        port_eval.evaluate(parse_overrides(args + [f"train.model_save={out / 'port'}"]),
                           device="cpu", pool_samples=samples_of(perms, N_HARNESS),
                           sample_scores=scores)
    return out / "jax" / "eval_result_hspose", out / "port" / "eval_result_hspose"


def test_device_harness_poses_match_jax(device_harness):
    jdir, pdir = device_harness
    want, got = read_preds(jdir), read_preds(pdir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g["pred_class_ids"]) == 2
        for key in ("pred_RTs", "pred_scales"):
            assert np.isfinite(g[key]).all() and np.abs(g[key]).max() > 0, key
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=POSE_ATOL, err_msg=key)
    # the two copies of the image were sampled with other scores
    assert not np.array_equal(got[0]["pred_RTs"], got[1]["pred_RTs"])


def test_device_harness_draws_from_its_generator(nocs_root):
    """Without injected draws the harness samples from its seeded generator:
    the same seed gives the same poses, another seed others."""
    detections = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    cfg = parse_overrides([f"data.dataset_dir={nocs_root}", f"data.detection_dir={detections}",
                           f"data.num_points={N_HARNESS}", "eval.eval_batch=3",
                           "eval.sample_mode=device"])
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu")
    records = port_eval.load_eval_images(cfg, seed=0, num_workers=1)
    assert "roi_depth" in records[0][0]

    def poses(seed):
        recs = [(d, dict(det), g) for d, det, g in records]
        preds, _ = port_eval.batched_pose_inference(cfg, model, recs, seed)
        return np.concatenate([p["pred_RTs"] for p in preds])

    first = poses(1)
    assert np.isfinite(first).all()
    np.testing.assert_array_equal(poses(1), first)
    assert not np.array_equal(poses(2), first)


def test_device_train_cli_checkpoint_eval_cli(nocs_root, tmp_path):
    """``HSPOSE_PLATFORM=cpu python -m hspose_tpu_torch.engine.train
    data.sample_mode=device`` with the spawned worker pool, then the eval CLI
    with ``eval.sample_mode=device`` on its checkpoint."""
    env = dict(os.environ, HSPOSE_PLATFORM="cpu")
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "hspose_tpu_torch.engine.train", f"data.dataset_dir={nocs_root}",
         f"data.num_points={N_HARNESS}", "data.num_workers=1", "data.sample_mode=device",
         "train.batch_size=2", "train.train_steps=2", "train.total_epoch=1",
         "train.log_every=1", "train.seed=5", f"train.model_save={out}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "sample mode: device" in proc.stdout and "loader workers: 1" in proc.stdout
    assert "epoch 0 step 1 total_loss" in proc.stdout
    ckpt = latest_checkpoint(str(out))
    assert ckpt == str(out / "model_000")
    det = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    proc = subprocess.run([sys.executable, "-m", "hspose_tpu_torch.evaluation.evaluate",
                           f"data.dataset_dir={nocs_root}", f"data.detection_dir={det}",
                           f"data.num_points={N_HARNESS}", "data.num_workers=0",
                           "eval.eval_batch=3", "eval.sample_mode=device", "eval.eval_seed=3",
                           f"train.resume_model={ckpt}", f"train.model_save={tmp_path / 'eval'}"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "3D IoU at 25:" in proc.stdout
    preds = read_preds(tmp_path / "eval" / "eval_result_model_000")
    assert len(preds) == 2 and all(np.isfinite(p["pred_RTs"]).all() for p in preds)


def test_new_modules_import_neither_jax_nor_hspose_tpu():
    code = (
        "import importlib, sys\n"
        "for m in ('ops.sampling', 'data.preprocess', 'evaluation', 'evaluation.metrics_legacy',\n"
        "          'evaluation.visualize', 'models.hspose', 'engine.train',\n"
        "          'evaluation.evaluate', 'tools.convergence_artifact',\n"
        "          'tools.sample_mode_split'):\n"
        "    importlib.import_module('hspose_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hspose_tpu', 'cv2', 'matplotlib'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
