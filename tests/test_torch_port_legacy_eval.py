"""The port's legacy NOCS mAP (``evaluation/metrics_legacy.py``) and drawing
helpers (``evaluation/visualize.py``) against the JAX package on the CPU.

Both are copies of numpy code run on the same inputs, so every gate is
exact: the four arrays of ``compute_mAP`` equal with their NaNs in the same
places, the written ``mAP_Acc.pkl`` the same, the projections and aligned
poses equal, and the overlay PNGs the same pixels.  The results are
``tests/test_metrics.py``'s fuzzed images (``TestLegacyReferenceParity``).
"""

import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest

from hspose_tpu.evaluation import visualize as jvis
from hspose_tpu.evaluation.metrics_legacy import compute_ap_and_acc as j_compute_ap_and_acc
from hspose_tpu.evaluation.metrics_legacy import compute_mAP as j_compute_mAP
from hspose_tpu_torch.evaluation import compute_mAP
from hspose_tpu_torch.evaluation import visualize as vis
from hspose_tpu_torch.evaluation.metrics_legacy import compute_ap_and_acc
import test_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]])
NAMES = ("iou_aps", "pose_aps", "iou_acc", "pose_acc")


def fuzz_results(seed, n_images=6):
    return test_metrics.TestLegacyReferenceParity._fuzz_results(
        None, np.random.default_rng(seed), n_images)


def assert_same_outputs(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)  # NaNs in the same places


def read_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("use_matches_for_pose", [False, True])
def test_compute_map_matches_jax(tmp_path, use_matches_for_pose, use_native):
    results = fuzz_results(3)
    grids = ([5, 10, 15], [2, 5, 10], [0.1, 0.25, 0.5])
    kw = dict(iou_pose_thres=0.25, use_matches_for_pose=use_matches_for_pose,
              use_native=use_native)
    got = compute_mAP(results, str(tmp_path / "port"), *grids, **kw)
    want = j_compute_mAP(results, str(tmp_path / "jax"), *grids, **kw)
    assert_same_outputs(got, want)
    assert got[0].shape == (8, 3) and got[1].shape == (8, 4, 4)
    assert np.isfinite(got[0]).all() and got[1].max() > 0
    a, b = read_pkl(tmp_path / "port" / "mAP_Acc.pkl"), read_pkl(tmp_path / "jax" / "mAP_Acc.pkl")
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_compute_map_cls_ids_subset_matches_jax():
    """A cls_ids subset: the classes left out keep the reference's buffer
    artefacts (IoU ap and acc 1.0) in the mean rows, and a class without
    predictions has a NaN accuracy, in both packages."""
    results = fuzz_results(5, n_images=4)
    got = compute_mAP(results, None, [10], [5], [0.25], cls_ids=[1, 3, 6])
    want = j_compute_mAP(results, None, [10], [5], [0.25], cls_ids=[1, 3, 6])
    assert_same_outputs(got, want)
    assert (got[0][[2, 4, 5]] == 1.0).all()
    empty = [{**r, "pred_class_ids": np.zeros(0, np.int32), "pred_RTs": np.zeros((0, 4, 4)),
              "pred_scales": np.zeros((0, 3)), "pred_scores": np.zeros(0)} for r in results]
    got = compute_mAP(empty, None, [10], [5], [0.25], cls_ids=[1, 3, 6])
    assert np.isnan(got[2]).any() and np.isnan(got[3]).any()
    assert_same_outputs(got, j_compute_mAP(empty, None, [10], [5], [0.25], cls_ids=[1, 3, 6]))


def test_compute_ap_and_acc_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7):
        pred_matches = rng.integers(-1, 3, n).astype(float)
        scores = rng.uniform(size=n)
        gt_matches = rng.integers(-1, 4, 5).astype(float)
        got = compute_ap_and_acc(pred_matches, scores, gt_matches)
        want = j_compute_ap_and_acc(pred_matches, scores, gt_matches)
        np.testing.assert_array_equal(np.array(got), np.array(want))
    assert np.isnan(compute_ap_and_acc(np.zeros(0), np.zeros(0), np.zeros(3))[1])


def random_sRT(rng, scale=1.3):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    sRT = np.eye(4)
    sRT[:3, :3] = scale * q
    sRT[:3, 3] = rng.normal(scale=0.3, size=3) + [0, 0, 1.5]
    return sRT


def test_align_rotation_and_projections_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        sRT = random_sRT(rng)
        got = vis.align_rotation(sRT)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jvis.align_rotation(sRT))
    pts = rng.normal(size=(3, 17)) + np.array([[0], [0], [3.0]])
    got = vis.calculate_2d_projections(pts, K)
    assert got.shape == (17, 2) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jvis.calculate_2d_projections(pts, K))


def test_draw_detections_writes_the_jax_image(tmp_path):
    """Predictions, ground truth and NOCS boxes, with classes that are
    aligned (bottle, can) and one that is not (camera)."""
    rng = np.random.default_rng(2)
    sRT = np.stack([random_sRT(rng) for _ in range(3)])
    sizes = np.abs(rng.normal(size=(3, 3))) * 0.1 + 0.1
    ids = [1, 3, 4]
    paths = []
    for name, module in (("port", vis), ("jax", jvis)):
        out = tmp_path / name
        out.mkdir()
        paths.append(module.draw_detections(
            np.zeros((480, 640, 3), np.uint8), str(out), "real_test", 7, K, sRT, sizes, ids,
            gt_sRT=sRT[::-1], gt_size=sizes, gt_class_ids=ids, nocs_sRT=sRT[[1, 2, 0]],
            nocs_size=sizes, nocs_class_ids=ids, draw_nocs=True))
    assert paths[0] == str(tmp_path / "port" / "real_test_7_pred.png")
    got, want = cv2.imread(paths[0]), cv2.imread(paths[1])
    assert got is not None and got.any()
    assert (got[..., 2] == 255).any() and (got[..., 1] == 255).any() and (got[..., 0] == 255).any()
    np.testing.assert_array_equal(got, want)


def test_plot_map_writes_a_figure(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    out = vis.plot_mAP(rng.uniform(size=(8, 11)), rng.uniform(size=(8, 7, 5)), str(tmp_path),
                       iou_thres_list=np.linspace(0, 1, 11),
                       degree_thres_list=list(range(0, 61, 10)),
                       shift_thres_list=[0, 2.5, 5, 7.5, 10])
    assert out == str(tmp_path / "mAP.png")
    img = cv2.imread(out)
    assert img is not None and img.shape[2] == 3 and (img != 255).any()


def test_evaluation_imports_neither_cv2_nor_matplotlib():
    """Importing the package, the legacy metric and the drawing helpers,
    and projecting and aligning a pose, loads neither cv2 nor matplotlib
    (the card's machine has no matplotlib, and the port never imports
    cv2), nor JAX or the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import hspose_tpu_torch.evaluation as ev\n"
        "from hspose_tpu_torch.evaluation import visualize as vis\n"
        "assert ev.compute_mAP.__module__ == 'hspose_tpu_torch.evaluation.metrics_legacy'\n"
        "vis.align_rotation(np.diag([1.0, 1.0, 1.0, 1.0]))\n"
        "vis.calculate_2d_projections(np.ones((3, 2)), np.eye(3))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('cv2', 'matplotlib', 'jax', 'jaxlib', 'flax', 'hspose_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
