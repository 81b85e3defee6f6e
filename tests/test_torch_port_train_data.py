"""The port's train loader (``hspose_tpu_torch/data``) against the JAX
package's on the CPU: the (seed, step) -> batch function bit for bit on both
decode paths (the native C++ library, and numpy where the JAX package runs
cv2), the worker pool's stream, and each cv2-free piece held to cv2: the PNG
reader and writer, the nearest-warp crops and the mask noise, on random and
edge inputs, on the ``nocs_root`` scene of ``tests/test_data_pipeline.py``
and on trees rendered by the JAX script and by the port's copy of it."""

import dataclasses
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from hspose_tpu.config import DataConfig as JDataConfig
from hspose_tpu.data import dataset as jds
from hspose_tpu.data import image_utils as jiu
from hspose_tpu.data import native_preproc as jnpp
from hspose_tpu_torch.config import DataConfig
from hspose_tpu_torch.data import dataset as pds
from hspose_tpu_torch.data import image_utils as iu
from test_data_pipeline import nocs_root  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = jnpp.get_lib() is not None


def configs(root, native):
    return (JDataConfig(dataset="Real", dataset_dir=root, num_workers=0, native_preproc=native),
            DataConfig(dataset="Real", dataset_dir=root, num_workers=0, native_preproc=native))


def assert_batches_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seed rendered by ``scripts/make_synth_nocs.py`` (cv2) and by
    ``hspose_tpu_torch/tools/make_synth_nocs.py`` (``write_png``)."""
    out = tmp_path_factory.mktemp("synth")
    for name, script in (("jax", "scripts/make_synth_nocs.py"),
                         ("port", "hspose_tpu_torch/tools/make_synth_nocs.py")):
        subprocess.run([sys.executable, script, str(out / name), "--train", "4", "--test", "2",
                        "--seed", "3"], cwd=REPO, check=True, capture_output=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return out / "jax", out / "port"


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_make_batch_matches_jax(nocs_root, trees, native):  # noqa: F811
    """The port's ``_make_batch_from`` against the JAX one, several (seed,
    step) pairs, on the wiring scene and on both rendered trees; with
    ``native_preproc`` off the JAX loader runs cv2 and the port numpy."""
    if native and not NATIVE:
        pytest.skip("native preproc library unavailable")
    for root in (nocs_root, str(trees[0] / "NOCS"), str(trees[1] / "NOCS")):
        jcfg, pcfg = configs(root, native)
        assert pds.decode_path(pcfg) == ("native" if native else "numpy")
        jd, pd = jds.PoseTrainDataset(jcfg), pds.PoseTrainDataset(pcfg)
        for seed, step in ((0, 0), (5, 3), (11, 7), (1677330429, 1499)):
            assert_batches_equal(pds._make_batch_from(pd, seed, step, 3),
                                 jds._make_batch_from(jd, seed, step, 3),
                                 f"{root} seed {seed} step {step}")


def test_dataset_options_match_jax(nocs_root):  # noqa: F811
    """The per_obj filter, the roi10d DZI jitter and the mask noise always
    on, on the numpy path, against the JAX loader."""
    jcfg, pcfg = configs(nocs_root, False)
    over = dict(per_obj="mug", dzi_type="roi10d", roi_mask_pro=1.0)
    jd = jds.PoseTrainDataset(dataclasses.replace(jcfg, **over))
    pd = pds.PoseTrainDataset(dataclasses.replace(pcfg, **over))
    assert pd.img_list == jd.img_list and len(pd) == 1
    assert_batches_equal(pds._make_batch_from(pd, 4, 2, 2), jds._make_batch_from(jd, 4, 2, 2),
                         "per_obj=mug roi10d")


def test_pool_stream_matches_sync_and_hides_the_card(nocs_root):  # noqa: F811
    """The spawned pool yields the synchronous stream, and its workers see
    no CUDA device."""
    _, cfg = configs(nocs_root, False)
    ds = pds.PoseTrainDataset(cfg)
    sync = list(pds.train_batches(ds, 2, 5, seed=9))
    stats = {}
    pool = pds.make_worker_pool(cfg, num_workers=2)
    try:
        pooled = list(pds.train_batches(ds, 2, 5, seed=9, pool=pool, stats=stats))
        assert pool.apply(os.getenv, ("CUDA_VISIBLE_DEVICES",)) == ""
    finally:
        pool.terminate()
    assert stats["batches"] == 5 and stats["worker_s"] > 0
    assert len(pooled) == len(sync) == 5
    for a, b in zip(sync, pooled):
        assert_batches_equal(b, a, "pool")


def test_refuses_device_sampling(nocs_root):  # noqa: F811
    """Device sampling is ported (tests/test_torch_port_device_sampling.py
    holds its batches to the JAX loader's); what the loader still refuses is
    a sample mode other than host and device."""
    _, cfg = configs(nocs_root, False)
    assert pds.PoseTrainDataset(cfg, sample_mode="device").sample_mode == "device"
    with pytest.raises(ValueError, match="'host' or 'device'"):
        pds.PoseTrainDataset(cfg, sample_mode="cuda")


def png_with_filters(path, img, kinds):
    """A PNG of ``img`` (gray (H, W) or RGB (H, W, 3), uint8 or uint16) whose
    row i uses filter ``kinds[i]`` (0 None .. 4 Paeth), written from the
    definitions of the PNG specification."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int64)
    bpp = ch * depth // 8
    out = bytearray()
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        k = kinds[y]
        if k == 0:
            pred = np.zeros_like(cur)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out += bytes([k]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, ctype, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(out))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,dtype", [((37, 53), np.uint8), ((37, 53), np.uint16),
                                         ((29, 41, 3), np.uint8), ((29, 41, 3), np.uint16),
                                         ((23, 31, 4), np.uint8), ((1, 1), np.uint16),
                                         ((1, 7, 3), np.uint8)])
def test_read_png_every_filter_matches_cv2(tmp_path, shape, dtype):
    """Rows under each of the five filters decode to the pixels cv2 reads."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[: shape[0] // 2, : shape[1] // 3] = 0  # flat runs beside noise
    path = str(tmp_path / "f.png")
    png_with_filters(path, img, [y % 5 for y in range(shape[0])])
    got = iu.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:  # cv2 gives BGR(A)
        want = want[:, :, [2, 1, 0, 3][:want.shape[2]]]
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ["paeth_first", "one_average", "all_paeth", "all_average",
                                   "random"])
@pytest.mark.parametrize("shape,dtype", [((23, 31, 3), np.uint8), ((19, 17), np.uint16)])
def test_read_png_filter_orders_match_cv2(tmp_path, order, shape, dtype):
    """Average and Paeth rows first, alone among Sub rows, in every row and
    mixed at random: the span decoded by anti-diagonals and the rows around
    it decode to the pixels cv2 reads."""
    h = shape[0]
    rng = np.random.default_rng(h)
    kinds = {"paeth_first": [4, 3, 4] + [1] * (h - 3),
             "one_average": [1] * (h // 2) + [3] + [2] * (h - h // 2 - 1),
             "all_paeth": [4] * h, "all_average": [3] * h,
             "random": [int(k) for k in rng.integers(0, 5, h)]}[order]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[h // 3:, : shape[1] // 2] = img[h // 3, 0]  # a flat patch: ties in Paeth
    path = str(tmp_path / "f.png")
    png_with_filters(path, img, kinds)
    got = iu.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[:, :, ::-1]
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, want)


def test_png_edge_files(tmp_path):
    """Corrupt, truncated and unread formats give None (load_depth raises),
    as cv2's decode fails or the JAX loader's load_depth raises."""
    good = str(tmp_path / "g.png")
    cv2.imwrite(good, np.arange(600, dtype=np.uint16).reshape(20, 30))
    data = open(good, "rb").read()
    cases = {"trunc": data[:-20], "bitflip": data[:60] + bytes([data[60] ^ 1]) + data[61:],
             "noiend": data[:-12], "garbage": b"\x89PNG\r\n\x1a\n" + b"x" * 70}
    for name, blob in cases.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(blob)
        assert iu.read_png(str(p)) is None, name
        assert cv2.imread(str(p), cv2.IMREAD_UNCHANGED) is None, name
        with pytest.raises(FileNotFoundError):
            iu.load_depth(str(p))
    assert iu.read_png(str(tmp_path / "missing.png")) is None
    gray8 = str(tmp_path / "d8.png")
    cv2.imwrite(gray8, np.full((5, 6), 7, np.uint8))
    with pytest.raises(ValueError):
        jiu.load_depth(gray8)
    with pytest.raises(ValueError):
        iu.load_depth(gray8)
    assert iu.png_header_dims(good) == jiu.png_header_dims(good) == (20, 30)
    assert iu.png_header_dims(str(tmp_path / "garbage.png")) is None


def test_depth_and_mask_decode_match_cv2(tmp_path, nocs_root, trees):  # noqa: F811
    """load_depth / load_mask against the JAX package's cv2 reads: plain
    and RGB-encoded depth (the 32001 sentinel), 16-bit and RGBA masks, and
    every depth and mask PNG of the wiring scene and both rendered trees."""
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 60000, (30, 40)).astype(np.int32)
    vals[0, :5] = 32001
    bgr = np.zeros((30, 40, 3), np.uint8)
    bgr[:, :, 1], bgr[:, :, 2] = vals // 256, vals % 256
    cv2.imwrite(str(tmp_path / "d3.png"), bgr)
    cv2.imwrite(str(tmp_path / "d16.png"), rng.integers(0, 65535, (30, 40)).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "m16.png"), rng.integers(0, 65535, (30, 40)).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "m4.png"), rng.integers(0, 255, (30, 40, 4)).astype(np.uint8))
    files = [str(tmp_path / n) for n in ("d3.png", "d16.png", "m16.png", "m4.png")]
    for root in (nocs_root, trees[0], trees[1]):
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(("_depth.png", "_mask.png"))]
    assert len(files) > 20
    for f in files:
        if not f.endswith(("m16.png", "m4.png")):
            np.testing.assert_array_equal(iu.load_depth(f) if "mask" not in f
                                          else iu.load_mask(f),
                                          jiu.load_depth(f) if "mask" not in f
                                          else cv2.imread(f)[:, :, 2], err_msg=f)
        np.testing.assert_array_equal(iu.load_mask(f), cv2.imread(f)[:, :, 2], err_msg=f)


def test_write_png_matches_cv2_and_the_trees_match(tmp_path, trees):
    """write_png's files read back (by cv2 and by read_png) as the pixels
    cv2.imwrite's do; the port's rendered tree holds the JAX script's
    pixels, pickles and lists."""
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 65535, (13, 17)).astype(np.uint16),
                rng.integers(0, 255, (13, 17)).astype(np.uint8),
                rng.integers(0, 255, (13, 17, 3)).astype(np.uint8),
                np.zeros((1, 1, 3), np.uint8)):
        ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
        iu.write_png(ours, img)
        cv2.imwrite(theirs, img)
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            np.testing.assert_array_equal(cv2.imread(ours, flag), cv2.imread(theirs, flag))
        np.testing.assert_array_equal(iu.read_png(ours), iu.read_png(theirs))
    jax_tree, port_tree = trees
    n = 0
    for dirpath, _, names in os.walk(jax_tree):
        for name in names:
            a = os.path.join(dirpath, name)
            b = os.path.join(port_tree, os.path.relpath(a, jax_tree))
            if name.endswith(".png"):
                np.testing.assert_array_equal(cv2.imread(b, -1), cv2.imread(a, -1), err_msg=a)
            elif name.endswith((".pkl", ".txt")):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), a
            n += 1
    assert n == sum(len(f) for _, _, f in os.walk(port_tree)) and n > 20


def test_fused_crop_matches_cv2_warps(nocs_root):  # noqa: F811
    """The three nearest-warp crops against the JAX package's cv2 crops on
    one scene image: integer and half-pixel centres (the eval crops), random
    DZI windows, windows off every edge, output sizes 64 and 256."""
    path = os.path.join(nocs_root, "Real", "train", "scene_1", "0000")
    depth = jiu.load_depth(path + "_depth.png")
    mask = cv2.imread(path + "_mask.png")[:, :, 2]
    h, w = mask.shape
    coord = jiu.get_2d_coord(w, h).transpose(1, 2, 0)
    rng = np.random.default_rng(0)
    for trial in range(120):
        if trial % 2:
            center = (rng.uniform(-40, w + 40), rng.uniform(-40, h + 40))
            scale = rng.uniform(3.0, 470.0)
        else:
            center = (rng.integers(-20, w + 20) + 0.5 * rng.integers(0, 2),
                      rng.integers(-20, h + 20) + 0.5 * rng.integers(0, 2))
            scale = float(rng.integers(1, 480))
        o, inst = int(rng.choice([64, 256])), int(rng.integers(0, 3))
        want_d = jiu.crop_resize_by_warp_affine(depth.astype(np.float32), center, scale, o)
        want_m = jiu.crop_resize_by_warp_affine((mask == inst).astype(np.float32), center,
                                                scale, o)
        want_c = jiu.crop_resize_by_warp_affine(coord, center, scale, o).transpose(2, 0, 1)
        d, m, c, n_depth, n_both = iu.fused_crop(depth, mask == inst, center, scale, o)
        np.testing.assert_array_equal(d, want_d, err_msg=f"depth {trial}")
        np.testing.assert_array_equal(m, want_m, err_msg=f"mask {trial}")
        np.testing.assert_array_equal(c, want_c, err_msg=f"coord {trial}")
        assert (n_depth, n_both) == (int((want_d > 0).sum()),
                                     int(((want_d > 0) & (want_m > 0)).sum()))


def edge_masks():
    rng = np.random.default_rng(3)
    masks = [np.zeros((8, 9)), np.ones((8, 9)), np.eye(7), np.zeros((1, 12)),
             np.ones((12, 1)), (rng.random((33, 40)) < 0.5), (rng.random((256, 256)) < 0.97)]
    one = np.zeros((10, 10))
    one[0, 0] = one[9, 9] = one[4, 5] = 1
    blob = np.zeros((64, 64))
    blob[10:50, 20:41] = 1
    return [m.astype(np.float32) for m in masks + [one, blob]]


@pytest.mark.parametrize("k", range(9))
def test_defor_2d_mask_matches_jax(k):
    """The cv2-free mask noise against the JAX package's (cv2.erode /
    cv2.dilate with the 2x2 ellipse) with the same generator, noise forced
    on and left to chance."""
    mask = edge_masks()[k]
    for seed in range(4):
        for pro in (1.0, 0.5):
            got = iu.defor_2d_mask(np.random.default_rng(seed), mask, 3, pro)
            want = jiu.defor_2d_mask(np.random.default_rng(seed), mask, 3, pro)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_loader_never_imports_cv2(nocs_root):  # noqa: F811
    """A numpy-path batch and an eval image load without cv2 (the card's
    machine has none)."""
    code = (
        "import sys, numpy as np\n"
        "from hspose_tpu_torch.config import DataConfig\n"
        "from hspose_tpu_torch.data import dataset as d\n"
        "from hspose_tpu_torch.evaluation.eval_dataset import PoseEvalDataset\n"
        f"cfg = DataConfig(dataset_dir={nocs_root!r}, native_preproc=False, "
        f"detection_dir={os.path.join(os.path.dirname(nocs_root), 'segmentation_results')!r})\n"
        "b = d._make_batch_from(d.PoseTrainDataset(cfg), 0, 0, 2)\n"
        "assert b['pcl_in'].shape == (2, 1028, 3)\n"
        "assert PoseEvalDataset(cfg).get_image(0, np.random.default_rng(0)) is not None\n"
        "assert 'cv2' not in sys.modules and 'torch' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_eval_dataset_numpy_path_matches_jax_cv2_path(nocs_root):  # noqa: F811
    """With ``native_preproc`` off the port's eval image (numpy) equals the
    JAX package's (cv2)."""
    from hspose_tpu.evaluation.eval_dataset import PoseEvalDataset as JPoseEvalDataset
    from hspose_tpu_torch.evaluation.eval_dataset import PoseEvalDataset

    det = os.path.join(os.path.dirname(nocs_root), "segmentation_results")
    jcfg, pcfg = configs(nocs_root, False)
    got = PoseEvalDataset(dataclasses.replace(pcfg, detection_dir=det)).get_image(
        0, np.random.default_rng(4))
    want = JPoseEvalDataset(dataclasses.replace(jcfg, detection_dir=det)).get_image(
        0, np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)

