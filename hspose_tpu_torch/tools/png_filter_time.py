"""Time the loader's numpy PNG decode by row filter, per image and per sample.

A PNG writer picks one of five filters for each row (0 None, 1 Sub, 2 Up,
3 Average, 4 Paeth).  cv2's writer and the port's ``write_png`` filter every
row with Sub; other writers mix all five.  ``data/image_utils.py::read_png``
undoes None and Sub rows a block at a time and Up rows a row at a time, and
the span from the first Average or Paeth row to the last by anti-diagonals.
This script measures what each costs:

1. ``read_png`` on a 640x480 RGB image and a 640x480 16-bit depth image
   (a smooth field plus noise, from ``--seed``) written with every row Sub,
   Up, Average or Paeth, with the five filters drawn at random per row, and
   with one Paeth row among Sub rows;
2. the train loader (``data/dataset.py::_make_batch_from``, numpy decode)
   on a small tree rendered by ``tools/make_synth_nocs.py``, and on a copy
   whose every PNG is written again with random per-row filters: samples/s
   of one process (one loader worker) on each, and a check that both trees
   give the same batches (the decode is lossless);
3. with ``--tree DIR`` (a dataset, say NOCS), the rows under each filter in
   its PNGs and ``read_png``'s time on them, by file suffix (``_depth``,
   ``_mask``, ...): whether a tree's files are the slow kind.

Usage::

    python hspose_tpu_torch/tools/png_filter_time.py [--tree DIR] [--out F.json]

Prints one line per measurement and, last, one JSON object.  Runs on the
CPU only; it imports neither torch's CUDA nor cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from hspose_tpu_torch.config import DataConfig  # noqa: E402
from hspose_tpu_torch.data import dataset as pds  # noqa: E402
from hspose_tpu_torch.data import image_utils as iu  # noqa: E402


def write_filtered_png(path: str, img: np.ndarray, kinds) -> None:
    """``img`` (gray (H, W) or RGB (H, W, 3), uint8 or uint16) as a PNG
    whose row i is filtered by ``kinds[i]``, from the filters' definitions
    in the PNG specification."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int64)
    bpp = ch * depth // 8
    up = np.vstack([np.zeros((1, raw.shape[1]), np.int64), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), raw[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    preds = [np.zeros_like(raw), left, up, (left + up) // 2,
             np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))]
    kinds = np.asarray(kinds)
    pred = np.choose(kinds[:, None], preds)
    rows = np.hstack([kinds[:, None], (raw - pred) % 256]).astype(np.uint8)

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([depth, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0]))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def images(seed: int):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    rgb = np.stack([(xx * 0.3 + yy * 0.1) % 256, (xx * yy * 1e-3) % 256, (yy * 0.5) % 256], -1)
    rgb = (rgb + rng.integers(0, 8, rgb.shape)).astype(np.uint8)
    depth = (600 + yy + 2 * xx + rng.integers(0, 30, yy.shape)).astype(np.uint16)
    return {"rgb8": rgb, "depth16": depth}


def best_of(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def time_images(tmp: str, seed: int, reps: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    mixes = {"sub": [1] * 480, "up": [2] * 480, "average": [3] * 480, "paeth": [4] * 480,
             "random": rng.integers(0, 5, 480).tolist(),
             "one_paeth": [1] * 240 + [4] + [1] * 239}
    out = {}
    for name, img in images(seed).items():
        for mix, kinds in mixes.items():
            path = os.path.join(tmp, f"{name}_{mix}.png")
            write_filtered_png(path, img, kinds)
            got = iu.read_png(path)
            if not np.array_equal(got, img):
                raise AssertionError(f"read_png of {name} {mix} differs from what was written")
            ms = best_of(lambda: iu.read_png(path), reps) * 1e3
            out[f"{name}_{mix}_ms"] = ms
            print(f"read_png {name:8s} {mix:10s} {ms:9.3f} ms (best of {reps})", flush=True)
    return out


def refilter_tree(src: str, dst: str, seed: int) -> int:
    """Copy ``src`` to ``dst`` and write every PNG there again, its pixels
    unchanged, with the five filters drawn at random per row."""
    shutil.copytree(src, dst)
    rng = np.random.default_rng(seed)
    n = 0
    for d, _, files in os.walk(dst):
        for name in files:
            if name.endswith(".png"):
                path = os.path.join(d, name)
                img = iu.read_png(path)
                write_filtered_png(path, img, rng.integers(0, 5, img.shape[0]).tolist())
                n += 1
    return n


def time_loader(tmp: str, seed: int, batch: int, steps: int, n_train: int) -> dict:
    subprocess.run([sys.executable, os.path.join(REPO, "hspose_tpu_torch/tools/make_synth_nocs.py"),
                    os.path.join(tmp, "sub"), "--train", str(n_train), "--test", "1",
                    "--seed", str(seed)], check=True, capture_output=True, timeout=600)
    n = refilter_tree(os.path.join(tmp, "sub"), os.path.join(tmp, "mixed"), seed)
    out = {"pngs_refiltered": n}
    batches = {}
    for tree in ("sub", "mixed"):
        cfg = DataConfig(dataset="Real", dataset_dir=os.path.join(tmp, tree, "NOCS"),
                         num_workers=0, native_preproc=False)
        ds = pds.PoseTrainDataset(cfg)
        pds._make_batch_from(ds, seed, 0, 2)  # warm the caches once
        t0 = time.perf_counter()
        batches[tree] = [pds._make_batch_from(ds, seed, s, batch) for s in range(steps)]
        rate = batch * steps / (time.perf_counter() - t0)
        out[f"loader_{tree}_samples_per_s"] = rate
        print(f"loader {tree:6s} {rate:9.3f} samples/s in one process "
              f"({steps} batches of {batch}, numpy decode)", flush=True)
    for a, b in zip(batches["sub"], batches["mixed"]):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"the refiltered tree gave another batch ({k})")
    print("both trees gave the same batches", flush=True)
    return out


def survey_tree(root: str, max_files: int) -> dict:
    """Filter rows and read_png milliseconds of up to ``max_files`` PNGs
    under ``root``, by the suffix after the last underscore."""
    rows, ms, files = {}, {}, {}
    paths = sorted(os.path.join(d, n) for d, _, names in os.walk(root)
                   for n in names if n.endswith(".png"))[:max_files]
    for path in paths:
        kind = os.path.basename(path)[:-4].rsplit("_", 1)[-1]
        chunks = iu._png_chunks(path)
        if chunks is None:
            continue
        w, h, depth, ctype = struct.unpack(">IIBB", chunks[0][:10])
        # bytes a row (palette and gray + alpha too; sub-byte depths round up)
        stride = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype, 1) * depth + 7) // 8
        raw = np.frombuffer(zlib.decompress(chunks[1]), np.uint8)
        if len(raw) >= h * (stride + 1):
            counts = np.bincount(raw[:h * (stride + 1)].reshape(h, stride + 1)[:, 0],
                                 minlength=5)[:5]
            rows[kind] = rows.get(kind, np.zeros(5, np.int64)) + counts
        t0 = time.perf_counter()
        iu.read_png(path)
        ms[kind] = ms.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
        files[kind] = files.get(kind, 0) + 1
    out = {}
    for kind in sorted(files):
        filt = rows.get(kind, np.zeros(5, np.int64)).tolist()
        out[f"tree_{kind}"] = {"files": files[kind], "rows_by_filter": filt,
                               "read_png_ms": ms[kind] / files[kind]}
        print(f"tree {kind:8s} {files[kind]:6d} files, rows None/Sub/Up/Average/Paeth "
              f"{filt}, read_png {ms[kind] / files[kind]:.3f} ms a file", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5, help="timings per image (best kept)")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--train", type=int, default=8, help="images of the rendered tree")
    ap.add_argument("--tree", default="", help="also survey this tree's PNGs")
    ap.add_argument("--max-files", type=int, default=200)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="png_filter_time_")
    try:
        result = time_images(tmp, args.seed, args.reps)
        result.update(time_loader(tmp, args.seed, args.batch, args.steps, args.train))
        if args.tree:
            result.update(survey_tree(args.tree, args.max_files))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["cpu_count"] = os.cpu_count()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
