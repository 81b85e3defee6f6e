"""Where the JAX and the port's eval harness part on the ``nocs_root`` scene
of ``tests/test_data_pipeline.py`` drawn with this process's ``hash()``.

``test_data_pipeline._write_scene`` seeds each image from ``hash((scene,
img_id))``, which Python randomises per process; ``test_torch_port_eval``
pins the scene with ``zlib.crc32`` instead.  This script draws the scene
the unpinned way, so ``PYTHONHASHSEED`` picks it, runs both harnesses as
``test_torch_port_eval``'s ``harness`` fixture does, records every
neighbour search of both forwards (``knn_indices_fast`` and
``nearest_index`` in JAX, ``knn`` and ``nearest_index`` in the port), and
prints, after the harnesses' logs, one JSON object as its last line:

* ``pose_diff``: the largest difference of ``pred_RTs``;
* per search: the rows that picked another neighbour set, and for the first
  few the competing candidates' squared distances, in fp32 as each package
  computes them (``pairwise_sq_dist``, JAX's outside the model's jit) and
  in float64 on each package's inputs, with the squared norms the fp32
  expansion ||q||^2 + ||c||^2 - 2 q.c cancels; and the rms and largest
  error of each package's fp32 distances against float64;
* ``pose_diff_replayed``: ``pose_diff`` again with every search of the port
  given JAX's lists, so that only the arithmetic differs.

Usage::

    PYTHONHASHSEED=11 JAX_PLATFORMS=cpu python tests/_harness_knn_splits.py
"""

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import hspose_tpu.models.face_recon as jfr  # noqa: E402
import hspose_tpu_torch.models.face_recon as pfr  # noqa: E402
import test_data_pipeline  # noqa: E402
import test_torch_port_eval as T  # noqa: E402
from hspose_tpu.ops.knn import pairwise_sq_dist as j_dist  # noqa: E402
from hspose_tpu_torch.ops.knn import pairwise_sq_dist as p_dist  # noqa: E402

REAL = 2  # the harness batch holds the scene's two detections, then padding
CASES = 4  # competing candidates printed per search


class TmpFactory:
    def __init__(self, root):
        self.root = root

    def mktemp(self, name):
        return Path(tempfile.mkdtemp(prefix=name, dir=self.root))


def f64_dist(q, c):
    return float(((q.astype(np.float64) - c) ** 2).sum())


def compare_search(j_rec, p_rec):
    """One search of both forwards: (kind, query rows, source rows, idx)."""
    kind, jq, js, ji = j_rec
    _, pq, ps, pi = p_rec
    out = {"kind": kind, "shape": list(pq.shape),
           "input_max_abs_diff": float(np.abs(jq - pq).max())}
    if kind == "nearest":
        rows = [(b, q) for b in range(REAL) for q in range(ji.shape[1]) if ji[b, q] != pi[b, q]]
        out["rows_with_other_neighbours"] = len(rows)
        out["cases"] = [{"b": b, "q": q,
                         "jax": {"idx": int(ji[b, q]), "f64_jax": f64_dist(jq[b, q], js[b, ji[b, q]])},
                         "port": {"idx": int(pi[b, q]), "f64_port": f64_dist(pq[b, q], ps[b, pi[b, q]])}}
                        for b, q in rows[:CASES]]
        return out
    k = ji.shape[-1]
    rows = [(b, q) for b in range(REAL) for q in range(ji.shape[1])
            if set(ji[b, q]) != set(pi[b, q])]
    out["k"] = k
    out["rows_with_other_neighbours"] = len(rows)
    dj = np.asarray(j_dist(jnp.asarray(jq), jnp.asarray(jq)))
    dp = p_dist(torch.from_numpy(pq), torch.from_numpy(pq)).numpy()

    def exact(x):
        x = x[:REAL].astype(np.float64)
        return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)

    ej, ep = dj[:REAL] - exact(jq), dp[:REAL] - exact(pq)
    out["fp32_error"] = {"jax_rms": float(np.sqrt((ej ** 2).mean())),
                         "port_rms": float(np.sqrt((ep ** 2).mean())),
                         "jax_max": float(np.abs(ej).max()), "port_max": float(np.abs(ep).max()),
                         "max_sq_norm": float((pq[:REAL].astype(np.float64) ** 2).sum(-1).max())}

    def candidate(b, q, c):
        return {"idx": int(c), "fp32_jax": float(dj[b, q, c]), "fp32_port": float(dp[b, q, c]),
                "f64_jax": f64_dist(jq[b, q], jq[b, c]), "f64_port": f64_dist(pq[b, q], pq[b, c]),
                "sq_norm": float((pq[b, c].astype(np.float64) ** 2).sum())}

    out["cases"] = [{"b": b, "q": q, "q_sq_norm": float((pq[b, q].astype(np.float64) ** 2).sum()),
                     "jax_only": [candidate(b, q, c) for c in sorted(set(ji[b, q]) - set(pi[b, q]))],
                     "port_only": [candidate(b, q, c) for c in sorted(set(pi[b, q]) - set(ji[b, q]))]}
                    for b, q in rows[:CASES]]
    return out


def main():
    tmp = tempfile.mkdtemp(prefix="knn_splits_")
    try:
        report = splits(TmpFactory(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))


def splits(factory):
    _, _, path = T.weights.__wrapped__(factory)
    root = test_data_pipeline.nocs_root.__wrapped__(factory)  # hash() unpinned
    out = factory.mktemp("eval")
    det = os.path.join(os.path.dirname(root), "segmentation_results")
    args = [f"data.dataset_dir={root}", f"data.detection_dir={det}", "data.num_workers=0",
            f"data.num_points={T.N_HARNESS}", f"train.resume_model={path}",
            "eval.eval_seed=5", "eval.eval_batch=4", "eval.recon=true"]
    perms = T.perms_for(T.N_HARNESS, 21)

    j_sites, j_recs, p_recs, replay = [], [], [], {}
    j_knn, j_near = jfr.knn_indices_fast, jfr.nearest_index
    p_knn, p_near = pfr.knn, pfr.nearest_index

    def record_jax(kind, q, s, idx):
        site = len(j_sites)
        j_sites.append(kind)
        jax.debug.callback(lambda a, b, c: j_recs.append(
            (site, kind, np.asarray(a), np.asarray(b), np.asarray(c))), q, s, idx)
        return idx

    def jax_knn(p, kk, fast=False, source=None):
        return record_jax("knn", p, p, j_knn(p, kk, fast=fast, source=source))

    def jax_nearest(t, s):
        return record_jax("nearest", t, s, j_near(t, s))

    def record_port(kind, q, s, idx):
        i = len(p_recs)
        p_recs.append((kind, q.detach().numpy().copy(), s.detach().numpy().copy(),
                       idx.numpy().copy()))
        return torch.from_numpy(replay[i]) if i in replay else idx

    def port_knn(x, k, packed=False):
        return record_port("knn", x, x, p_knn(x, k, packed=packed))

    def port_nearest(t, s):
        return record_port("nearest", t, s, p_near(t, s))

    def run_port(tag):
        p_recs.clear()
        T.port_eval.evaluate(T.parse_overrides(args + [f"train.model_save={out / tag}"]),
                             device="cpu", pool_samples=T.samples_of(perms, T.N_HARNESS))
        return T.read_preds(out / tag / "eval_result_hspose")

    with pytest.MonkeyPatch.context() as mp:
        T.pinned_pooling(mp, perms)
        mp.setattr(T.j_params_io, "init_variables", T.jit_init_variables)
        for module in (T.j_eval_dataset, T.port_eval_dataset):
            mp.setattr(module, "host_sample_points", T.jittered(module.host_sample_points))
        mp.setattr(jfr, "knn_indices_fast", jax_knn)
        mp.setattr(jfr, "nearest_index", jax_nearest)
        mp.setattr(pfr, "knn", port_knn)
        mp.setattr(pfr, "nearest_index", port_nearest)
        T.j_evaluate(T.j_parse_overrides(args + [f"train.model_save={out / 'jax'}"]))
        want = T.read_preds(out / "jax" / "eval_result_hspose")
        got = run_port("port")
        # the harness batch (4 rows), not the batch of 1 that builds the template
        j_batch = [r[1:] for r in sorted(j_recs, key=lambda r: r[0]) if r[2].shape[0] == 4]
        if [r[0] for r in j_batch] != [r[0] for r in p_recs]:
            raise AssertionError("the two forwards search in another order")
        report = {"hashseed": os.environ.get("PYTHONHASHSEED"),
                  "pose_diff": float(np.abs(got[0]["pred_RTs"] - want[0]["pred_RTs"]).max()),
                  "searches": [compare_search(a, b) for a, b in zip(j_batch, p_recs)]}
        if any(s["rows_with_other_neighbours"] for s in report["searches"]):
            replay.update({i: r[3].astype(np.int32) for i, r in enumerate(j_batch)})
            again = run_port("replayed")
            report["pose_diff_replayed"] = float(
                np.abs(again[0]["pred_RTs"] - want[0]["pred_RTs"]).max())
    return report


if __name__ == "__main__":
    main()
