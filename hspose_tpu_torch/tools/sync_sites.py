"""Every read that makes the host wait for the CUDA card in one train step
and one eval-harness request, each with the port's spans open around it.

    python hspose_tpu_torch/tools/sync_sites.py [--dtype float32|bfloat16] [--out FILE.json]

Builds the model with seeded random weights at the published widths
(N=1028), takes ``build_train_step``'s step at B=24 and serves one request
of 192 crops (eight records of 24) through ``batched_pose_inference`` at
``eval.eval_batch`` 96, each twice to warm up, then once more under
``torch.cuda.set_sync_debug_mode("warn")``, which reports each implicit
synchronisation (a ``.cpu()``, ``float()`` or ``bool()`` of a device
tensor, a pageable host-to-device copy, a solver's error check).  A served
request's syncs are the two ``hspose.sync.fetch`` reads of each batch's
outputs in ``land``: its inputs go up from pinned memory without waiting,
and its forwards are graph replays.  The spans (``utils/spans.py``) are
recorded here by a stand-in for the profiler that keeps the open spans'
names.  Prints, per path, the count of syncs by the innermost open span
and the Python frames of any sync that no ``hspose.sync.*`` span holds;
exits 1 when there is one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
import types
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

N, TRAIN_B, SERVE_B, RECORDS = 1028, 24, 96, [24] * 8


class _Recorder:
    """``torch.autograd`` as ``utils/spans.py`` sees it: a profiler that is
    always on and keeps the names of the open spans."""

    def __init__(self):
        self.open = []

    def _profiler_enabled(self):
        return True

    def _record_function_with_args_enter(self, name, *args):
        self.open.append(name)
        return name

    def _record_function_with_args_exit(self, handle):
        self.open.pop()


def syncs_of(fn) -> list:
    """(open spans, the port's innermost frames) of each sync ``fn`` makes."""
    import torch

    from hspose_tpu_torch.utils import spans

    rec, found = _Recorder(), []

    def show(message, *args, **kw):
        if "called a synchronizing" in str(message):
            frames = [f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
                      for f in traceback.extract_stack()[:-1]
                      if f.filename.startswith(str(ROOT / "hspose_tpu_torch"))
                      and not f.filename.endswith("sync_sites.py")]
            found.append((list(rec.open), frames[-3:]))

    torch.cuda.synchronize()
    real = spans.torch
    spans.torch = types.SimpleNamespace(autograd=rec)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            spans.torch = real
    torch.cuda.synchronize()
    return found


def report(found: list) -> dict:
    loose = [{"spans": s, "frames": f} for s, f in found
             if not (s and s[-1].startswith("hspose.sync."))]
    return {"syncs": len(found),
            "by_span": dict(Counter(s[-1] if s else "none" for s, _ in found)),
            "outside_sync_spans": loose}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    cfg = HSPoseConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=args.dtype),
                      data=dataclasses.replace(cfg.data, num_points=N),
                      train=dataclasses.replace(cfg.train, batch_size=TRAIN_B),
                      eval=dataclasses.replace(cfg.eval, eval_batch=SERVE_B))
    torch.manual_seed(0)
    out = {"dtype": args.dtype, "card": torch.cuda.get_device_name(0)}

    model = build_model(cfg.model, device="cuda", train_heads=True)
    step = build_train_step(cfg, model, torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(synthetic_train_batch(TRAIN_B, N, seed=1), "cuda")
    metrics = [step(batch) for _ in range(2)][-1]
    out["train_step"] = report(syncs_of(lambda: step(batch)))
    out["train_step"]["metrics_returned"] = len(metrics)
    del model, step

    rng = np.random.default_rng(2)
    records = [({"pcl_in": rng.normal(scale=0.2, size=(n, N, 3)).astype(np.float32),
                 "cat_id_0base": rng.integers(0, 6, n),
                 "sym_info": np.zeros((n, 4), np.float32),
                 "mean_shape": rng.uniform(0.1, 0.3, (n, 3)).astype(np.float32)}, {}, {})
               for n in RECORDS]
    model = build_model(cfg.model, device="cuda").eval()
    for _ in range(2):
        batched_pose_inference(cfg, model, records, seed=0)
    out["harness_request"] = report(syncs_of(
        lambda: batched_pose_inference(cfg, model, records, seed=0)))

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return int(any(out[k]["outside_sync_spans"] for k in ("train_step", "harness_request")))


if __name__ == "__main__":
    sys.exit(main())
