"""One rank of the port's multi-process CPU tests: a ``gloo`` process group
joined through a file store, so parallel test workers never race for a port.

    python tests/_torch_dist_worker.py <dir> <rank> <world>

Reads ``<dir>/job.pt`` (``launch`` writes it), joins the group with a
timeout, builds the port's model on the CPU from the job's state dict, runs
the job's tasks in order and writes ``<dir>/out_<rank>.pt``.  Imports torch
and the port only.  Tasks:

* ``forward``: ``sp_eval_fn``'s raw head outputs for this rank's rows and
  points of a batch under the (dp, sp) layout of ``make_mesh``, with the
  job's pool samples;
* ``harness``: ``batched_pose_inference`` on in-memory records under the
  task's overrides (``parallel.dp``, ``parallel.sp``, ``eval.eval_batch``);
* ``collectives``: ``parallel/sp.py``'s gather, mean and max over all ranks
  of the task's tensor plus the rank, in fp32 and bf16;
* ``train``: the train step on the task's (dp, mp) layout (the one-process
  step for dp = mp = 1) from the task's own weights (a model with the train
  heads), one step per entry of ``batches`` on this rank's rows with the
  entry's global draws (None: drawn from a generator seeded 0); after
  each step the full state (``state``), optionally restored from
  ``resume`` first and saved to ``save`` after step ``save_after``;
* ``loop``: the train loop (``engine/train.py::train``) under the task's
  overrides, and its final state as ``train`` gives it.
"""

import hashlib
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = timedelta(seconds=60)  # every rank must join and answer within this
RUN_TIMEOUT = 180  # seconds a whole group may take


def forward(model, task):
    from hspose_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from hspose_tpu_torch.parallel.sp import sp_eval_fn

    mesh = make_mesh(task["dp"], task["sp"])
    if not mesh.active:
        return None
    pc = task["pc"]
    rows = batch_sharding(mesh, pc.shape[0])
    n = pc.shape[1] // mesh.sp
    local = pc[rows, mesh.sp_index * n:(mesh.sp_index + 1) * n].contiguous()
    out = sp_eval_fn(model, mesh.sp_group, with_rt=False)(local, task["obj"][rows], None, None,
                                                          task["samples"])
    return {"rows": (rows.start, rows.stop), "out": out}


def harness(model, task):
    from hspose_tpu_torch.config import parse_overrides
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference

    cfg = parse_overrides(task["overrides"])
    preds, _ = batched_pose_inference(cfg, model, task["records"], task["seed"],
                                      pool_samples=task["samples"])
    return preds


def collectives(model, task):
    import torch.distributed as dist

    from hspose_tpu_torch.parallel.mesh import make_mesh
    from hspose_tpu_torch.parallel.sp import (
        all_gather_points,
        max_over_shards,
        mean_over_shards,
    )

    group = make_mesh(1, dist.get_world_size()).sp_group
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (task["x"] + dist.get_rank()).to(dtype)
        out[dtype] = {"gather": all_gather_points(x, group), "max": max_over_shards(x, group),
                      "mean": mean_over_shards(x, group)}
    return out


def _digest(t: torch.Tensor) -> str:
    return hashlib.blake2b(t.detach().cpu().contiguous().numpy().tobytes(),
                           digest_size=16).hexdigest()


def state(model, step, values: bool = True) -> dict:
    """The training state, full (the parameters sharded over mp, their
    optimizer state and accumulator gathered): a digest of every tensor and
    the counts, and with ``values`` the model's state dict (``model``) and
    the accumulator (``acc``) themselves.  Every rank of an mp group must
    call it."""
    from hspose_tpu_torch.parallel import mp

    params = step.optimizer._params()
    weights = model.state_dict()
    for name, p in model.named_parameters():
        weights[name] = mp.full(p, p.detach())
    acc = [mp.full(p, a) for p, a in zip(params, step.accumulator)]
    tensors = {f"model.{k}": v for k, v in weights.items()}
    for i, p in enumerate(params):
        tensors.update({f"opt.{i}.{k}": mp.full(p, v)
                        for k, v in step.optimizer.state[p].items()})
    tensors.update({f"acc.{i}": a for i, a in enumerate(acc)})
    out = {"digest": {k: _digest(v) for k, v in tensors.items()},
           "count": step.optimizer.count, "mini_step": step.mini_step}
    if values:
        out["model"] = {k: v.detach().clone() for k, v in weights.items()}
        out["acc"] = [a.detach().clone() for a in acc]
    return out


def train(_, task):
    import torch.distributed as dist

    from hspose_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    cfg = task["cfg"]
    mesh = make_mesh(task["dp"], 1, task["mp"])
    if not mesh.active:
        return None
    model = build_model(cfg.model, device="cpu", train_heads=True)
    model.load_state_dict(task["state_dict"])
    step = build_train_step(cfg, model, torch.Generator().manual_seed(0),
                            mesh if mesh.dp * mesh.mp > 1 else None)
    if task.get("resume"):
        restore_checkpoint(task["resume"], model, step)
    out = []
    for i, (batch, draws) in enumerate(task["batches"]):
        rows = batch_sharding(mesh, next(iter(batch.values())).shape[0])
        metrics = step(to_device({k: v[rows] for k, v in batch.items()}, "cpu"), draws)
        # rank 0 ships the values, every rank the digests
        out.append({"metrics": metrics, "state": state(model, step, dist.get_rank() == 0)})
        if task.get("save") and i == task["save_after"]:
            save_checkpoint(task["save"], model, step, epoch=0, seed=0)
    return out


def loop(_, task):
    """``engine/train.py::train`` under the task's overrides; this rank's
    final state as ``train`` gives it (None outside the mesh)."""
    import torch.distributed as dist

    from hspose_tpu_torch.config import parse_overrides
    from hspose_tpu_torch.engine.train import train as train_loop

    model, step = train_loop(parse_overrides(task["overrides"]), device="cpu")
    return None if step is None else state(model, step, dist.get_rank() == 0)


TASKS = {"forward": forward, "harness": harness, "collectives": collectives, "train": train,
         "loop": loop}


def main(d: str, rank: int, world: int) -> None:
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", backend="gloo", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout=JOIN_TIMEOUT)
    job = torch.load(os.path.join(d, "job.pt"), weights_only=False)
    # the launching process's thread count: the CPU products' blocking, and so
    # their bits, may depend on it
    torch.set_num_threads(job["threads"])
    model = None  # the serving tasks' model; a train task builds its own
    if "state_dict" in job:
        model = build_model(ModelConfig(**job["model"]), device="cpu")
        model.load_state_dict(job["state_dict"])
    out = {name: TASKS[task["kind"]](model, task) for name, task in job["tasks"].items()}
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    dist.destroy_process_group()


def start(d: Path, world: int, job: dict):
    """Start ``job`` on ``world`` ranks in ``d`` and return at once; the
    returned function waits for the ranks and gives their outputs in rank
    order.  A group that does not finish within RUN_TIMEOUT of its start is
    killed and the call fails, with each rank's error output."""
    torch.save(dict(job, threads=torch.get_num_threads()), d / "job.pt")
    env = dict(os.environ)
    procs = []
    for r in range(world):
        with open(d / f"err_{r}.txt", "w") as err:
            procs.append(subprocess.Popen([sys.executable, __file__, str(d), str(r), str(world)],
                                          stdout=subprocess.DEVNULL, stderr=err, env=env,
                                          cwd=REPO))
    deadline = time.monotonic() + RUN_TIMEOUT

    def collect() -> list:
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            errs = "\n".join(f"rank {r} ({c}): {(d / f'err_{r}.txt').read_text()[-3000:]}"
                             for r, c in enumerate(codes) if c)
            raise AssertionError(f"the process group failed or timed out:\n{errs}")
        outs = []
        for r in range(world):
            outs.append(torch.load(d / f"out_{r}.pt", weights_only=False))
            (d / f"out_{r}.pt").unlink()  # the states are large: keep them in memory only
        (d / "job.pt").unlink()
        return outs

    return collect


def launch(d: Path, world: int, job: dict) -> list:
    """Run ``job`` on ``world`` ranks in ``d``; the ranks' outputs in rank
    order (``start``, waited for)."""
    return start(d, world, job)()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
