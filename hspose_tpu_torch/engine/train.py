"""Training entry point (counterpart of ``hspose_tpu/engine/train.py``).

Equivalent of ``python -m engine.train`` (engine/train.py:25-165): seed resolution
(incl. resume-from-checkpoint seed), model/optimizer/schedule build, resume restore,
the epoch × step loop with NaN-skip and periodic logging, checkpoints every
``save_every`` epochs and at the last.  The step is ``build_train_step`` on one
device: the CUDA card, unless ``train`` is given ``device="cpu"`` (the tests)
or the CLI runs with ``HSPOSE_PLATFORM=cpu``.

    python -m hspose_tpu_torch.engine.train data.dataset_dir=/path/NOCS \\
        train.batch_size=16 train.seed=1677330429

Randomness: the model is initialised from ``torch.manual_seed(seed)``; the
batch of step i of epoch e comes from (seed + 997 e, i), as in the JAX loop,
and the step's own draws (augmentation, pooling, dropout) from a generator
seeded anew at every step from (seed, e · train_steps + i), the counterpart
of the JAX loop's ``fold_in(data_key, epoch * train_steps + i)``.  So a
resumed run needs only the checkpoint's seed and epoch besides its tensors.

``train.debug_nan`` turns on ``torch.autograd.set_detect_anomaly`` for the
run and stops it with FloatingPointError at the first step whose loss
family is not finite (``check_finite_metrics``).  ``HSPOSE_PROFILE_DIR``
traces steps 10-14 of the first epoch with ``torch.profiler`` into
``<dir>/train_steps_10_14.json``, the step's own spans
(``utils/spans.py``) among the host's ranges.

``data.sample_mode=device`` makes the loader ship each sample's 256² crops
instead of its cloud, and the step back-projects and samples them on the
step's device (``models/hspose.py::train_forward``), with scores drawn from
the step's generator after its other draws.

Several GPUs train as the JAX package's (dp, mp) mesh does
(hspose_tpu/engine/train.py:38-80), one process per GPU:

    torchrun --standalone --nproc_per_node=<dp*mp> -m hspose_tpu_torch.engine.train \
        parallel.dp=<dp> parallel.mp=<mp> data.dataset_dir=/path/NOCS ...

The CLI joins the process group (``nccl``, one card per rank; ``gloo`` with
``HSPOSE_PLATFORM=cpu``).  A step on dp ranks over the global batch of
``train.batch_size`` rows is the one-process step on those rows
(``engine/train_step.py``): every rank makes the whole batch of (seed,
step) and keeps its ``B / dp`` rows, and draws the whole batch's
randomness; ``parallel.mp`` shards the wide Dense layers' output channels
(``parallel/mp.py``).  dp = -1 takes every rank not on the mp axis, and dp
shrinks until it divides ``train.batch_size``, with the JAX package's
warnings.  Rank 0 alone logs to ``log.txt``, writes ``metrics.jsonl`` and
writes the checkpoints, which hold full tensors whatever the layout, so any
layout resumes them (``engine/checkpoint.py``).  ``parallel.sp > 1`` is an
eval-only layout and raises, as in the JAX package; dp or mp above 1
without a process group raises and names ``torchrun``.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from dataclasses import asdict

import numpy as np
import torch
import torch.distributed as dist

from hspose_tpu_torch.config import HSPoseConfig, parse_overrides
from hspose_tpu_torch.utils.logging import MetricWriter, setup_logger


TORCHRUN = ("torchrun --standalone --nproc_per_node=<dp*mp> -m hspose_tpu_torch.engine.train "
            "parallel.dp=<dp> parallel.mp=<mp> ...")


def check_trainable(cfg: HSPoseConfig) -> None:
    """Raise on the settings the train loop does not run."""
    from hspose_tpu_torch.data.dataset import check_sample_mode

    p = cfg.parallel
    if max(p.sp, 1) > 1:
        raise ValueError("parallel.sp (point-axis sharding) is eval-only; training uses a "
                         "(dp, mp) mesh")
    if max(p.dp, p.mp) > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"parallel.dp={p.dp}, mp={p.mp}: the train loop trains on several GPUs with one "
            f"process each and found no process group; run it under torchrun: {TORCHRUN}")
    check_sample_mode(cfg.data.sample_mode)


def step_seed(seed: int, global_step: int) -> int:
    """The seed of one step's generator, from (seed, global step)."""
    return int(np.random.SeedSequence([seed, global_step]).generate_state(1, np.uint64)[0] >> 1)


def train(cfg: HSPoseConfig, device=None):
    """Train as the config says; returns (model, step), the model and what
    ``build_train_step`` returned, as the last step left them."""
    check_trainable(cfg)
    from hspose_tpu_torch.data.dataset import (
        PoseTrainDataset,
        decode_path,
        make_worker_pool,
        resolve_num_workers,
    )
    from hspose_tpu_torch.engine.checkpoint import read_meta, restore_checkpoint
    from hspose_tpu_torch.engine.train_step import build_train_step
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.parallel.mesh import resolve_mesh

    rank = dist.get_rank() if dist.is_initialized() else 0
    logger = (setup_logger("train_log", os.path.join(cfg.train.model_save, "log.txt"))
              if rank == 0 else setup_logger("train_log", level=logging.WARNING))
    logger.info("config: %s", asdict(cfg))
    seed = [cfg.train.seed if cfg.train.seed != -1 else int(time.time())]
    if dist.is_initialized():
        dist.broadcast_object_list(seed)  # one seed: rank 0's clock
    seed = seed[0]
    mesh = resolve_mesh(cfg.parallel, cfg.train.batch_size, logger)
    if not mesh.active:
        logger.warning("rank %d lies outside the mesh and trains on nothing", rank)
        return None, None
    logger.info("mesh: dp=%d x mp=%d", mesh.dp, mesh.mp)

    with torch.autograd.set_detect_anomaly(cfg.train.debug_nan):
        if cfg.train.debug_nan:
            logger.info("debug_nan: autograd anomaly detection on, finite checks every step")
        torch.manual_seed(seed)
        model = build_model(cfg.model, device=device, train_heads=True)
        device = next(model.parameters()).device
        generator = torch.Generator(device=device)
        step = build_train_step(cfg, model, generator,
                                mesh if mesh.dp * mesh.mp > 1 else None)

        s_epoch = 0
        if cfg.train.resume and cfg.train.resume_model:
            last_epoch, seed = restore_checkpoint(cfg.train.resume_model, model, step)
            s_epoch = last_epoch + 1
            logger.info("resumed from %s at epoch %d (seed %d)",
                        cfg.train.resume_model, s_epoch, seed)

        sample_mode = cfg.data.sample_mode
        dataset = PoseTrainDataset(cfg.data, mode="train", sample_mode=sample_mode)
        logger.info("%d images found, %d models loaded", len(dataset), len(dataset.models))
        decode = decode_path(cfg.data)
        logger.info("decode: %s, sample mode: %s", decode, sample_mode)
        saved = read_meta(cfg.train.resume_model).get("decode") if s_epoch else None
        if saved and saved != decode:
            # the two paths' crops can differ at half-pixel coordinates
            logger.warning("resuming a run that decoded on the %s path on the %s "
                           "path: its batches need not be an unbroken run's", saved, decode)
        # loader worker processes (the reference's DataLoader workers,
        # engine/train.py:65-69): one persistent pool for the whole run
        # every rank makes the whole batch of (seed, step) and keeps its rows,
        # so the host's cores are shared among its ranks' pools
        num_workers = resolve_num_workers(cfg.data.num_workers, local_ranks=local_ranks())
        logger.info("loader workers: %d", num_workers)
        pool = (make_worker_pool(cfg.data, "train", sample_mode, num_workers)
                if num_workers > 0 else None)
        writer = MetricWriter(cfg.train.model_save) if rank == 0 else None
        try:
            _train_loop(cfg, logger, writer, dataset, pool, model, step, generator, seed,
                        s_epoch, num_workers, mesh)
        finally:
            # terminate the worker pool on error paths too (a debug_nan raise or
            # a checkpoint failure must not leak spawned processes)
            if writer is not None:
                writer.close()
            if pool is not None:
                pool.terminate()
    return model, step


def local_ranks() -> int:
    """The processes of the process group on this host (torchrun's
    ``LOCAL_WORLD_SIZE``; 1 without a group)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if dist.is_initialized() else 1


def _train_loop(cfg, logger, writer, dataset, pool, model, step, generator, seed,
                s_epoch, num_workers, mesh):
    from hspose_tpu_torch.data.dataset import decode_path, resolve_num_workers, train_batches
    from hspose_tpu_torch.engine.checkpoint import save_checkpoint
    from hspose_tpu_torch.engine.train_step import check_finite_metrics, to_device
    from hspose_tpu_torch.parallel.mesh import batch_sharding

    device = next(model.parameters()).device
    bs, steps = cfg.train.batch_size, cfg.train.train_steps
    rows = batch_sharding(mesh, bs)
    profile_dir = os.environ.get("HSPOSE_PROFILE_DIR")
    for epoch in range(s_epoch, cfg.train.total_epoch):
        stats: dict = {}
        batches = iter(train_batches(dataset, bs, steps, seed=seed + epoch * 997,
                                     prefetch=cfg.data.prefetch,
                                     pool=pool, stats=stats))
        t0 = time.perf_counter()
        waited, t_first, prof = 0.0, None, None
        for i in range(steps):
            tw = time.perf_counter()
            batch = next(batches)
            waited += time.perf_counter() - tw
            # on-demand device tracing (SURVEY §5.1): steps 10-14 of the first epoch
            if profile_dir and i == 10 and epoch == s_epoch:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            global_step = epoch * steps + i
            generator.manual_seed(step_seed(seed, global_step))
            metrics = step(to_device({k: v[rows] for k, v in batch.items()}, device))
            if cfg.train.debug_nan:
                check_finite_metrics(metrics)
            if prof is not None and i in (14, steps - 1):
                if device.type == "cuda":
                    torch.cuda.synchronize()
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "train_steps_10_14.json"))
                prof = None
            if i % cfg.train.log_every == 0 and writer is not None:
                writer.write(global_step, metrics)
                logger.info("epoch %d step %d total_loss %.4f", epoch, i, metrics["total_loss"])
            if i == 0:
                t_first = time.perf_counter()

        # the step's floats synchronise with the card, so the clock is the card's pace
        seconds = time.perf_counter() - t0
        rest = time.perf_counter() - t_first
        rate = steps / seconds
        rate_rest = (steps - 1) / rest if steps > 1 else rate
        worker_rate = bs * stats["batches"] / stats["worker_s"]
        loader_rate = worker_rate * max(num_workers, 1)
        logger.info("epoch %d done in %.1fs: %.3f steps/s (%.3f after its first step), "
                    "%.1fs waiting for batches; loader (%s decode, %d workers): %.1f "
                    "samples/s per worker, %.1f in all, against %.1f consumed",
                    epoch, seconds, rate, rate_rest, waited, decode_path(cfg.data),
                    num_workers, worker_rate, loader_rate, rate_rest * bs)
        if writer is not None:
            writer.write(epoch * steps + steps - 1, {
                "epoch": epoch, "epoch_s": seconds, "steps_per_s": rate,
                "steps_per_s_after_first": rate_rest, "data_wait_s": waited,
                "loader_samples_per_s": loader_rate, "worker_samples_per_s": worker_rate,
                "num_workers": num_workers})
        resolve_num_workers(num_workers, rate_rest * bs, logger, worker_rate)
        if (epoch + 1) % cfg.train.save_every == 0 or (epoch + 1) == cfg.train.total_epoch:
            path = save_checkpoint(cfg.train.model_save, model, step, epoch, seed,
                                   decode_path(cfg.data))
            logger.info("checkpoint saved: %s", path)


def main(argv=None):
    """The CLI.  Under ``torchrun`` (``WORLD_SIZE`` set) it first joins the
    process group: ``nccl`` on ``cuda:LOCAL_RANK``, or ``gloo`` on the CPU
    with ``HSPOSE_PLATFORM=cpu``."""
    cfg = parse_overrides(sys.argv[1:] if argv is None else argv)
    device = "cpu" if os.environ.get("HSPOSE_PLATFORM") == "cpu" else None
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        from hspose_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(device)
    try:
        os.makedirs(cfg.train.model_save, exist_ok=True)
        train(cfg, device=device)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
