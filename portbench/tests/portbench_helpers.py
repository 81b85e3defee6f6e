"""Tiny cells for the CPU tests: a cell's configuration and limits at 128
points and a batch of 4, and a runner call on the CPU."""

from __future__ import annotations

import time

from portbench import kinds, manifest

TINY_SERVE = dict(batch=4, crops_per_request=8, records=[3, 5], pool_crops=32, warmup_requests=1,
                  overhead_requests=1, trace_units=2, check_requests=2)
TINY_TRAIN = dict(batch=4, pool_batches=6, trace_units=2)
N = 128


def tiny_cell(name: str):
    cell, _ = manifest.find_cell(manifest.load(), name)
    cell.config = {**cell.config, "data": {**cell.config["data"], "num_points": N}}
    cell.traffic = {**cell.traffic, "num_points": N,
                    **(TINY_SERVE if cell.traffic["kind"] == "serve" else TINY_TRAIN)}
    return cell


def run_cpu(cell, seed: int = 2**31 + 11, seconds: float = 0.5):
    return kinds.load(cell.traffic["kind"]).run(cell, seed, seconds, False, "cpu",
                                                 time.perf_counter())
