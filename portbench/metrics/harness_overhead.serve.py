"""harness_overhead.serve: 1 - the harness's crops/s over the crops/s of
``eval_forward`` + ``generate_RT`` alone on the same batches already on the
card, both on the host clock before the profiler starts, in %."""


def read(r):
    h = r.host
    if r.kind != "serve" or "harness_crops_per_s" not in h:
        return None
    return 100.0 * (1.0 - h["harness_crops_per_s"] / h["forward_crops_per_s"])
